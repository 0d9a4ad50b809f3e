"""SimpleCNN over a client-stacked flat parameter buffer.

Counterpart of ``multimodal_fl_security_tpu/models/simple_cnn.py:73-109``:
conv(C_in->32, 3x3, SAME) + relu + maxpool2 -> conv(32->64, 3x3, SAME) +
relu + maxpool2 -> dropout(0.25) -> dense(128) -> relu -> dropout(0.5) ->
dense(num_classes). The JAX package's ``ConvPoolFused`` stem is an exact
re-tiling of the first conv block for the TPU's matrix unit and is not
ported: the stem here is the plain conv block it re-tiles.

Like the flax module, this module holds no parameters of its own. It is
applied to a flat f32 buffer laid out by :meth:`SimpleCNN.layout`, either
``[D]`` (one model) or ``[C, D]`` (one model per client). The client axis
is a batch dimension written out: both convolutions run as one grouped
convolution (``groups=C``) and both dense layers as ``torch.baddbmm``, so
one forward and one backward serve every client, and each client's
gradient lands in its own row of the buffer's gradient.

Compute runs in ``dtype`` (bf16 on the bench path) and the last dense
layer in f32, as ``simple_cnn.py:105-108`` does; parameters stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fl_security_tpu_torch.core.pytrees import FlatLayout
from multimodal_fl_security_tpu_torch.models.registry import MODELS

#: a segment prefix -> its flax module (the default fused stem)
JAX_MODULES = {
    "conv1": "ConvPoolFused_0",
    "conv2": "Conv_0",
    "fc1": "Dense_0",
    "fc2": "Dense_1",
}


def _conv_relu_pool(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    clients: int, dtype: torch.dtype) -> torch.Tensor:
    """Per-client 3x3 SAME conv + bias + relu + 2x2 max-pool.

    ``h`` is ``[B, C*C_in, H, W]`` (client-major channels); ``w`` is the
    ``[C, C_out, C_in, 3, 3]`` view and ``b`` the ``[C, C_out]`` view.
    """
    c_out = w.shape[1]
    y = F.conv2d(h, w.reshape(clients * c_out, *w.shape[2:]).to(dtype),
                 b.reshape(clients * c_out).to(dtype), padding=1,
                 groups=clients)
    return F.max_pool2d(F.relu(y), 2)


class SimpleCNN(nn.Module):
    """Two conv blocks + two dense layers for ``image_size`` inputs."""

    def __init__(self, num_classes: int = 10, hidden_dim: int = 128,
                 image_size: Tuple[int, int] = (28, 28),
                 dtype: torch.dtype = torch.float32,
                 dropout_rates: Tuple[float, float] = (0.25, 0.5)):
        super().__init__()
        self.num_classes = int(num_classes)
        self.hidden_dim = int(hidden_dim)
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.dtype = dtype
        self.dropout_rates = (float(dropout_rates[0]), float(dropout_rates[1]))
        h, w = self.image_size
        #: feature-map size after the two 2x2 pools (floor, like VALID pooling)
        self.feature_hw = (h // 2 // 2, w // 2 // 2)
        self._layouts: Dict[int, FlatLayout] = {}

    def layout(self, in_channels: int) -> FlatLayout:
        """Flat layout of the parameters for ``in_channels`` input channels.

        Segments follow the JAX package's leaf order (``ConvPoolFused_0``,
        ``Conv_0``, ``Dense_0``, ``Dense_1``; bias before kernel).
        """
        if in_channels not in self._layouts:
            fh, fw = self.feature_hw
            self._layouts[in_channels] = FlatLayout([
                ("conv1.bias", (32,)),
                ("conv1.weight", (32, in_channels, 3, 3)),
                ("conv2.bias", (64,)),
                ("conv2.weight", (64, 32, 3, 3)),
                ("fc1.bias", (self.hidden_dim,)),
                ("fc1.weight", (self.hidden_dim, 64 * fh * fw)),
                ("fc2.bias", (self.num_classes,)),
                ("fc2.weight", (self.num_classes, self.hidden_dim)),
            ])
        return self._layouts[in_channels]

    def jax_path(self, name: str) -> Tuple[str, ...]:
        """The flax parameter path of the segment ``name``."""
        prefix, leaf = name.split(".")
        return (JAX_MODULES[prefix], "bias" if leaf == "bias" else "kernel")

    def forward(self, params: torch.Tensor, x: torch.Tensor,
                dropout=None) -> torch.Tensor:
        """Logits (f32) of every client's model on its own batch.

        ``params`` ``[C, D]`` with ``x`` ``[C, B, C_in, H, W]`` gives
        ``[C, B, num_classes]``; ``params`` ``[D]`` with ``x``
        ``[B, C_in, H, W]`` gives ``[B, num_classes]``. ``dropout`` is None
        (no dropout) or a step's masks, called as ``dropout(h, layer)`` on
        fc1's input ``[C, B, 64*h*w]`` (layer 0) and on its relu output
        ``[C, B, hidden]`` (layer 1): ``ops/client_dropout.py::RoundDraws``
        in training, or the masks that ``ops/fused_train.py::
        mirror_local_train`` is given.
        """
        single = params.dim() == 1
        if single:
            params, x = params.unsqueeze(0), x.unsqueeze(0)
        clients, batch, cin, height, width = x.shape
        if (height, width) != self.image_size:
            raise ValueError(f"model built for {self.image_size} images, "
                             f"got {(height, width)}")
        p = self.layout(cin).views(params)
        dt = self.dtype
        h = x.transpose(0, 1).reshape(batch, clients * cin, height, width)
        h = _conv_relu_pool(h.to(dt), p["conv1.weight"], p["conv1.bias"],
                            clients, dt)
        h = _conv_relu_pool(h, p["conv2.weight"], p["conv2.bias"],
                            clients, dt)
        # [B, C*64, h, w] -> [C, B, 64*h*w]: per-client (c, h, w) flatten
        h = h.reshape(batch, clients, -1).transpose(0, 1)
        if dropout is not None:
            h = dropout(h, 0)
        h = F.relu(torch.baddbmm(p["fc1.bias"].to(dt).unsqueeze(1), h,
                                 p["fc1.weight"].to(dt).transpose(1, 2)))
        if dropout is not None:
            h = dropout(h, 1)
        logits = torch.baddbmm(p["fc2.bias"].unsqueeze(1), h.float(),
                               p["fc2.weight"].transpose(1, 2))
        return logits[0] if single else logits

    def init_params(self, in_channels: int,
                    generator: torch.Generator) -> torch.Tensor:
        """A fresh ``[D]`` f32 buffer (on the generator's device):
        lecun-normal kernels and zero biases, flax's defaults."""
        layout = self.layout(in_channels)
        flat = torch.zeros(layout.dim, dtype=torch.float32,
                           device=generator.device)
        for name, view in layout.views(flat).items():
            if name.endswith(".weight"):
                lecun_normal_(view, view[0].numel(), generator)
        return flat


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at 2 sigma, scaled so that
    the variance after truncation is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@MODELS.register("simple_cnn", "mnist_cnn")
def _make_simple_cnn(num_classes: int = 10, **kwargs) -> SimpleCNN:
    return SimpleCNN(num_classes=num_classes, **kwargs)
