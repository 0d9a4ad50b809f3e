"""Plain f32 SimpleCNN, every client's own model over its own batch.

The reference testbed's MNIST model (Shashank8834/multimodal-fl-security,
``src/models/simple_cnn.py:13-102``): conv 3x3 ``c_in``->32 (SAME) + relu +
2x2 max-pool, conv 3x3 32->64 (SAME) + relu + 2x2 max-pool, dropout 0.25,
fc 3136->128 + relu, dropout 0.5, fc 128->10. Plain ``torch`` operations in
f32 with TF32 off (the caller sets the flags). Each client's parameters are
a row of ``[C, D]``; a convolution is ``unfold`` (im2col) and one batched
matrix product over the clients, a dense layer one batched product, so
every client's arithmetic stays its own.

Departures from the published model, each because the system under test
defines it so:

- the parameters are one flat vector in the configuration's leaf order
  (``leaves``: bias before weight, torch's OIHW and ``[out, in]`` layouts);
- weights start lecun-normal with zero biases (flax's defaults, as the port
  draws them), not PyTorch's default init;
- dropout keeps an entry where a uniform draw is below ``1 - rate`` and
  scales it by ``1 / (1 - rate)``; the draws for every client of a step
  come from the round's generator in one call per dropout layer, dropout
  0.25 first (:func:`draw_masks`).

``precision`` (a layer name -> a mode of ``reference/precision.py``) rounds
the named layers for a control; the reference proper passes none.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch_bench.reference import precision as P


def views(theta: torch.Tensor, config) -> Dict[str, torch.Tensor]:
    """Per-leaf views of ``[C, D]`` rows, shaped ``[C, *leaf]``."""
    out, lo = {}, 0
    c = theta.shape[0]
    for name, shape in config["leaves"]:
        n = math.prod(shape)
        out[name] = theta[:, lo:lo + n].reshape(c, *shape)
        lo += n
    return out


def feature_size(config) -> int:
    h, w = config["image_size"]
    return config["conv_channels"][1] * (h // 4) * (w // 4)


def draw_masks(gen: torch.Generator, clients: int, batch: int, config,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep-masks ``[C, B, 3136]`` and ``[C, B, 128]`` of one step."""
    keep1 = 1.0 - config["dropout_rates"][0]
    keep2 = 1.0 - config["dropout_rates"][1]
    m1 = torch.rand((clients, batch, feature_size(config)), generator=gen,
                    device=device) < keep1
    m2 = torch.rand((clients, batch, config["hidden_dim"]), generator=gen,
                    device=device) < keep2
    return m1, m2


def _conv_block(h, w, b, mode):
    """3x3 SAME conv + bias + relu + 2x2 max-pool of ``h`` ``[C, B, ci, H,
    W]`` by ``w`` ``[C, co, ci, 3, 3]``, ``b`` ``[C, co]``."""
    c, bsz, ci, height, width = h.shape
    co = w.shape[1]
    h, w = P.operand(h, mode), P.operand(w, mode)
    cols = F.unfold(h.reshape(c * bsz, ci, height, width), 3, padding=1)
    cols = cols.view(c, bsz, ci * 9, height * width).transpose(1, 2)
    y = torch.bmm(w.reshape(c, co, ci * 9),
                  cols.reshape(c, ci * 9, bsz * height * width))
    y = y.view(c, co, bsz, height, width).transpose(1, 2)
    y = P.output(y + b[:, None, :, None, None], mode)
    y = F.max_pool2d(F.relu(y).reshape(c * bsz, co, height, width), 2)
    return y.view(c, bsz, co, height // 2, width // 2)


def _dense(x, w, b, mode):
    """``x`` ``[C, B, in]`` by ``w`` ``[C, out, in]`` plus ``b``."""
    y = torch.bmm(P.operand(x, mode), P.operand(w, mode).transpose(1, 2))
    return P.output(y + b[:, None, :], mode)


def logits(theta: torch.Tensor, x: torch.Tensor,
           masks: Tuple[torch.Tensor, torch.Tensor], config,
           precision: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Training-mode logits ``[C, B, K]`` of each client's rows ``[C, D]``
    on its batch ``x`` ``[C, B, c_in, H, W]`` under its keep-masks."""
    p = views(theta, config)
    mode = (precision or {}).get
    keep1 = 1.0 - config["dropout_rates"][0]
    keep2 = 1.0 - config["dropout_rates"][1]
    h = _conv_block(x, p["conv1.weight"], p["conv1.bias"], mode("conv1"))
    h = _conv_block(h, p["conv2.weight"], p["conv2.bias"], mode("conv2"))
    h = h.reshape(h.shape[0], h.shape[1], -1) * masks[0] / keep1
    h = F.relu(_dense(h, p["fc1.weight"], p["fc1.bias"], mode("fc1")))
    h = h * masks[1] / keep2
    return _dense(h, p["fc2.weight"], p["fc2.bias"], mode("fc2"))


def forward_flops_per_sample(config) -> int:
    """Multiply-adds x 2 of one sample's forward pass."""
    h, w = config["image_size"]
    k = config["kernel_size"] ** 2
    c0, (c1, c2) = config["in_channels"], config["conv_channels"]
    conv1 = 2 * k * c0 * c1 * h * w
    conv2 = 2 * k * c1 * c2 * (h // 2) * (w // 2)
    fc1 = 2 * feature_size(config) * config["hidden_dim"]
    fc2 = 2 * config["hidden_dim"] * config["num_classes"]
    return conv1 + conv2 + fc1 + fc2
