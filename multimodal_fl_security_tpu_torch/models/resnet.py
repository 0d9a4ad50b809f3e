"""ResNet-50 with GroupNorm over a client-stacked flat parameter buffer.

Counterpart of ``multimodal_fl_security_tpu/models/resnet.py:95-142`` with
its default ``norm="group"``: the reference testbed's CUB-200 model
(``src/models/cub200_cnn.py:23-54``, torchvision's ResNet-50 under a
Dropout(0.3) + Linear(2048 -> num_classes) head) with GroupNorm(32) in
every normalisation slot, as the JAX package has it:

- stem: conv 7x7/2 (padding 3, no bias) -> GroupNorm -> relu -> max-pool
  3x3/2 (padding 1 of -inf);
- ``stage_sizes`` bottleneck blocks a stage, ``width * 2**stage`` features
  (the stride on the 3x3 conv, v1.5): conv 1x1 -> GN -> relu -> conv 3x3/s
  (padding 1) -> GN -> relu -> conv 1x1 (4x features) -> GN; the first block
  of a stage projects its input (conv 1x1/s -> GN); then relu(residual + y);
- head: the spatial mean, dropout, a dense layer in f32.

GroupNorm takes 32 groups and flax's epsilon of 1e-6; no conv has a bias.

Like the flax module, this module holds no parameters of its own. It is
applied to a flat f32 buffer laid out by :meth:`ResNet.layout`, either
``[D]`` (one model) or ``[C, D]`` (one model per client). The layout is
torchvision's ``state_dict`` order and names, GroupNorm's affine in the
BatchNorm slots (``bn1.weight``, ``downsample.1.bias``, ...), so the JAX
package's leaf order is a permutation of it (``models/from_jax.py``).

The client axis is a batch dimension written out, as in ``simple_cnn.py``:
every convolution is one grouped convolution (``groups=C``) over
``[B, C*ch, H, W]`` and every GroupNorm one ``F.group_norm`` over ``C*32``
groups (a client's channels split into whole groups, so its statistics are
its own). At 20 clients x 16 images of 224 x 224 on an H100 this takes
0.80 s a step on the card against 0.67 s for a loop over the clients, but
the loop's ~3,400 launches a step leave the host pacing the card: its
rounds moved by up to 10% with the host, the grouped form's by 0.2%
(PERF.md, PR 16). The buffer is cut into leaves by one ``split``, so the
backward gathers their gradients with one concatenation.

While a profiler session records, the stages are spans of
``utils/tracing.py``: ``stem``, ``stage1`` .. ``stage4`` and ``head`` in the
forward, and ``head.bwd`` .. ``stem.bwd`` in the backward, whose edges are
gradient hooks on the tensors between the stages (registered only then).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fl_security_tpu_torch.core.pytrees import FlatLayout
from multimodal_fl_security_tpu_torch.models.registry import MODELS
from multimodal_fl_security_tpu_torch.models.simple_cnn import lecun_normal_
from multimodal_fl_security_tpu_torch.utils import tracing

#: GroupNorm's groups and epsilon (flax's ``nn.GroupNorm`` default eps)
GROUPS = 32
EPS = 1e-6
#: the stages' spans, in forward order
STAGES = ("stem", "stage1", "stage2", "stage3", "stage4", "head")
#: a block's layer -> its flax module inside ``ResNetBlock_k`` (the JAX
#: block builds its projection after the main path, ``resnet.py:80-84``)
JAX_BLOCK = {
    "conv1": "Conv_0", "bn1": "GroupNorm_0",
    "conv2": "Conv_1", "bn2": "GroupNorm_1",
    "conv3": "Conv_2", "bn3": "GroupNorm_2",
    "downsample.0": "Conv_3", "downsample.1": "GroupNorm_3",
}
_BLOCK_LEAF = re.compile(r"layer(\d)\.(\d+)\.(.+)\.(weight|bias)")


def blocks(stage_sizes: Sequence[int], width: int):
    """``(stage, prefix, in_features, features, stride)`` of every
    bottleneck block in order; the first block of each stage projects its
    input."""
    cin = width
    for s, n in enumerate(stage_sizes):
        feat = width * 2 ** s
        for b in range(n):
            yield (s, f"layer{s + 1}.{b}.", cin, feat,
                   2 if s > 0 and b == 0 else 1)
            cin = 4 * feat


def _conv(h: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
          clients: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Per-client conv of ``h`` ``[B, C*ci, H, W]`` by the ``[C, co, ci, k,
    k]`` leaf ``name.weight``, no bias."""
    w = p[name + ".weight"]
    return F.conv2d(h, w.reshape(-1, *w.shape[2:]), stride=stride,
                    padding=padding, groups=clients)


def _norm(h: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
          clients: int) -> torch.Tensor:
    """Per-client GroupNorm of ``h`` ``[B, C*ch, H, W]``: a client's
    channels split into whole groups."""
    return F.group_norm(h, clients * GROUPS, p[name + ".weight"].reshape(-1),
                        p[name + ".bias"].reshape(-1), EPS)


def _block(h: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
           stride: int, clients: int) -> torch.Tensor:
    y = F.relu(_norm(_conv(h, p, prefix + "conv1", clients), p,
                     prefix + "bn1", clients), inplace=True)
    y = F.relu(_norm(_conv(y, p, prefix + "conv2", clients, stride, 1), p,
                     prefix + "bn2", clients), inplace=True)
    y = _norm(_conv(y, p, prefix + "conv3", clients), p, prefix + "bn3",
              clients)
    if prefix + "downsample.0.weight" in p:
        h = _norm(_conv(h, p, prefix + "downsample.0", clients, stride), p,
                  prefix + "downsample.1", clients)
    return F.relu(h + y, inplace=True)


class ResNet(nn.Module):
    """Bottleneck ResNet with GroupNorm; ``stage_sizes`` (3, 4, 6, 3) and
    ``width`` 64 are ResNet-50 (D = 23,917,832 at 200 classes)."""

    def __init__(self, num_classes: int = 200, hidden_dim: int = 2048,
                 image_size: Tuple[int, int] = (224, 224),
                 dtype: torch.dtype = torch.float32,
                 dropout_rates: Tuple[float, ...] = (0.3,),
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.width = int(width)
        if len(self.stage_sizes) != 4 or min(self.stage_sizes) < 1:
            raise ValueError(f"ResNet takes four stages of at least one "
                             f"block, got {self.stage_sizes}")
        if self.width % GROUPS:
            raise ValueError(f"width {width} does not split into "
                             f"{GROUPS} groups")
        if int(hidden_dim) != 32 * self.width:
            raise ValueError(f"hidden_dim {hidden_dim} is not the pooled "
                             f"width 32 x {self.width}")
        if len(dropout_rates) != 1:
            raise ValueError(f"ResNet's head has one dropout rate, got "
                             f"{tuple(dropout_rates)}")
        if dtype != torch.float32:
            raise ValueError(f"ResNet computes in float32 only, not {dtype}")
        self.num_classes = int(num_classes)
        self.hidden_dim = int(hidden_dim)
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.dtype = dtype
        self.dropout_rates = (float(dropout_rates[0]),)
        #: each stage's blocks, ``(prefix, stride)``
        self._stages: List[List[Tuple[str, int]]] = [
            [] for _ in self.stage_sizes]
        for s, prefix, _, _, stride in blocks(self.stage_sizes, self.width):
            self._stages[s].append((prefix, stride))
        self._layouts: Dict[int, FlatLayout] = {}

    def layout(self, in_channels: int) -> FlatLayout:
        """Flat layout of the parameters for ``in_channels`` input channels,
        in torchvision's ``state_dict`` order and names."""
        if in_channels not in self._layouts:
            w = self.width
            entries = [("conv1.weight", (w, in_channels, 7, 7)),
                       ("bn1.weight", (w,)), ("bn1.bias", (w,))]
            for _, prefix, cin, feat, _ in blocks(self.stage_sizes, w):
                for conv, (co, ci, k), norm in (
                        ("conv1", (feat, cin, 1), "bn1"),
                        ("conv2", (feat, feat, 3), "bn2"),
                        ("conv3", (4 * feat, feat, 1), "bn3"),
                        ("downsample.0", (4 * feat, cin, 1), "downsample.1")):
                    if conv == "downsample.0" and not prefix.endswith(".0."):
                        continue
                    entries += [(f"{prefix}{conv}.weight", (co, ci, k, k)),
                                (f"{prefix}{norm}.weight", (co,)),
                                (f"{prefix}{norm}.bias", (co,))]
            entries += [("fc.weight", (self.num_classes, self.hidden_dim)),
                        ("fc.bias", (self.num_classes,))]
            self._layouts[in_channels] = FlatLayout(entries)
        return self._layouts[in_channels]

    def jax_path(self, name: str) -> Tuple[str, ...]:
        """The flax parameter path of the leaf ``name``: flax numbers the
        blocks ``ResNetBlock_k`` across the stages."""
        if name.startswith("fc."):
            return ("Dense_0", "bias" if name.endswith("bias") else "kernel")
        if name.startswith(("conv1.", "bn1.")):
            module = ()
            flax = "Conv_0" if name.startswith("conv1.") else "GroupNorm_0"
        else:
            stage, block, layer, _ = _BLOCK_LEAF.fullmatch(name).groups()
            k = sum(self.stage_sizes[:int(stage) - 1]) + int(block)
            module, flax = (f"ResNetBlock_{k}",), JAX_BLOCK[layer]
        leaf = ("bias" if name.endswith("bias")
                else "kernel" if flax.startswith("Conv") else "scale")
        return (*module, flax, leaf)

    def forward(self, params: torch.Tensor, x: torch.Tensor,
                dropout=None) -> torch.Tensor:
        """Logits (f32) of every client's model on its own batch.

        ``params`` ``[C, D]`` with ``x`` ``[C, B, C_in, H, W]`` gives
        ``[C, B, num_classes]``; ``params`` ``[D]`` with ``x``
        ``[B, C_in, H, W]`` gives ``[B, num_classes]``. ``dropout`` is None
        (no dropout) or a step's masks (``ops/client_dropout.py::
        RoundDraws``), called as ``dropout(h, 0)`` on the head's pooled
        ``[C, B, hidden_dim]``.
        """
        single = params.dim() == 1
        if single:
            params, x = params.unsqueeze(0), x.unsqueeze(0)
        clients, batch, cin, height, width = x.shape
        if (height, width) != self.image_size:
            raise ValueError(f"model built for {self.image_size} images, "
                             f"got {(height, width)}")
        layout = self.layout(cin)
        p = {name: piece.view(clients, *shape) for (name, shape), piece in
             zip(layout.entries, params.split(
                 [hi - lo for lo, hi in layout.offsets.values()], dim=-1))}
        device = x.device
        span = tracing.span
        h = x.transpose(0, 1).reshape(batch, clients * cin, height, width)
        stem_w = p["conv1.weight"].reshape(-1, cin, 7, 7)
        with span("stem", device):
            h = F.conv2d(h, stem_w, stride=2, padding=3, groups=clients)
            h = F.relu(_norm(h, p, "bn1", clients), inplace=True)
            h = F.max_pool2d(h, 3, stride=2, padding=1)
        marks = [(h, "stem.bwd"), (stem_w, None)]
        for s, stage in enumerate(self._stages):
            with span(f"stage{s + 1}", device):
                for prefix, stride in stage:
                    h = _block(h, p, prefix, stride, clients)
            marks.insert(0, (h, f"stage{s + 1}.bwd"))
        with span("head", device):
            h = h.mean(dim=(2, 3)).view(batch, clients, -1).transpose(0, 1)
            if dropout is not None:
                h = dropout(h, 0)
            logits = torch.baddbmm(p["fc.bias"].unsqueeze(1), h,
                                   p["fc.weight"].transpose(1, 2))
        if tracing.enabled() and logits.requires_grad:
            tracing.backward_spans([(logits, "head.bwd")] + marks, device)
        return logits[0] if single else logits

    def init_params(self, in_channels: int,
                    generator: torch.Generator) -> torch.Tensor:
        """A fresh ``[D]`` f32 buffer (on the generator's device), flax's
        defaults: lecun-normal conv and dense kernels, GroupNorm scales 1,
        zero biases."""
        layout = self.layout(in_channels)
        flat = torch.zeros(layout.dim, dtype=torch.float32,
                           device=generator.device)
        for name, view in layout.views(flat).items():
            if view.dim() > 1:
                lecun_normal_(view, view[0].numel(), generator)
            elif name.endswith(".weight"):
                view.fill_(1.0)
        return flat


@MODELS.register("resnet50", "cub200_cnn")
def _make_resnet50(num_classes: int = 200, **kwargs) -> ResNet:
    return ResNet(num_classes=num_classes, **kwargs)

