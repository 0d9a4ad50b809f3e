"""Plain f32 ResNet-50 with GroupNorm, every client's own model over its own
batch.

The reference testbed's CUB-200 model (Shashank8834/multimodal-fl-security,
``src/models/cub200_cnn.py:23-54``): torchvision's ResNet-50 (He et al.,
arXiv:1512.03385; bottleneck v1.5, the stride on the 3x3 conv) under a
Dropout(0.3) + Linear(2048 -> num_classes) head. The stem is conv 7x7/2
(padding 3) -> norm -> relu -> max-pool 3x3/2 (padding 1); each bottleneck
is conv 1x1 -> norm -> relu -> conv 3x3/s (padding 1) -> norm -> relu ->
conv 1x1 (4x) -> norm, with a projection (conv 1x1/s -> norm) where the
shapes differ, then relu(residual + y); the head is the spatial mean,
dropout and the dense layer. No conv has a bias.

Plain ``torch`` in f32 with TF32 off (the caller sets the flags): each
convolution is ``unfold`` (im2col) and a matrix product, each GroupNorm its
mean and variance over (the group's channels, H, W) written out, the
max-pool ``F.max_pool2d`` (the first maximum of a window on a tie); every
client's arithmetic is its own (products batched over clients and images).
The forward of each few clients (``CLIENTS_AT_ONCE``) runs under
``torch.utils.checkpoint``, so a backward holds their activations alone.

Departures from the published model, each because the system under test
defines it so:

- GroupNorm (Wu & He, arXiv:1803.08494) with ``config["groups"]`` groups and
  epsilon ``config["eps"]`` in every BatchNorm slot (the JAX package's
  default ``norm="group"``): a pure function of the parameters, which
  federated averaging needs;
- the parameters are one flat vector in the configuration's leaf order
  (``leaves``: torchvision's ``state_dict`` names and order, GroupNorm's
  scale and bias in the BatchNorm slots), seeded random in place of
  ImageNet's weights; the benchmark's generator draws every leaf whose name
  does not end in ``.bias`` lecun-normal, the GroupNorm scales included;
- dropout keeps an entry where a uniform draw is below ``1 - rate`` and
  scales it by ``1 / (1 - rate)``; the draws for every client of a step
  come from the round's generator in one call (:func:`draw_masks`).

``precision`` (a layer name -> a mode of ``reference/precision.py``) rounds
the named layers (each conv by its leaf name without ``.weight``, and
``fc``) for a control; the reference proper passes none.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch_bench.reference import precision as P

#: clients whose forward one checkpoint holds: ~4.5 GB of a backward's
#: activations a client at 16 images of 224 x 224
CLIENTS_AT_ONCE = 4


def views(theta: torch.Tensor, config) -> Dict[str, torch.Tensor]:
    """Per-leaf views of ``[C, D]`` rows, shaped ``[C, *leaf]``; cut by one
    ``split``, whose backward is one concatenation."""
    sizes = [math.prod(shape) for _, shape in config["leaves"]]
    return {name: piece.reshape(theta.shape[0], *shape)
            for (name, shape), piece in zip(config["leaves"],
                                            theta.split(sizes, dim=1))}


def blocks(config):
    """``(prefix, in_features, features, stride)`` of every bottleneck."""
    cin, width = config["width"], config["width"]
    for s, n in enumerate(config["stage_sizes"]):
        feat = width * 2 ** s
        for b in range(n):
            yield (f"layer{s + 1}.{b}.", cin, feat,
                   2 if s > 0 and b == 0 else 1)
            cin = 4 * feat


def draw_masks(gen: torch.Generator, clients: int, batch: int, config,
               device) -> Tuple[torch.Tensor]:
    """The head's keep-mask ``[C, B, hidden_dim]`` of one step."""
    keep = 1.0 - config["dropout_rates"][0]
    return (torch.rand((clients, batch, config["hidden_dim"]), generator=gen,
                       device=device) < keep,)


def _conv(h, w, stride, padding, mode):
    """``h`` ``[c, B, ci, H, W]`` by each client's ``w`` ``[c, co, ci, k, k]``:
    im2col (a 1x1 conv's columns are its input's pixels) and one matrix
    product a client and image."""
    c, bsz, ci, height, width = h.shape
    co, k = w.shape[1], w.shape[-1]
    ho = (height + 2 * padding - k) // stride + 1
    wo = (width + 2 * padding - k) // stride + 1
    h, w = P.operand(h, mode), P.operand(w, mode)
    if k == 1:
        cols = h[..., ::stride, ::stride].reshape(c, bsz, ci, ho * wo)
    else:
        cols = F.unfold(h.reshape(c * bsz, ci, height, width), k,
                        padding=padding, stride=stride)
        cols = cols.view(c, bsz, ci * k * k, ho * wo)
    y = torch.matmul(w.reshape(c, 1, co, -1), cols)
    return P.output(y.view(c, bsz, co, ho, wo), mode)


def _group_norm(h, scale, bias, groups, eps):
    """``h`` ``[c, B, ch, H, W]``: each (client, image, group)'s mean and
    variance over its channels and pixels, then each client's scale and
    bias ``[c, ch]``."""
    c, bsz, ch, height, width = h.shape
    g = h.reshape(c, bsz, groups, -1)
    var, mean = torch.var_mean(g, dim=-1, unbiased=False, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).view(h.shape)
    return y * scale[:, None, :, None, None] + bias[:, None, :, None, None]


def _clients(rows: torch.Tensor, x: torch.Tensor, keep_mask: torch.Tensor,
             config, precision: Dict[str, str]) -> torch.Tensor:
    """Training-mode logits ``[c, B, K]`` of a few clients: their rows
    ``[c, D]`` on their batches ``x`` ``[c, B, c_in, H, W]``."""
    p = views(rows, config)
    mode = precision.get
    groups, eps = config["groups"], config["eps"]

    def conv(h, layer, stride=1, padding=0):
        return _conv(h, p[layer + ".weight"], stride, padding, mode(layer))

    def norm(h, layer):
        return _group_norm(h, p[layer + ".weight"], p[layer + ".bias"],
                           groups, eps)

    def pool(h):
        c, bsz = h.shape[:2]
        y = F.max_pool2d(h.flatten(0, 1), 3, stride=2, padding=1)
        return y.view(c, bsz, *y.shape[1:])

    h = pool(F.relu(norm(conv(x, "conv1", 2, 3), "bn1")))
    for prefix, _, _, stride in blocks(config):
        y = F.relu(norm(conv(h, prefix + "conv1"), prefix + "bn1"))
        y = F.relu(norm(conv(y, prefix + "conv2", stride, 1), prefix + "bn2"))
        y = norm(conv(y, prefix + "conv3"), prefix + "bn3")
        if prefix + "downsample.0.weight" in p:
            h = norm(conv(h, prefix + "downsample.0", stride),
                     prefix + "downsample.1")
        h = F.relu(h + y)
    h = h.mean(dim=(3, 4)) * keep_mask / (1.0 - config["dropout_rates"][0])
    fc = mode("fc")
    y = torch.matmul(P.operand(h, fc),
                     P.operand(p["fc.weight"], fc).transpose(1, 2))
    return P.output(y + p["fc.bias"][:, None, :], fc)


def logits(theta: torch.Tensor, x: torch.Tensor,
           masks: Tuple[torch.Tensor], config,
           precision: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Training-mode logits ``[C, B, K]`` of each client's rows ``[C, D]``
    on its batch ``x`` ``[C, B, c_in, H, W]`` under its keep-mask."""
    precision = precision or {}
    n = CLIENTS_AT_ONCE
    return torch.cat([
        checkpoint(_clients, rows, x[lo:lo + n], masks[0][lo:lo + n], config,
                   precision, use_reentrant=False)
        for lo, rows in zip(range(0, theta.shape[0], n),
                            theta.split(n, dim=0))])


def forward_flops_per_sample(config) -> int:
    """Multiply-adds x 2 of one sample's forward pass: the convolutions and
    the dense layer."""
    def out(size, k, stride, padding):
        return (size + 2 * padding - k) // stride + 1

    h, w = config["image_size"]
    width, cin = config["width"], config["in_channels"]
    h, w = out(h, 7, 2, 3), out(w, 7, 2, 3)
    flops = 2 * 49 * cin * width * h * w
    h, w = out(h, 3, 2, 1), out(w, 3, 2, 1)
    for prefix, ci, feat, stride in blocks(config):
        ho, wo = out(h, 3, stride, 1), out(w, 3, stride, 1)
        flops += 2 * ci * feat * h * w              # conv1, 1x1
        flops += 2 * 9 * feat * feat * ho * wo      # conv2, 3x3/s
        flops += 2 * feat * 4 * feat * ho * wo      # conv3, 1x1
        if prefix.endswith(".0."):
            flops += 2 * ci * 4 * feat * ho * wo    # projection, 1x1/s
        h, w = ho, wo
    return flops + 2 * config["hidden_dim"] * config["num_classes"]
