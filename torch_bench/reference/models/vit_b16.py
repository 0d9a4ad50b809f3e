"""Plain f32 ViT-B/16, every client's own model over its own batch.

The Vision Transformer of Dosovitskiy et al., arXiv:2010.11929 (Table 1,
ViT-Base with 16 x 16 patches) under the reference testbed's CUB-200 head
(Shashank8834/multimodal-fl-security, ``src/models/cub200_cnn.py:23-54``:
Dropout(0.3) + Linear(width -> num_classes)). Every width comes from the
configuration: ``patch_size``, ``hidden_dim``, ``depth``, ``num_heads``,
``mlp_dim``, ``eps``.

- the image cut into patches (``unfold`` with the stride of the kernel,
  each patch in (channel, row, column) order), each embedded by one matrix
  product; the class token put first and the position embeddings added;
- ``depth`` pre-LN blocks: x + proj(attention(LN1(x))), then
  x + fc2(GELU(fc1(LN2(x)))); the attention of each head the softmax of
  q kᵀ / sqrt(head size) times v, q, k and v the three thirds of qkv's
  output, each cut into the heads in order (timm's layout);
- the head: LayerNorm of the class token, dropout, the dense layer.

Plain ``torch`` in f32 with TF32 off (the caller sets the flags), written
out: LayerNorm as its mean and variance over the width, the softmax as the
exponential over its sum (the row's maximum taken out first), GELU as
0.5 x (1 + erf(x / sqrt 2)), the attention as its two products per head;
every client's arithmetic is its own (products batched over clients,
images and heads). The forward of each few clients (``CLIENTS_AT_ONCE``)
runs under ``torch.utils.checkpoint``, so a backward holds their
activations alone.

Departures from the published model, each because the system under test
defines it so:

- no dropout inside the body and no stochastic depth; the head's dropout
  keeps an entry where a uniform draw is below ``1 - rate`` and scales it
  by ``1 / (1 - rate)``, the draws for every client of a step from the
  round's generator in one call (:func:`draw_masks`);
- the parameters are one flat vector in the configuration's leaf order
  (``leaves``: timm's ``vit_base_patch16_224`` ``state_dict`` names, shapes
  and order), seeded random in place of ImageNet-21k's weights; the
  benchmark's generator draws every leaf whose name does not end in
  ``.bias`` lecun-normal, the LayerNorm scales, class token and position
  embeddings included.

``precision`` (a layer name -> a mode of ``reference/precision.py``) rounds
the named products for a control: ``patch_embed.proj``, and in every block
``attn.qkv``, ``attn.qk`` (q kᵀ), ``attn.pv`` (the probabilities times v),
``attn.proj``, ``mlp.fc1``, ``mlp.fc2``; then ``head``. The reference
proper passes none.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch_bench.reference import precision as P
# the flat vector's leaves and the head's keep-mask, as ResNet-50's
from torch_bench.reference.models.resnet50 import (  # noqa: F401
    draw_masks,
    views,
)

#: clients whose forward one checkpoint holds: ~6.5 GB of a backward's
#: activations a client at 16 images of 224 x 224
CLIENTS_AT_ONCE = 2


def _product(a, b, mode):
    """``a @ b`` batched over the leading axes, its operands (and the
    gradient flowing back into it) rounded as ``mode`` says."""
    return P.output(torch.matmul(P.operand(a, mode), P.operand(b, mode)),
                    mode)


def _linear(h, p, name, mode):
    """Each client's dense layer ``name`` on its rows ``h`` ``[c, n, in]``."""
    y = _product(h, p[name + ".weight"].transpose(1, 2), mode)
    return y + p[name + ".bias"][:, None, :]


def _layer_norm(h, scale, bias, eps):
    """``h`` ``[c, ..., d]``: each token's mean and variance over its width,
    then each client's scale and bias ``[c, d]``."""
    var, mean = torch.var_mean(h, dim=-1, unbiased=False, keepdim=True)
    y = (h - mean) * torch.rsqrt(var + eps)
    shape = (h.shape[0],) + (1,) * (h.dim() - 2) + (h.shape[-1],)
    return y * scale.view(shape) + bias.view(shape)


def _clients(rows: torch.Tensor, x: torch.Tensor, keep_mask: torch.Tensor,
             config, precision: Dict[str, str]) -> torch.Tensor:
    """Training-mode logits ``[c, B, K]`` of a few clients: their rows
    ``[c, D]`` on their batches ``x`` ``[c, B, c_in, H, W]``."""
    p = views(rows, config)
    mode = precision.get
    c, bsz, cin, height, width = x.shape
    k, d, heads = config["patch_size"], config["hidden_dim"], \
        config["num_heads"]
    eps = config["eps"]

    def norm(h, name):
        return _layer_norm(h, p[name + ".weight"], p[name + ".bias"], eps)

    cols = F.unfold(x.reshape(c * bsz, cin, height, width), k, stride=k)
    n = cols.shape[-1]
    cols = cols.transpose(1, 2).reshape(c, bsz * n, cin * k * k)
    weight = p["patch_embed.proj.weight"].reshape(c, d, cin * k * k)
    h = _product(cols, weight.transpose(1, 2), mode("patch_embed.proj"))
    h = (h + p["patch_embed.proj.bias"][:, None, :]).view(c, bsz, n, d)
    h = torch.cat([p["cls_token"].expand(c, bsz, 1, d), h], dim=2)
    h = h + p["pos_embed"]
    t = n + 1
    for i in range(config["depth"]):
        b = f"blocks.{i}."
        y = norm(h, b + "norm1").view(c, bsz * t, d)
        qkv = _linear(y, p, b + "attn.qkv", mode("attn.qkv"))
        q, kk, v = qkv.view(c, bsz, t, 3, heads, d // heads).permute(
            3, 0, 1, 4, 2, 5)
        s = _product(q, kk.transpose(-1, -2), mode("attn.qk")) \
            / math.sqrt(d // heads)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        a = e / e.sum(dim=-1, keepdim=True)
        o = _product(a, v, mode("attn.pv"))          # [c, B, heads, t, dh]
        o = o.transpose(2, 3).reshape(c, bsz * t, d)
        h = h + _linear(o, p, b + "attn.proj",
                        mode("attn.proj")).view(c, bsz, t, d)
        y = norm(h, b + "norm2").view(c, bsz * t, d)
        z = _linear(y, p, b + "mlp.fc1", mode("mlp.fc1"))
        z = 0.5 * z * (1.0 + torch.erf(z / math.sqrt(2.0)))
        h = h + _linear(z, p, b + "mlp.fc2",
                        mode("mlp.fc2")).view(c, bsz, t, d)
    z = norm(h, "norm")[:, :, 0]
    z = z * keep_mask / (1.0 - config["dropout_rates"][0])
    return _linear(z, p, "head", mode("head"))


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
    """Multiply-adds x 2 of one sample's forward pass: the patch embedding,
    each block's four dense layers and two attention products, the head."""
    h, w = config["image_size"]
    k, d, m = config["patch_size"], config["hidden_dim"], config["mlp_dim"]
    n = (h // k) * (w // k)
    t = n + 1
    block = 2 * t * d * (3 * d + d + 2 * m) + 2 * 2 * t * t * d
    return (2 * n * config["in_channels"] * k * k * d
            + config["depth"] * block + 2 * d * config["num_classes"])
