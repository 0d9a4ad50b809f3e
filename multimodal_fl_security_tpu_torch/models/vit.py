"""Vision Transformer (ViT-B/16) over a client-stacked flat parameter buffer.

Dosovitskiy et al., arXiv:2010.11929 (Table 1, ViT-Base): ``depth``
pre-LN encoder blocks of width ``hidden_dim``, each multi-head attention
(``num_heads`` heads) and an MLP of width ``mlp_dim`` with exact (erf)
GELU; the image cut into ``patch_size`` squares, embedded by one linear map,
a learned class token put first and learned position embeddings added:

    x = [cls ; patches(x) W_e + b_e] + pos      # a patch in (c, kh, kw) order
    x = x + proj(attn(LN1(x)))                  # for each block
    x = x + fc2(GELU(fc1(LN2(x))))
    logits = head(dropout(LN(x)[cls]))

with ``attn`` the softmax of q kᵀ / sqrt(head size) over v, head by head;
the qkv weight holds q | k | v, each as ``num_heads`` heads in order (timm's
layout). LayerNorm takes epsilon ``eps`` (1e-6). Under the reference
testbed's CUB head (``src/models/cub200_cnn.py:23-54``) the classifier is
Dropout(0.3) + Linear(hidden_dim -> num_classes) on the class token.

Departures from the published pre-training recipe: no dropout inside the
body and no stochastic depth (the testbed's only dropout is its head's).

Like ``resnet.py``, this module holds no parameters of its own. It is
applied to a flat f32 buffer laid out by :meth:`ViT.layout`, ``[D]`` or
``[C, D]`` (one model per client), in timm's ``vit_base_patch16_224``
``state_dict`` names, shapes and order. Every weight is a client's own: the
patch embedding (stride = kernel, so a reshape and no im2col), qkv, proj,
fc1, fc2 and the head are each one ``torch.baddbmm`` over the clients, each
LayerNorm an unweighted ``F.layer_norm`` and then the client's scale and
bias, and the attention one ``F.scaled_dot_product_attention`` over
``[C*B, heads, tokens, head size]``. On CUDA it runs on PyTorch's
memory-efficient backend alone (its f32 products are 3xTF32, f32-accurate),
so that a call the backend turns down raises and no slower path runs in
its place; elsewhere on the math backend (:func:`attention_backends`).

While a profiler session records, the sub-blocks are spans of
``utils/tracing.py``: ``vit_embed``, then ``vit_attention`` and ``vit_mlp``
for each block (the norm, the branch and the residual add), and
``vit_head`` in the forward; their ``.bwd`` twins in the backward, whose
edges are gradient hooks on the residual stream between the sub-blocks
(``tracing.backward_spans``, registered only then).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from multimodal_fl_security_tpu_torch.core.pytrees import FlatLayout
from multimodal_fl_security_tpu_torch.models.registry import MODELS
from multimodal_fl_security_tpu_torch.models.simple_cnn import lecun_normal_
from multimodal_fl_security_tpu_torch.utils import tracing

#: the span families, in forward order
SPANS = ("vit_embed", "vit_attention", "vit_mlp", "vit_head")
#: the standard deviation of the position embeddings' draw (timm's)
POS_STD = 0.02


def attention_backends(device: torch.device) -> List[SDPBackend]:
    """The one attention backend for ``device``: memory-efficient on CUDA
    (flash takes no f32), math elsewhere."""
    return [SDPBackend.EFFICIENT_ATTENTION if device.type == "cuda"
            else SDPBackend.MATH]


def _linear(h: torch.Tensor, p: Dict[str, torch.Tensor],
            name: str) -> torch.Tensor:
    """Each client's ``name`` layer on its rows ``h`` ``[C, n, in]``."""
    return torch.baddbmm(p[name + ".bias"].unsqueeze(1), h,
                         p[name + ".weight"].transpose(1, 2))


class ViT(nn.Module):
    """Pre-LN Vision Transformer with a class token; :func:`vit_b16` fixes
    ViT-B/16's widths (D = 85,952,456 at 200 classes)."""

    def __init__(self, num_classes: int = 200, hidden_dim: int = 768,
                 image_size: Tuple[int, int] = (224, 224),
                 dtype: torch.dtype = torch.float32,
                 dropout_rates: Tuple[float, ...] = (0.3,),
                 patch_size: int = 16, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, eps: float = 1e-6):
        super().__init__()
        self.patch_size, self.depth = int(patch_size), int(depth)
        self.num_heads, self.mlp_dim = int(num_heads), int(mlp_dim)
        self.eps = float(eps)
        self.hidden_dim = int(hidden_dim)
        self.image_size = (int(image_size[0]), int(image_size[1]))
        if self.hidden_dim % self.num_heads:
            raise ValueError(f"width {hidden_dim} does not split into "
                             f"{num_heads} heads")
        if any(s % self.patch_size for s in self.image_size):
            raise ValueError(f"{self.image_size} images do not split into "
                             f"{patch_size} x {patch_size} patches")
        if self.depth < 1:
            raise ValueError(f"ViT takes at least one block, got {depth}")
        if len(dropout_rates) != 1:
            raise ValueError(f"ViT's head has one dropout rate, got "
                             f"{tuple(dropout_rates)}")
        if dtype != torch.float32:
            raise ValueError(f"ViT computes in float32 only, not {dtype}")
        self.num_classes = int(num_classes)
        self.dtype = dtype
        self.dropout_rates = (float(dropout_rates[0]),)
        self.tokens = 1 + (self.image_size[0] // self.patch_size) * (
            self.image_size[1] // self.patch_size)
        self._layouts: Dict[int, FlatLayout] = {}

    def layout(self, in_channels: int) -> FlatLayout:
        """Flat layout of the parameters for ``in_channels`` input channels,
        in timm's ``state_dict`` order, names and shapes."""
        if in_channels not in self._layouts:
            d, m, k = self.hidden_dim, self.mlp_dim, self.patch_size
            entries = [("cls_token", (1, 1, d)),
                       ("pos_embed", (1, self.tokens, d)),
                       ("patch_embed.proj.weight", (d, in_channels, k, k)),
                       ("patch_embed.proj.bias", (d,))]
            for i in range(self.depth):
                b = f"blocks.{i}."
                entries += [
                    (b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                    (b + "attn.qkv.weight", (3 * d, d)),
                    (b + "attn.qkv.bias", (3 * d,)),
                    (b + "attn.proj.weight", (d, d)),
                    (b + "attn.proj.bias", (d,)),
                    (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                    (b + "mlp.fc1.weight", (m, d)), (b + "mlp.fc1.bias", (m,)),
                    (b + "mlp.fc2.weight", (d, m)), (b + "mlp.fc2.bias", (d,))]
            entries += [("norm.weight", (d,)), ("norm.bias", (d,)),
                        ("head.weight", (self.num_classes, d)),
                        ("head.bias", (self.num_classes,))]
            self._layouts[in_channels] = FlatLayout(entries)
        return self._layouts[in_channels]

    def _norm(self, h: torch.Tensor, p: Dict[str, torch.Tensor],
              name: str) -> torch.Tensor:
        """Each token's LayerNorm of ``h`` ``[C, ..., d]``, then its client's
        scale and bias."""
        shape = (h.shape[0],) + (1,) * (h.dim() - 2) + (h.shape[-1],)
        return torch.addcmul(p[name + ".bias"].view(shape),
                             F.layer_norm(h, h.shape[-1:], eps=self.eps),
                             p[name + ".weight"].view(shape))

    def _attention(self, h: torch.Tensor, p: Dict[str, torch.Tensor],
                   prefix: str) -> torch.Tensor:
        """The attention branch on ``h`` ``[C, B, T, d]``: qkv, the softmax
        attention of every head, proj."""
        c, b, t, d = h.shape
        qkv = _linear(h.view(c, b * t, d), p, prefix + "attn.qkv")
        q, k, v = qkv.view(c * b, t, 3, self.num_heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)
        with sdpa_kernel(attention_backends(q.device)):
            o = F.scaled_dot_product_attention(q, k, v)
        o = o.transpose(1, 2).reshape(c, b * t, d)
        return _linear(o, p, prefix + "attn.proj").view(c, b, t, d)

    def _mlp(self, h: torch.Tensor, p: Dict[str, torch.Tensor],
             prefix: str) -> torch.Tensor:
        c, b, t, d = h.shape
        z = F.gelu(_linear(h.view(c, b * t, d), p, prefix + "mlp.fc1"))
        return _linear(z, p, prefix + "mlp.fc2").view(c, b, t, d)

    def forward(self, params: torch.Tensor, x: torch.Tensor,
                dropout=None) -> torch.Tensor:
        """Logits (f32) of every client's model on its own batch.

        ``params`` ``[C, D]`` with ``x`` ``[C, B, C_in, H, W]`` gives
        ``[C, B, num_classes]``; ``params`` ``[D]`` with ``x``
        ``[B, C_in, H, W]`` gives ``[B, num_classes]``. ``dropout`` is None
        (no dropout) or a step's masks (``ops/client_dropout.py::
        RoundDraws``), called as ``dropout(h, 0)`` on the head's normed
        class tokens ``[C, B, hidden_dim]``.
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
        device, span = x.device, tracing.span
        d, k = self.hidden_dim, self.patch_size
        gh, gw = height // k, width // k
        embed_w = p["patch_embed.proj.weight"].view(clients, d, -1)
        with span("vit_embed", device):
            patches = x.reshape(clients, batch, cin, gh, k, gw, k).permute(
                0, 1, 3, 5, 2, 4, 6).reshape(clients, batch * gh * gw, -1)
            h = torch.baddbmm(p["patch_embed.proj.bias"].unsqueeze(1),
                              patches, embed_w.transpose(1, 2))
            cls = p["cls_token"].expand(clients, batch, 1, d)
            h = torch.cat([cls, h.view(clients, batch, gh * gw, d)], dim=2)
            h = h + p["pos_embed"]
        marks = [(h, "vit_embed.bwd"), (embed_w, None)]
        for i in range(self.depth):
            prefix = f"blocks.{i}."
            with span("vit_attention", device):
                h = h + self._attention(self._norm(h, p, prefix + "norm1"),
                                        p, prefix)
            marks.insert(0, (h, "vit_attention.bwd"))
            with span("vit_mlp", device):
                h = h + self._mlp(self._norm(h, p, prefix + "norm2"), p,
                                  prefix)
            marks.insert(0, (h, "vit_mlp.bwd"))
        with span("vit_head", device):
            # LayerNorm is per token, so LN(x)[cls] is LN(x[cls])
            z = self._norm(h[:, :, 0], p, "norm")
            if dropout is not None:
                z = dropout(z, 0)
            logits = _linear(z, p, "head")
        if tracing.enabled() and logits.requires_grad:
            tracing.backward_spans([(logits, "vit_head.bwd")] + marks,
                                   device)
        return logits[0] if single else logits

    def init_params(self, in_channels: int,
                    generator: torch.Generator) -> torch.Tensor:
        """A fresh ``[D]`` f32 buffer (on the generator's device):
        lecun-normal matrices and patch filters, LayerNorm scales 1, zero
        biases and class token, position embeddings N(0, 0.02²) truncated
        at 2 sigma (timm's)."""
        layout = self.layout(in_channels)
        flat = torch.zeros(layout.dim, dtype=torch.float32,
                           device=generator.device)
        for name, view in layout.views(flat).items():
            if name == "pos_embed":
                nn.init.trunc_normal_(view, 0.0, POS_STD, -2 * POS_STD,
                                      2 * POS_STD, generator=generator)
            elif name != "cls_token" and view.dim() > 1:
                lecun_normal_(view, view[0].numel(), generator)
            elif name.endswith(".weight"):
                view.fill_(1.0)
        return flat


@MODELS.register("vit_b16")
def vit_b16(num_classes: int = 200, hidden_dim: int = 768, **kwargs) -> ViT:
    """ViT-B/16 at its published widths: 16 x 16 patches, 12 blocks of
    width 768, 12 heads, MLP 3,072, LayerNorm eps 1e-6."""
    if int(hidden_dim) != 768:
        raise ValueError(f"ViT-B/16's width is 768, got {hidden_dim}")
    return ViT(num_classes=num_classes, hidden_dim=768, patch_size=16,
               depth=12, num_heads=12, mlp_dim=3072, eps=1e-6, **kwargs)
