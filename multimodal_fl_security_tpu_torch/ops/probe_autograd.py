"""Hand-written backward passes of the autodiff probes (K6).

Counterpart of ``benchmarks/ad_in_kernel_probe.py``, whose kernels run
``jax.grad`` inside a Pallas kernel body (``droll`` at ``:67-80`` is its
``custom_vjp`` roll). Here each op of those bodies is a
``torch.autograd.Function`` whose forward and backward both launch the
probe kernels (``ops/probe_layout.py``, ``probe_contract.py``,
``probe_reduce.py``) on CUDA tensors, or run their plain versions on CPU
tensors:

- :class:`Roll`: a roll; its backward is the opposite roll.
- :class:`MaskRelu`: relu times an iota predicate on one axis.
- :class:`Max2` and :class:`PairMax`: the maximum of two tensors, and of
  the two halves of a size-2 axis; a tie's gradient is split equally, as
  JAX's ``maximum`` and ``reduce_max`` VJPs split it.
- :class:`BatchedDot`: ``[b, m, k] x [b, k, n]``; both backward products.
- :class:`DotRL`: ``[r, b, l] x [r, l, f] -> [b, f]``, one contraction
  over (r, l) as K5's ``einsum_brl_rlf``; both backward products batched
  over r.
- :class:`Wgrad2d`: ``a^T d`` over merged rows, and its backward.
- :class:`MaskedCE`: the masked softmax cross-entropy per row.

:data:`KERNEL_OPS` holds them and :data:`PLAIN_OPS` the same ops in plain
PyTorch, whose gradients ``torch.autograd`` derives; the probe bodies take
either, so one body is both the kernel path and its plain version.
"""

from __future__ import annotations

import types

import torch

from multimodal_fl_security_tpu_torch.ops.probe_contract import contract
from multimodal_fl_security_tpu_torch.ops.probe_layout import roll
from multimodal_fl_security_tpu_torch.ops.probe_reduce import (
    masked_ce,
    masked_ce_plain,
    max2,
    max2_bwd,
    relu_mask,
    relu_mask_bwd,
    relu_mask_plain,
)


class Roll(torch.autograd.Function):
    """``torch.roll(x, shift, dim)``; backward: roll by ``-shift``."""

    @staticmethod
    def forward(ctx, x, shift, dim):
        ctx.shift, ctx.dim = shift, dim
        return roll(x, shift, dim)

    @staticmethod
    def backward(ctx, g):
        return roll(g, -ctx.shift, ctx.dim), None, None


class MaskRelu(torch.autograd.Function):
    """``relu(x)`` times the predicate ``keep=(mod, lo, hi)`` on ``dim``."""

    @staticmethod
    def forward(ctx, x, dim, keep):
        ctx.save_for_backward(x)
        ctx.dim, ctx.keep = dim, keep
        return relu_mask(x, dim, keep)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return relu_mask_bwd(x, g, ctx.dim, ctx.keep), None, None


class Max2(torch.autograd.Function):
    """Elementwise maximum; a tie sends half the gradient each way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return max2(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.empty(a.shape, dtype=torch.float32, device=a.device)
        gb = torch.empty_like(ga)
        max2_bwd(a, b, g, ga, gb)
        return ga, gb


class PairMax(torch.autograd.Function):
    """The maximum over a size-2 axis ``dim`` of ``v``: ``torch.amax(v,
    dim)``; the backward writes both halves of one new gradient."""

    @staticmethod
    def forward(ctx, v, dim):
        if v.shape[dim] != 2:
            raise ValueError(f"axis {dim} of {tuple(v.shape)} is not a pair")
        ctx.save_for_backward(v)
        ctx.dim = dim
        return max2(v.select(dim, 0), v.select(dim, 1))

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        gv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        d = ctx.dim
        max2_bwd(v.select(d, 0), v.select(d, 1), g, gv.select(d, 0),
                 gv.select(d, 1))
        return gv, None


class BatchedDot(torch.autograd.Function):
    """``C[b] = A[b] W[b]``; backward ``dA = G W^T``, ``dW = A^T G``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return contract(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = contract(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        gw = contract(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return ga, gw


class DotRL(torch.autograd.Function):
    """``C[b, f] = sum_{r, l} X[r, b, l] W[r, l, f]`` in one contraction
    with a two-stride k; backward ``dX[r] = G W[r]^T``, ``dW[r] = X[r]^T
    G``, batched over r with ``G`` broadcast."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return contract(x.permute(1, 0, 2)[None], w[None])[0]

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gr = g[None].expand(x.shape[0], *g.shape)
        gx = contract(gr, w.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        gw = contract(x.transpose(1, 2), gr) if ctx.needs_input_grad[1] \
            else None
        return gx, gw


class Wgrad2d(torch.autograd.Function):
    """``W = a^T d`` over the rows of ``a`` [R, K1] and ``d`` [R, K2];
    backward ``da = d G^T``, ``dd = a G``."""

    @staticmethod
    def forward(ctx, a, d):
        ctx.save_for_backward(a, d)
        return contract(a.T[None], d[None])[0]

    @staticmethod
    def backward(ctx, g):
        a, d = ctx.saved_tensors
        ga = contract(d[None], g.T[None])[0] if ctx.needs_input_grad[0] \
            else None
        gd = contract(a[None], g[None])[0] if ctx.needs_input_grad[1] \
            else None
        return ga, gd


class MaskedCE(torch.autograd.Function):
    """nll [R] of the logits ``z`` [R, L] over lanes < ``nvalid`` against
    ``onehot`` [R, L]; backward ``g_r (softmax * sum(onehot) - onehot)``."""

    @staticmethod
    def forward(ctx, z, onehot, nvalid):
        ctx.save_for_backward(z, onehot)
        ctx.nvalid = nvalid
        return masked_ce(z, onehot=onehot, nvalid=nvalid)[0]

    @staticmethod
    def backward(ctx, g):
        z, onehot = ctx.saved_tensors
        _, dz = masked_ce(z, onehot=onehot, nvalid=ctx.nvalid, rowgrad=g,
                          grad=True)
        return dz, None, None


KERNEL_OPS = types.SimpleNamespace(
    roll=Roll.apply,
    mask_relu=MaskRelu.apply,
    max2=Max2.apply,
    pair_max=PairMax.apply,
    dot=BatchedDot.apply,
    dot_rl=DotRL.apply,
    wgrad=Wgrad2d.apply,
    ce=lambda z, onehot, nvalid=10: MaskedCE.apply(z, onehot, nvalid),
)

PLAIN_OPS = types.SimpleNamespace(
    roll=torch.roll,
    mask_relu=relu_mask_plain,
    max2=torch.maximum,
    pair_max=torch.amax,
    dot=lambda a, w: torch.einsum("bmk,bkn->bmn", a, w),
    dot_rl=lambda x, w: torch.einsum("rbl,rlf->bf", x, w),
    wgrad=lambda a, d: torch.einsum("rk,rn->kn", a, d),
    ce=lambda z, onehot, nvalid=10: masked_ce_plain(z, onehot=onehot,
                                                    nvalid=nvalid)[0],
)
