"""Reductions, selects and carried state of the probes (K5 and K6).

Counterparts of the masked softmax cross-entropy, the max-pool pieces, the
relu and iota masks, the diagonal-block fold and the two carried-state
kernels of ``benchmarks/mosaic_probe.py`` (K5) and
``benchmarks/ad_in_kernel_probe.py`` (K6), with the backward pieces the
autodiff probes need. Each wrapper launches its hand-written kernel of
``csrc/probe_reduce.cu`` for CUDA tensors, or raises, and runs its
``*_plain`` version for CPU tensors. All take and give f32.

Tie rule: the backward of a maximum splits a tie's gradient equally between
the two sides, as JAX's ``maximum`` and ``reduce_max`` VJPs do and as
``torch.maximum`` and ``torch.amax`` do; ``torch.max(dim)`` does not.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional, Tuple

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    MftView,
    check,
    require_cuda,
    stream_of,
    view,
)

#: masked lanes read as this, as the probes' ``jnp.where`` does
MASKED = -1e30
_ROWS_LANES = (0, 1)


class _Dims5(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong * 5)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_reduce")
    p = ctypes.POINTER(MftView)
    d = ctypes.POINTER(_Dims5)
    i, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.mft_masked_ce.argtypes = [p] * 4 + [ptr, p, i, i, i, i, ptr]
    lib.mft_max2_packed.argtypes = [ctypes.c_char_p, i, i, ptr]
    lib.mft_max2_bwd.argtypes = [p] * 5 + [d, i, ptr]
    lib.mft_relu_mask.argtypes = [p] * 3 + [d, i, i64, i64, i64, i, i, ptr]
    lib.mft_block_fold.argtypes = [p] * 2 + [i] * 6 + [ptr]
    lib.mft_carry_sum.argtypes = [p] * 2 + [i] * 4 + [ptr]
    lib.mft_scalar_accum.argtypes = [p, ptr] + [i] * 3 + [ptr]
    for fn in (lib.mft_masked_ce, lib.mft_max2_packed, lib.mft_max2_bwd,
               lib.mft_relu_mask, lib.mft_block_fold, lib.mft_carry_sum,
               lib.mft_scalar_accum):
        fn.restype = i
    lib.mft_probe_reduce_error_string.argtypes = [i]
    lib.mft_probe_reduce_error_string.restype = ctypes.c_char_p
    return lib


def _f32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the probe reductions take f32, got {t.dtype}")


def _space(shape) -> Tuple[_Dims5, tuple]:
    """A shape of up to five axes as the kernels' index space: leading
    extents of 1 and the tensor dims that play the last axes."""
    nd = len(shape)
    if not 1 <= nd <= 5:
        raise ValueError(f"need 1 to 5 axes, got {tuple(shape)}")
    d = _Dims5()
    for k, n in enumerate([1] * (5 - nd) + list(shape)):
        d.n[k] = n
    return d, (None,) * (5 - nd) + tuple(range(nd))


def _launch(name: str, *args) -> None:
    lib = _library()
    err = getattr(lib, f"mft_{name}")(*args)
    check(lib, err, name, "probe_reduce")


# ------------------------------------------------------ masked cross-entropy

def _masked_logits(z: torch.Tensor, nvalid: int) -> torch.Tensor:
    lanes = torch.arange(z.shape[1], device=z.device)
    return torch.where(lanes < nvalid, z, torch.tensor(MASKED,
                                                       device=z.device))


def _onehot_of(z, labels, onehot):
    if onehot is not None:
        return onehot.float()
    lanes = torch.arange(z.shape[1], device=z.device)
    return (lanes[None, :] == labels.reshape(-1, 1)).float()


def masked_ce_plain(z, labels=None, onehot=None, *, nvalid=10,
                    rowgrad=None, grad=False):
    """Plain version of :func:`masked_ce`."""
    zm = _masked_logits(z.float(), nvalid)
    oh = _onehot_of(z, labels, onehot)
    lse = torch.logsumexp(zm, dim=1, keepdim=True)
    ohs = oh.sum(dim=1, keepdim=True)
    nll = (lse * ohs - (oh * zm).sum(dim=1, keepdim=True))[:, 0]
    if not grad:
        return nll, None
    g = rowgrad.float()[:, None] if rowgrad is not None else 1.0
    lanes = torch.arange(z.shape[1], device=z.device)
    dz = torch.where(lanes < nvalid, g * (torch.exp(zm - lse) * ohs - oh),
                     torch.zeros((), device=z.device))
    return nll, dz


def masked_ce(z: torch.Tensor, labels: Optional[torch.Tensor] = None,
              onehot: Optional[torch.Tensor] = None, *, nvalid: int = 10,
              rowgrad: Optional[torch.Tensor] = None, grad: bool = False):
    """Cross-entropy of the logits ``z`` [R, L] over lanes < ``nvalid``
    (the others read as -1e30) against ``labels`` [R] (any int layout of R
    elements) or ``onehot`` [R, L]: (nll [R] = lse * sum(onehot) -
    sum(onehot * z), and when ``grad``, dz [R, L] = rowgrad * (softmax *
    sum(onehot) - onehot) on the valid lanes, 0 elsewhere; else None).
    ``masked_ce.launches`` counts kernel launches."""
    if (labels is None) == (onehot is None):
        raise ValueError("give labels or onehot")
    if z.device.type == "cpu":
        return masked_ce_plain(z, labels, onehot, nvalid=nvalid,
                               rowgrad=rowgrad, grad=grad)
    _f32(z, *(t for t in (onehot, rowgrad) if t is not None))
    opt = [t for t in (labels, onehot, rowgrad) if t is not None]
    device = require_cuda(z, *opt)
    rows, lanes = z.shape
    if labels is not None:
        labels = labels.reshape(rows).long()
    nll = torch.empty((rows,), dtype=torch.float32, device=device)
    dz = torch.empty_like(z, memory_format=torch.contiguous_format) \
        if grad else None
    views = [view(z, _ROWS_LANES), view(labels, (0,)),
             view(onehot, _ROWS_LANES), view(rowgrad, (0,))]
    _launch("masked_ce", *[ctypes.byref(v) for v in views],
            nll.data_ptr(), ctypes.byref(view(dz, _ROWS_LANES)), rows, lanes,
            nvalid, device.index, stream_of(z))
    masked_ce.launches += 1
    return nll, dz


masked_ce.launches = 0


# ------------------------------------------------------------ maximum of two

def max2_plain(a, b):
    """Plain version of :func:`max2`: JAX's ``maximum`` (and ``jnp.max``
    over the probe's pair axis), bit for bit on every device: a NaN operand
    wins, the first if both are, and of two equal values the one without
    the sign bit (+0 above -0). ``torch.maximum`` on the CPU differs in
    both (an all-ones NaN, and b of a tie)."""
    take_a = torch.isnan(a) | (~torch.isnan(b) & (
        (a > b) | ((a == b) & ~torch.signbit(a))))
    return torch.where(take_a, a, b)


#: max2's packed launch arguments, 18 int64: three addresses, five
#: extents, and the two operands' five strides each
_MAX2_ARGS = struct.Struct("18q")
#: leading extents (1) and strides (0) that pad a shape to five axes
_PAD5 = {nd: ((1,) * (5 - nd), (0,) * (5 - nd)) for nd in range(1, 6)}


def max2_launch_args(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor
                     ) -> Tuple[int, tuple]:
    """(route, packed arguments) of :func:`max2`'s launch on same-shape
    ``a``, ``b`` and the dense ``out``: the addresses of the three, the
    shape's extents with leading 1s to five axes, and ``a``'s and ``b``'s
    strides in elements (0 on the leading axes). Route 1, rows of float4,
    where the last axis has stride 1 and an extent that is a multiple of 4
    and every row starts 16-byte aligned in ``a`` and ``b``; route 0, one
    element a thread, otherwise. (The kernel refuses extents and offsets
    past 32 bits.)"""
    shape = a.shape
    if not 1 <= len(shape) <= 5:
        raise ValueError(f"need 1 to 5 axes, got {tuple(shape)}")
    ones, zeros = _PAD5[len(shape)]
    sa, sb = a.stride(), b.stride()
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()
    lead = 0  # the row strides, or-ed: a multiple of 4 iff each one is
    for s in sa[:-1] + sb[:-1]:
        lead |= s
    rows = sa[-1] == 1 and sb[-1] == 1 and not shape[-1] % 4 and \
        not (pa | pb | po) % 16 and not lead % 4
    return int(rows), (pa, pb, po, *ones, *shape, *zeros, *sa, *zeros, *sb)


@functools.cache
def _max2_entry():
    return _library().mft_max2_packed


def max2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of two same-shape views (up to 5 axes), as
    JAX's ``maximum`` takes it (see :func:`max2_plain`): a new contiguous
    f32 tensor. The route is chosen before the launch (see
    :func:`max2_launch_args`). ``max2.launches`` counts kernel launches."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"max2 takes f32, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return max2_plain(a, b)
    device = a.get_device()
    if b.get_device() != device:
        raise ValueError(f"the kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    rows, args = max2_launch_args(a, b, out)
    # The current stream's raw handle, without building a Stream object.
    err = _max2_entry()(_MAX2_ARGS.pack(*args), rows, device,
                        torch._C._cuda_getCurrentRawStream(device))
    if err:
        check(_library(), err, f"max2 (route {rows}, shape {tuple(a.shape)}, "
              f"strides {a.stride()} and {b.stride()})", "probe_reduce")
    max2.launches += 1
    return out


max2.launches = 0


def max2_bwd_plain(a, b, g, ga, gb):
    """Plain version of :func:`max2_bwd`."""
    zero = torch.zeros((), device=g.device)
    tie = 0.5 * g
    ga.copy_(torch.where(a > b, g, torch.where(a == b, tie, zero)))
    gb.copy_(torch.where(b > a, g, torch.where(a == b, tie, zero)))


def max2_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
             ga: torch.Tensor, gb: torch.Tensor) -> None:
    """Backward of :func:`max2` from ``g``: writes the gradients of ``a``
    and ``b`` into the views ``ga`` and ``gb`` (which may interleave in one
    tensor, as the pair max's do); a tie gives each side half.
    ``max2_bwd.launches`` counts kernel launches."""
    if not a.shape == b.shape == g.shape == ga.shape == gb.shape:
        raise ValueError("max2_bwd takes five views of one shape")
    if a.device.type == "cpu":
        return max2_bwd_plain(a, b, g, ga, gb)
    _f32(a, b, g, ga, gb)
    device = require_cuda(a, b, g, ga, gb)
    dims, axes = _space(a.shape)
    views = [view(t, axes) for t in (a, b, g, ga, gb)]
    _launch("max2_bwd", *[ctypes.byref(v) for v in views],
            ctypes.byref(dims), device.index, stream_of(a))
    max2_bwd.launches += 1


max2_bwd.launches = 0


# --------------------------------------------------------- relu and iota mask

def _keep_plain(x, dim, keep):
    if keep is None:
        return torch.ones((), dtype=torch.bool, device=x.device)
    mod, lo, hi = keep
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    r = torch.remainder(torch.arange(x.shape[dim], device=x.device), mod)
    return ((r >= lo) & (r < hi)).view(shape)


def relu_mask_plain(x, dim=0, keep=None):
    """Plain version of :func:`relu_mask`."""
    m = _keep_plain(x, dim, keep)
    return torch.relu(x) * m.float()


def _relu_mask_launch(x, g, dim, keep, bwd):
    _f32(x, *([g] if g is not None else []))
    device = require_cuda(x, *([g] if g is not None else []))
    dims, axes = _space(x.shape)
    out = torch.empty(x.shape, dtype=torch.float32, device=device)
    mod, lo, hi = keep if keep is not None else (0, 0, 0)
    axis = 5 - x.dim() + dim % x.dim()
    views = [view(x, axes), view(g, axes), view(out, axes)]
    _launch("relu_mask", *[ctypes.byref(v) for v in views],
            ctypes.byref(dims), axis, mod, lo, hi, int(bwd), device.index,
            stream_of(x))
    return out


def relu_mask(x: torch.Tensor, dim: int = 0,
              keep: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """``relu(x)`` times the iota predicate ``lo <= i % mod < hi`` on axis
    ``dim`` (``keep=(mod, lo, hi)``; None keeps all). ``relu_mask.launches``
    counts kernel launches."""
    if x.device.type == "cpu":
        return relu_mask_plain(x, dim, keep)
    out = _relu_mask_launch(x, None, dim, keep, False)
    relu_mask.launches += 1
    return out


relu_mask.launches = 0


def relu_mask_bwd_plain(x, g, dim=0, keep=None):
    """Plain version of :func:`relu_mask_bwd`."""
    m = _keep_plain(x, dim, keep)
    return torch.where(m & (x > 0), g, torch.zeros((), device=g.device))


def relu_mask_bwd(x: torch.Tensor, g: torch.Tensor, dim: int = 0,
                  keep: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Backward of :func:`relu_mask`: ``g`` where ``x > 0`` and the
    predicate holds, else 0. ``relu_mask_bwd.launches`` counts launches."""
    if x.shape != g.shape:
        raise ValueError("x and g must share a shape")
    if x.device.type == "cpu":
        return relu_mask_bwd_plain(x, g, dim, keep)
    out = _relu_mask_launch(x, g, dim, keep, True)
    relu_mask_bwd.launches += 1
    return out


relu_mask_bwd.launches = 0


# ------------------------------------------------------- diagonal-block fold

def block_fold_plain(x, rows, cols, nb):
    """Plain version of :func:`block_fold`."""
    acc = torch.zeros((rows, cols), dtype=torch.float32, device=x.device)
    for b in range(nb):
        acc = acc + x[b * rows:b * rows + rows, b * cols:b * cols + cols]
    return acc


def block_fold(x: torch.Tensor, rows: int, cols: int, nb: int
               ) -> torch.Tensor:
    """``sum_b x[b*rows + i, b*cols + j]`` over the ``nb`` diagonal
    [rows, cols] blocks of ``x`` [R, L], added in b order from 0.
    ``block_fold.launches`` counts kernel launches."""
    if x.dim() != 2 or x.shape[0] < nb * rows or x.shape[1] < nb * cols:
        raise ValueError(f"x {tuple(x.shape)} holds no {nb} diagonal "
                         f"[{rows}, {cols}] blocks")
    if x.device.type == "cpu":
        return block_fold_plain(x, rows, cols, nb)
    _f32(x)
    device = require_cuda(x)
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    _launch("block_fold", ctypes.byref(view(x, _ROWS_LANES)),
            ctypes.byref(view(out, _ROWS_LANES)), rows, cols, nb, rows,
            cols, device.index, stream_of(x))
    block_fold.launches += 1
    return out


block_fold.launches = 0


# ------------------------------------------------------------- carried state

def carry_sum_plain(x):
    """Plain version of :func:`carry_sum`: the same sum, step by step."""
    acc = torch.zeros_like(x[:, 0], dtype=torch.float32)
    for s in range(x.shape[1]):
        acc = acc + x[:, s]
    return acc


def carry_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` [C, S, E] summed over the S steps in order, one accumulator per
    (client, element) carried across the steps: [C, E].
    ``carry_sum.launches`` counts kernel launches."""
    if x.dim() != 3:
        raise ValueError(f"need x [C, S, E], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return carry_sum_plain(x)
    _f32(x)
    device = require_cuda(x)
    c, s, e = x.shape
    out = torch.empty((c, e), dtype=torch.float32, device=device)
    _launch("carry_sum", ctypes.byref(view(x, (0, 1, 2))),
            ctypes.byref(view(out, (0, 1))), c, s, e, device.index,
            stream_of(x))
    carry_sum.launches += 1
    return out


carry_sum.launches = 0


def scalar_accum_plain(x):
    """Plain version of :func:`scalar_accum`."""
    acc = torch.zeros((1,), dtype=torch.float32, device=x.device)
    for s in range(x.shape[0]):
        acc = acc + x[s].sum()
    return acc


def scalar_accum(x: torch.Tensor) -> torch.Tensor:
    """One scalar carried across the S steps of ``x`` [S, E]: each step's
    sum (a fixed-order tree) added to it in step order; [1].
    ``scalar_accum.launches`` counts kernel launches."""
    if x.dim() != 2:
        raise ValueError(f"need x [S, E], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return scalar_accum_plain(x)
    _f32(x)
    device = require_cuda(x)
    out = torch.empty((1,), dtype=torch.float32, device=device)
    _launch("scalar_accum", ctypes.byref(view(x, (0, 1))),
            out.data_ptr(), x.shape[0], x.shape[1], device.index,
            stream_of(x))
    scalar_accum.launches += 1
    return out


scalar_accum.launches = 0

#: every wrapper of this module, for launch counts
WRAPPERS = (masked_ce, max2, max2_bwd, relu_mask, relu_mask_bwd, block_fold,
            carry_sum, scalar_accum)
