"""The loss and the optimizer of per-client local training.

Counterpart of ``multimodal_fl_security_tpu/ops/fused_train.py::packed_ce``
(``:511-524``) and of the global-norm clip, momentum and update of
``ops/fused_kernel.py::fused_local_train`` (K4, ``:447-479``). The wrappers
launch the hand-written kernels of ``csrc/client_sgd.cu`` for CUDA tensors,
or raise, and run their ``*_plain`` versions for CPU tensors.

The optimizer runs over the flat ``[C, D]`` buffers, where every logical
weight is one element, so the clip counts each weight once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    MftView,
    check,
    require_cuda,
    stream_of,
    view,
)

#: block partials of each client's squared gradient norm
NORM_PARTS = 32
#: elements each thread of the update kernel handles, on average
UPDATE_PER_THREAD = 4
_THREADS = 256


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("client_sgd")
    p = ctypes.POINTER(MftView)
    i, i64, f32, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_float, \
        ctypes.c_void_p
    lib.mft_ce.argtypes = [p] * 4 + [ptr, i, i, i, i, ptr]
    lib.mft_sq_norm.argtypes = [ptr, i64, i64, ptr, i, i, i, ptr]
    lib.mft_sgd_update.argtypes = [ptr, ptr, ptr, i64, i64, ptr, i, i, f32,
                                   f32, f32, i, i, ptr]
    for fn in (lib.mft_ce, lib.mft_sq_norm, lib.mft_sgd_update):
        fn.restype = i
    lib.mft_client_sgd_error_string.argtypes = [i]
    lib.mft_client_sgd_error_string.restype = ctypes.c_char_p
    return lib


# --------------------------------------------------------------- loss

def client_ce_plain(logits, labels, mask):
    """Plain version of :func:`client_ce`."""
    logp = F.log_softmax(logits.float(), dim=-1)
    m = mask.float()
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    denom = m.sum(dim=1).clamp_min(1.0)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    dlogits = (logp.exp() - onehot) * m.unsqueeze(-1) \
        * (1.0 / denom)[:, None, None]
    return (nll * m).sum(dim=1) / denom, dlogits


def client_ce(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy per client: ``logits`` [C, rows, K] (f32),
    ``labels`` [C, rows] (int64), ``mask`` [C, rows] -> (loss [C], dlogits
    [C, rows, K] = (softmax - onehot) * mask / max(sum(mask), 1)). Rows
    with mask 0 add nothing. ``client_ce.launches`` counts kernel launches."""
    if logits.device.type == "cpu":
        return client_ce_plain(logits, labels, mask)
    if logits.dtype != torch.float32 or labels.dtype != torch.int64 \
            or mask.dtype != torch.float32:
        raise TypeError("client_ce takes f32 logits, int64 labels, f32 mask")
    device = require_cuda(logits, labels, mask)
    c, rows, k = logits.shape
    loss = torch.empty((c,), dtype=torch.float32, device=device)
    dlogits = torch.empty((c, rows, k), dtype=torch.float32, device=device)
    lib = _library()
    views = [view(logits, (0, 1, 2)), view(labels, (0, 1)),
             view(mask, (0, 1)), view(dlogits, (0, 1, 2))]
    err = lib.mft_ce(*[ctypes.byref(v) for v in views], loss.data_ptr(), c,
                     rows, k, device.index, stream_of(logits))
    check(lib, err, "client_ce", "client_sgd")
    client_ce.launches += 1
    return loss, dlogits


client_ce.launches = 0


# --------------------------------------------------------------- optimizer

def _check_rows(*bufs: torch.Tensor) -> None:
    for b in bufs:
        if b.dim() != 2 or b.dtype != torch.float32 or b.stride(1) != 1:
            raise ValueError("the optimizer takes [C, D] f32 buffers with "
                             "unit column stride")
    if len({(b.shape, b.stride(0)) for b in bufs}) != 1:
        raise ValueError("params, momentum and gradient must share shape "
                         "and row stride")


def client_sq_norm_plain(grad: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`client_sq_norm`: one partial per client."""
    return (grad * grad).sum(dim=1, keepdim=True)


def client_sq_norm(grad: torch.Tensor) -> torch.Tensor:
    """Partial sums [C, P] of each client's squared gradient norm over its
    ``grad`` row; the clients' squares are their rows' sums.
    ``client_sq_norm.launches`` counts kernel launches."""
    if grad.device.type == "cpu":
        return client_sq_norm_plain(grad)
    _check_rows(grad)
    device = require_cuda(grad)
    c, d = grad.shape
    partial = torch.empty((c, NORM_PARTS), dtype=torch.float32, device=device)
    lib = _library()
    err = lib.mft_sq_norm(grad.data_ptr(), grad.stride(0), d,
                          partial.data_ptr(), c, NORM_PARTS, device.index,
                          stream_of(grad))
    check(lib, err, "client_sq_norm", "client_sgd")
    client_sq_norm.launches += 1
    return partial


client_sq_norm.launches = 0


def clip_scale(partial: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """clip / max(norm, clip) per client [C] (1 when ``clip_norm`` <= 0)."""
    if not clip_norm > 0:
        return torch.ones(partial.shape[0], device=partial.device)
    norm = torch.sqrt(partial.sum(dim=1))
    return clip_norm / torch.clamp_min(norm, clip_norm)


def client_sgd_update_plain(params, mom, grad, partial, *, lr, momentum,
                            clip_norm) -> None:
    """Plain version of :func:`client_sgd_update` (in place as well)."""
    scale = clip_scale(partial, clip_norm).unsqueeze(1)
    mom.copy_(grad * scale + momentum * mom)
    params.sub_(lr * mom)


def kernel_clip_scale(partial: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """:func:`clip_scale` in the kernel's order of operations: the partials
    summed one after another, then one correctly rounded division
    (``clip_scale`` sums in PyTorch's order and multiplies by a
    reciprocal, so the two may differ in their last bits)."""
    if not clip_norm > 0:
        return clip_scale(partial, clip_norm)
    n2 = partial[:, 0].clone()
    for i in range(1, partial.shape[1]):
        n2 = n2 + partial[:, i]
    return torch.full_like(n2, clip_norm) / torch.clamp_min(n2.sqrt(),
                                                            clip_norm)


def ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of f32 at |t|."""
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def sgd_update_bounds(grad, mom_ref, params_ref, partial, *, lr, clip_norm):
    """How far :func:`client_sgd_update`'s m and p may lie from those of
    its plain version (``mom_ref``, ``params_ref``), element by element.
    Both round each operation alone and differ only in the clip scale s
    (:func:`kernel_clip_scale`): g*s moves by |g| |s_k - s| plus one
    rounding of g*s, m by that plus one rounding of m, p by lr times m's
    bound plus one rounding of lr*m and one of p. Returns the bounds on
    |m - m_ref| and |p - p_ref|."""
    s_ref = clip_scale(partial, clip_norm).unsqueeze(1)
    ds = (kernel_clip_scale(partial, clip_norm).unsqueeze(1) - s_ref).abs()
    bound_m = grad.abs() * ds + ulp(grad * s_ref) + ulp(mom_ref)
    return bound_m, lr * bound_m + ulp(lr * mom_ref) + ulp(params_ref)


def client_sgd_update(params: torch.Tensor, mom: torch.Tensor,
                      grad: torch.Tensor, partial: torch.Tensor, *,
                      lr: float, momentum: float, clip_norm: float) -> None:
    """One SGD step of every client, IN PLACE on ``params`` and ``mom``
    ([C, D] f32): the clip scale s = clip / max(norm, clip) from the norm
    partials of :func:`client_sq_norm`, then m = g*s + momentum*m, then
    p = p - lr*m (``fused_kernel.py:447-479``; no weight decay).
    ``client_sgd_update.launches`` counts kernel launches."""
    if params.device.type == "cpu":
        return client_sgd_update_plain(params, mom, grad, partial, lr=lr,
                                       momentum=momentum, clip_norm=clip_norm)
    _check_rows(params, mom, grad)
    device = require_cuda(params, mom, grad, partial)
    c, d = params.shape
    if tuple(partial.shape) != (c, partial.shape[1]) \
            or not partial.is_contiguous():
        raise ValueError("partial must be a contiguous [C, P] tensor")
    blocks = max(1, -(-d // (_THREADS * UPDATE_PER_THREAD)))
    lib = _library()
    err = lib.mft_sgd_update(params.data_ptr(), mom.data_ptr(),
                             grad.data_ptr(), params.stride(0), d,
                             partial.data_ptr(), partial.shape[1], c,
                             float(lr), float(momentum),
                             float(clip_norm), blocks, device.index,
                             stream_of(params))
    check(lib, err, "client_sgd_update", "client_sgd")
    client_sgd_update.launches += 1


client_sgd_update.launches = 0
