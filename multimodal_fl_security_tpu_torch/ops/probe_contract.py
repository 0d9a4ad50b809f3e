"""One batched strided contraction for the probes' dots (K5 and K6).

Counterpart of the ``dot_general`` kernels of ``benchmarks/mosaic_probe.py``
(K5) and ``benchmarks/ad_in_kernel_probe.py`` (K6). :func:`contract`
launches the hand-written kernel of ``csrc/probe_contract.cu`` for CUDA
tensors, or raises, and runs :func:`contract_plain` (``torch.einsum`` in
f32) for CPU tensors.

``a`` is ``[batch, m, k]`` and ``b`` ``[batch, k, n]``, views of any strides
(a transpose, a permute, an ``expand`` over the batch axis); the k axis may
be two axes, ``a`` ``[batch, m, ko, ki]`` with ``b`` ``[batch, ko, ki, n]``,
when they do not merge into one stride. Operands are f32 or bf16; products
and sums are f32, over k in a fixed order.

A block of the kernel computes a 64 x 64 tile of the output. When the
tiles of a call are too few to fill the card, :func:`plan_splits` cuts k
into chunks, from the shape alone: each block sums one chunk, and a second
kernel adds the chunks' partials in chunk order, so two calls are bitwise
equal.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    DTYPE_CODES,
    check,
    require_cuda,
    stream_of,
)


class _Operand(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sx", ctypes.c_longlong), ("sko", ctypes.c_longlong),
                ("ski", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("pad_", ctypes.c_int)]


#: the kernel's output tile (rows and columns) and its k-slice
TILE, TILE_K = 64, 16
#: the H100's SMs: a call of fewer tiles splits k
SMS = 132
#: blocks a split call aims at: two for each SM
TARGET_BLOCKS = 2 * SMS


def plan_splits(batch: int, m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits, chunk) for a ``[batch, m, k] x [batch, k, n]`` call: k is
    cut into ``splits`` chunks of ``chunk`` (the last may be shorter, none is
    empty), in order. One chunk (``chunk = k``) when the call's tiles fill
    the card; else about :data:`TARGET_BLOCKS` blocks, each chunk a multiple
    of :data:`TILE_K`. Depends on the shape alone."""
    tiles = batch * math.ceil(m / TILE) * math.ceil(n / TILE)
    if tiles >= SMS or k <= TILE_K:
        return 1, k
    want = math.ceil(TARGET_BLOCKS / tiles)
    chunk = math.ceil(math.ceil(k / want) / TILE_K) * TILE_K
    return math.ceil(k / chunk), chunk


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_contract")
    i = ctypes.c_int
    lib.mft_contract.argtypes = [ctypes.POINTER(_Operand)] * 2 + [
        ctypes.c_void_p] * 2 + [i] * 8 + [ctypes.c_void_p]
    lib.mft_contract.restype = i
    lib.mft_probe_contract_error_string.argtypes = [i]
    lib.mft_probe_contract_error_string.restype = ctypes.c_char_p
    return lib


def _shapes(a: torch.Tensor, b: torch.Tensor):
    """(batch, m, n, ko, ki) of a valid pair; raises otherwise."""
    split = a.dim() == 4
    ok = a.dim() in (3, 4) and b.dim() == a.dim() and a.shape[0] == b.shape[0]
    if ok:
        ka = tuple(a.shape[2:])
        kb = tuple(b.shape[1:-1])
        ok = ka == kb
    if not ok:
        raise ValueError("need a [batch, m, k] and b [batch, k, n] (or k as "
                         f"two axes), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    ko, ki = (a.shape[2], a.shape[3]) if split else (1, a.shape[2])
    return a.shape[0], a.shape[1], b.shape[-1], ko, ki


def contract_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`contract`."""
    _shapes(a, b)
    eq = "bmpq,bpqn->bmn" if a.dim() == 4 else "bmk,bkn->bmn"
    return torch.einsum(eq, a.float(), b.float())


def contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[b, m, n] = sum_k A[b, m, k] B[b, k, n]`` as a new contiguous f32
    ``[batch, m, n]``; see the module doc. ``contract.launches`` counts
    kernel launches (a split call's two kernels as one), and
    ``contract.plans`` maps each shape launched, ``(batch, m, n, k)``, to its
    ``(splits, chunk)``."""
    if a.device.type == "cpu":
        return contract_plain(a, b)
    batch, m, n, ko, ki = _shapes(a, b)
    for t in (a, b):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"contract takes f32 or bf16 operands, got "
                            f"{t.dtype}")
    device = require_cuda(a, b)
    split = a.dim() == 4
    sa, sb = a.stride(), b.stride()
    op_a = _Operand(a.data_ptr(), sa[0], sa[1], sa[2] if split else 0,
                    sa[-1], DTYPE_CODES[a.dtype])
    op_b = _Operand(b.data_ptr(), sb[0], sb[-1], sb[1] if split else 0,
                    sb[-2], DTYPE_CODES[b.dtype])
    k = ko * ki
    splits, chunk = plan_splits(batch, m, n, k)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=device)
    scratch = torch.empty((splits, batch, m, n), dtype=torch.float32,
                          device=device) if splits > 1 else None
    lib = _library()
    err = lib.mft_contract(ctypes.byref(op_a), ctypes.byref(op_b),
                           out.data_ptr(),
                           scratch.data_ptr() if splits > 1 else None, batch,
                           m, n, k, ki, chunk, splits, device.index,
                           stream_of(a))
    check(lib, err, "contract", "probe_contract")
    contract.launches += 1
    contract.plans[batch, m, n, k] = (splits, chunk)
    return out


contract.launches = 0
contract.plans = {}
