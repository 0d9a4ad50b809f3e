"""One strided gather for the layout probes (K5) and the probes' roll (K6).

Counterpart of the layout kernels of ``benchmarks/mosaic_probe.py`` (K5:
reshapes, rolls, the iota-masked select, lane slices, the transpose and the
broadcast) and of ``benchmarks/ad_in_kernel_probe.py::droll`` (K6).
:func:`gather` launches the hand-written kernel of ``csrc/probe_layout.cu``
for a CUDA tensor, or raises, and runs :func:`gather_plain` for a CPU
tensor. The probes' own plain versions are ``torch.roll``, slicing,
``permute`` and ``expand``; :func:`roll` is the roll built on the gather.

An output axis is an :class:`Axis`: its extent, the source dimension it
walks (``None`` broadcasts) and at what scale, a start, a roll (``shift``
modulo ``period``: ``torch.roll(x, s)`` is shift ``-s``, period ``n``), a
``limit`` past which the source reads as 0 (a slice written into zeros),
and a predicate ``keep=(mod, lo, hi)`` on the output index (an iota mask).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    check,
    require_cuda,
    stream_of,
)

MAX_AXES = 5


@dataclasses.dataclass(frozen=True)
class Axis:
    """One output axis of :func:`gather`; see the module doc."""

    n: int
    src: Optional[int] = None
    scale: int = 1
    start: int = 0
    shift: int = 0
    period: int = 0
    limit: int = -1
    keep: Optional[Tuple[int, int, int]] = None


class _Axis(ctypes.Structure):
    _fields_ = [(k, ctypes.c_longlong) for k in
                ("n", "stride", "start", "shift", "period", "limit", "mod",
                 "lo", "hi")]


class _Spec(ctypes.Structure):
    _fields_ = [("ax", _Axis * MAX_AXES), ("total", ctypes.c_longlong),
                ("ndim", ctypes.c_int), ("pad_", ctypes.c_int)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_layout")
    ptr = ctypes.c_void_p
    lib.mft_gather.argtypes = [ptr, ptr, ctypes.POINTER(_Spec),
                               ctypes.c_int, ctypes.c_int, ptr]
    lib.mft_gather.restype = ctypes.c_int
    lib.mft_probe_layout_error_string.argtypes = [ctypes.c_int]
    lib.mft_probe_layout_error_string.restype = ctypes.c_char_p
    return lib


def _strides(x: torch.Tensor, axes: Sequence[Axis]) -> list:
    if not 1 <= len(axes) <= MAX_AXES:
        raise ValueError(f"gather takes 1 to {MAX_AXES} axes, got {len(axes)}")
    return [0 if a.src is None else x.stride(a.src) * a.scale for a in axes]


def gather_plain(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Plain version of :func:`gather`: the same index arithmetic on index
    tensors, then one indexed read of ``x``'s storage."""
    strides = _strides(x, axes)
    nd = len(axes)
    off = torch.zeros((), dtype=torch.int64, device=x.device)
    live = torch.ones((), dtype=torch.bool, device=x.device)
    for d, (a, st) in enumerate(zip(axes, strides)):
        shape = [1] * nd
        shape[d] = a.n
        i = torch.arange(a.n, device=x.device).view(shape)
        t = i + a.shift
        if a.period > 0:
            t = torch.remainder(t, a.period)
        if a.limit >= 0:
            live = live & (t < a.limit)
        if a.keep is not None:
            mod, lo, hi = a.keep
            r = torch.remainder(i, mod)
            live = live & (r >= lo) & (r < hi)
        off = off + (a.start + t) * st
    off = torch.where(live, off, 0)  # dead positions read nothing
    flat = x.as_strided((int(off.max()) + 1,), (1,))
    return torch.where(live, flat[off], torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def gather(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """``out[i0, ..]`` over the output ``axes`` (shape ``[a.n for a in
    axes]``, contiguous, ``x``'s dtype): the element of ``x`` each axis'
    rule picks, or 0; see the module doc. ``gather.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return gather_plain(x, axes)
    if x.element_size() not in (2, 4):
        raise TypeError(f"gather copies 2- or 4-byte elements, got {x.dtype}")
    device = require_cuda(x)
    strides = _strides(x, axes)
    spec = _Spec()
    total = 1
    for d, (a, st) in enumerate(zip(axes, strides)):
        mod, lo, hi = a.keep if a.keep is not None else (0, 0, 0)
        spec.ax[d] = _Axis(a.n, st, a.start, a.shift, a.period, a.limit, mod,
                           lo, hi)
        total *= a.n
    spec.total, spec.ndim = total, len(axes)
    out = torch.empty([a.n for a in axes], dtype=x.dtype, device=device)
    lib = _library()
    err = lib.mft_gather(x.data_ptr(), out.data_ptr(), ctypes.byref(spec),
                         x.element_size(), device.index, stream_of(x))
    check(lib, err, "gather", "probe_layout")
    gather.launches += 1
    return out


gather.launches = 0


def identity_axes(x: torch.Tensor) -> list:
    """The axes that copy ``x`` as it is."""
    return [Axis(n, d) for d, n in enumerate(x.shape)]


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` through :func:`gather` (``pltpu.roll``'s
    direction: element i moves to i + shift)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    axes = identity_axes(x)
    axes[dim] = Axis(n, dim, shift=(-shift) % n, period=n)
    return gather(x, axes)
