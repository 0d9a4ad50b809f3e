"""Coordinate-wise sorted reduction over the client axis: median or trimmed mean.

Counterpart of ``multimodal_fl_security_tpu/ops/pallas_kernels.py:125-220``
(``sorted_reduce_pallas``). :func:`sorted_reduce` launches the hand-written
Hopper kernel ``csrc/sorted_reduce.cu`` for a CUDA tensor and runs
:func:`sorted_reduce_plain` for a CPU tensor. On a CUDA tensor it launches
the kernel or raises; it never gives way to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_fl_security_tpu_torch.ops import _build

MODES = {"median": 0, "trimmed": 1}


def sorted_reduce_plain(updates: torch.Tensor, mode: str = "median",
                        trim: int = 1) -> torch.Tensor:
    """``torch.sort`` over the client axis, then the lower-middle row
    ((C-1)//2) or the mean of rows [trim, C-trim): the plain version of the
    kernel."""
    c = updates.shape[0]
    srt = torch.sort(updates, dim=0).values
    if mode == "median":
        return srt[(c - 1) // 2]
    return srt[trim:c - trim].mean(dim=0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sorted_reduce")
    lib.mft_sorted_reduce_max_c.argtypes = []
    lib.mft_sorted_reduce_max_c.restype = ctypes.c_int
    lib.mft_sorted_reduce_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mft_sorted_reduce_f32.restype = ctypes.c_int
    lib.mft_sorted_reduce_error_string.argtypes = [ctypes.c_int]
    lib.mft_sorted_reduce_error_string.restype = ctypes.c_char_p
    return lib


def sorted_reduce(updates: torch.Tensor, mode: str = "median",
                  trim: int = 1) -> torch.Tensor:
    """Per-column median (``mode="median"``, lower middle for even C) or
    trimmed mean over sorted rows [trim, C-trim) (``mode="trimmed"``) of
    ``updates`` ``[C, D]`` (f32) -> ``[D]`` (f32).

    A CUDA tensor goes through the kernel, which reads U once and takes any
    D and C up to ``mft_sorted_reduce_max_c()`` (1024); a CPU tensor through
    :func:`sorted_reduce_plain`. ``sorted_reduce.launches`` counts kernel
    launches.
    """
    if updates.dim() != 2 or updates.shape[0] == 0 or updates.shape[1] == 0:
        raise ValueError("sorted_reduce needs a non-empty [C, D] matrix, got "
                         f"{tuple(updates.shape)}")
    if updates.dtype != torch.float32:
        raise TypeError(f"sorted_reduce needs float32, got {updates.dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    c, d = updates.shape
    if mode == "trimmed" and not 0 <= 2 * trim < c:
        raise ValueError(f"trim {trim} leaves no rows of C={c}")
    if updates.device.type == "cpu":
        return sorted_reduce_plain(updates, mode, trim)
    if updates.device.type != "cuda":
        raise ValueError(f"sorted_reduce runs on CPU or CUDA, not "
                         f"{updates.device}")
    if not updates.is_contiguous():
        raise ValueError("the sorted_reduce kernel needs a contiguous "
                         "(row-major) U")

    lib = _library()
    max_c = lib.mft_sorted_reduce_max_c()
    if c > max_c:
        raise ValueError(f"the sorted_reduce kernel takes C <= {max_c}, "
                         f"got C={c}")
    device = updates.device
    out = torch.empty((d,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mft_sorted_reduce_f32(
            updates.data_ptr(), out.data_ptr(), c, d, MODES[mode], trim,
            device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"sorted_reduce kernel launch failed: cudaError {err} "
            f"({lib.mft_sorted_reduce_error_string(err).decode()})")
    sorted_reduce.launches += 1
    return out


sorted_reduce.launches = 0
