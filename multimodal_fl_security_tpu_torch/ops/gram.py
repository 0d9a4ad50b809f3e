"""Centered Gram matrix of a client-stacked update matrix.

Counterpart of ``multimodal_fl_security_tpu/ops/pallas_kernels.py:58-121``
(``gram_pallas`` and ``pairwise_sq_dists_pallas``). :func:`gram` launches
the hand-written Hopper kernel ``csrc/gram.cu`` for a CUDA tensor and runs
:func:`gram_plain` for a CPU tensor. On a CUDA tensor it launches the kernel
or raises; it never gives way to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_fl_security_tpu_torch.ops import _build


def gram_plain(updates: torch.Tensor) -> torch.Tensor:
    """(U - mean)(U - mean)^T in f32: the plain version of the kernel."""
    centered = updates - updates.mean(dim=0, keepdim=True)
    return centered @ centered.T


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("gram")
    lib.mft_gram_splits.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.mft_gram_splits.restype = ctypes.c_int
    lib.mft_gram_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.mft_gram_f32.restype = ctypes.c_int
    lib.mft_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gram(updates: torch.Tensor) -> torch.Tensor:
    """Centered Gram matrix ``[C, C]`` (f32) of ``updates`` ``[C, D]`` (f32).

    A CUDA tensor goes through the kernel: the mean is taken here with
    ``torch.mean``, as ``gram_pallas`` takes it outside its kernel, and
    the kernel subtracts it while it streams U once, summing the products
    on the tensor cores in 3xTF32 (hi·hiᵀ + hi·loᵀ + lo·hiᵀ of each
    centered value's two TF32 parts, f32 sums). A CPU tensor goes
    through :func:`gram_plain`. ``gram.launches`` counts kernel launches.
    """
    if updates.dim() != 2 or updates.shape[0] == 0 or updates.shape[1] == 0:
        raise ValueError(
            f"gram needs a non-empty [C, D] matrix, got {tuple(updates.shape)}")
    if updates.dtype != torch.float32:
        raise TypeError(f"gram needs float32, got {updates.dtype}")
    if updates.device.type == "cpu":
        return gram_plain(updates)
    if updates.device.type != "cuda":
        raise ValueError(f"gram runs on CPU or CUDA, not {updates.device}")
    if not updates.is_contiguous():
        raise ValueError("the gram kernel needs a contiguous (row-major) U")

    c, d = updates.shape
    device = updates.device
    lib = _library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = lib.mft_gram_splits(c, d, sms)
    mean = updates.mean(dim=0)
    workspace = torch.empty((splits, c, c), dtype=torch.float32, device=device)
    out = torch.empty((c, c), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mft_gram_f32(
            updates.data_ptr(), mean.data_ptr(), workspace.data_ptr(),
            out.data_ptr(), c, d, splits, device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"gram kernel launch failed: cudaError {err} "
            f"({lib.mft_cuda_error_string(err).decode()})")
    gram.launches += 1
    return out


gram.launches = 0


def sq_dists_from_gram(g: torch.Tensor) -> torch.Tensor:
    """Squared distances from a centered Gram matrix: the diagonal, clamp
    and zero-diagonal epilogue of ``pallas_kernels.py:118-121``."""
    sq = torch.diagonal(g)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * g).clamp_min(0.0)
    return d2.fill_diagonal_(0.0)
