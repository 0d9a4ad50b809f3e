"""Philox4x32-10 random bits: the port's generator for in-kernel dropout.

The JAX kernels draw dropout masks from the TPU's own generator
(``multimodal_fl_security_tpu/ops/fused_kernel.py:403-413``: reseed with
``(seed, c, s)``, draw, compare with ``uint32(keep * 2**32)``), and
``benchmarks/mosaic_probe.py::p_prng`` (K5) checks that a reseed reproduces
the bits. Those bits exist only on a TPU. The port uses Philox4x32-10 with
the Random123 constants instead (``csrc/philox.cuh``), a counter-based
generator: the same counter and key always give the same four words, so a
mask is regenerated in the backward pass, never stored.

Counter layout, fixed: for a mask of logical shape [C, B, F] at global SGD
step s, element (c, b, f) takes j = b*F + f, counter ``(j // 4, c, s,
stream)``, key ``(seed & 0xffffffff, seed >> 32)``, and word ``j % 4``.
Stream 0 is the dropout on fc1's input, stream 1 the one on fc1's output
(:data:`STREAM_FC1_IN`, :data:`STREAM_FC1_OUT`).

:func:`philox4x32_plain` is the generator in integer torch ops: the
32 x 32 -> 64-bit products are split into 16-bit halves, because an int64
product of two u32 values overflows; :func:`philox_bits_plain` gives the
bits of a [C, B, F] draw with it. :func:`philox_draw_twice` (the K5 probe
``prng_replay``) launches ``csrc/probe_prng.cu`` on a CUDA device, or
raises, and runs the plain generator on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import check, stream_of

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10
STREAM_FC1_IN = 0
STREAM_FC1_OUT = 1


def _mul_hi_lo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product of u32 ``a`` (int64
    tensor) and the u32 constant ``m``, from 16-bit halves: no partial
    product exceeds 2**33."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    ll = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi
    low = ll + ((mid & 0xFFFF) << 16)
    lo = low & MASK32
    hi = (a_hi * m_hi + (mid >> 16) + (low >> 32)) & MASK32
    return hi, lo


def philox4x32_plain(counter: torch.Tensor, key: Tuple[int, int]
                     ) -> torch.Tensor:
    """Philox4x32-10 of ``counter`` [..., 4] (int64 holding u32 words) under
    ``key`` (two u32): [..., 4] int64 words."""
    c0, c1, c2, c3 = (counter[..., i] & MASK32 for i in range(4))
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mul_hi_lo(c0, M0)
        hi1, lo1 = _mul_hi_lo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def seed_key(seed: int) -> Tuple[int, int]:
    """The 64-bit ``seed`` as Philox's key (low word, high word)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def _check(shape, step, stream):
    c, b, f = shape
    if min(c, b, f) <= 0 or not (0 <= step <= MASK32
                                 and 0 <= stream <= MASK32):
        raise ValueError(f"need a positive [C, B, F] and u32 step and stream, "
                         f"got {shape}, {step}, {stream}")


def philox_bits_plain(seed: int, shape: Tuple[int, int, int], step: int,
                      stream: int, device="cpu") -> torch.Tensor:
    """The words of a [C, B, F] draw at ``step`` on ``stream``: int64
    [C, B, F] holding u32 values, from :func:`philox4x32_plain`."""
    _check(shape, step, stream)
    c, b, f = shape
    n = b * f
    q = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    ctr = torch.stack(torch.broadcast_tensors(
        q[None, :], torch.arange(c, device=device)[:, None],
        torch.tensor(step, device=device), torch.tensor(stream,
                                                        device=device)),
        dim=-1)
    words = philox4x32_plain(ctr, seed_key(seed))   # [C, n/4, 4]
    return words.reshape(c, -1)[:, :n].reshape(c, b, f)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_prng")
    i, ptr = ctypes.c_int, ctypes.c_void_p
    lib.mft_philox_bits.argtypes = [ptr, ptr, ptr, ctypes.c_ulonglong] + \
        [i] * 6 + [ptr]
    lib.mft_philox_bits.restype = i
    lib.mft_probe_prng_error_string.argtypes = [i]
    lib.mft_probe_prng_error_string.restype = ctypes.c_char_p
    return lib


def philox_draw_twice_plain(seed: int, shape: Tuple[int, int, int],
                            step: int = 0, stream: int = 0, device="cpu"):
    """Plain version of :func:`philox_draw_twice`, on any ``device``: the
    plain generator, twice."""
    a = philox_bits_plain(seed, shape, step, stream, device)
    b = philox_bits_plain(seed, shape, step, stream, device)
    return a, b, (a == b).float()


def philox_draw_twice(seed: int, shape: Tuple[int, int, int], step: int = 0,
                      stream: int = 0, device="cuda"):
    """(first draw, the draw after a reseed, their equality as f32): the
    bits of a [C, B, F] draw as int64 [C, B, F], through the kernel of
    ``csrc/probe_prng.cu`` on a CUDA device, or
    :func:`philox_draw_twice_plain` on the CPU.
    ``philox_draw_twice.launches`` counts kernel launches."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_draw_twice_plain(seed, shape, step, stream, device)
    if device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA device, got {device}")
    _check(shape, step, stream)
    device = torch.device("cuda", torch.cuda.current_device()
                          if device.index is None else device.index)
    a = torch.empty(shape, dtype=torch.int64, device=device)
    b = torch.empty_like(a)
    eq = torch.empty(shape, dtype=torch.float32, device=device)
    lib = _library()
    err = lib.mft_philox_bits(a.data_ptr(), b.data_ptr(), eq.data_ptr(),
                              int(seed) & 0xFFFFFFFFFFFFFFFF, *shape, step,
                              stream, device.index, stream_of(a))
    check(lib, err, "philox_draw_twice", "probe_prng")
    philox_draw_twice.launches += 1
    return a, b, eq


philox_draw_twice.launches = 0


def keep_threshold(keep: float) -> int:
    """``uint32(keep * 2**32)``: a word below it keeps its element
    (``fused_kernel.py:408``); 2**32 keeps all at keep 1."""
    return int(keep * 2 ** 32)
