"""Per-client inverted dropout with its mask drawn in the kernel (K4).

Counterpart of the dropout of ``multimodal_fl_security_tpu/ops/
fused_kernel.py::fused_local_train`` (``:403-413``). :func:`dropout_apply`
launches the hand-written kernel of ``csrc/client_dropout.cu`` for a CUDA
tensor, or raises, and runs :func:`dropout_apply_plain` for a CPU tensor.

The mask of client c at global SGD step s on ``stream`` is a pure function
of ``(seed, c, s, stream)`` (``ops/philox.py``'s counter layout): a word
below ``uint32(keep * 2**32)`` keeps its element. As in the JAX kernel, the
mask is 1/keep where kept, computed in the compute dtype, and multiplies
the activation in that dtype; the backward multiplies the gradient by the
same regenerated mask.

:func:`drawn_dropout` takes its mask from data instead: uniforms ``u``
[C, B, F] that the round's generator drew (:class:`RoundDraws`). It keeps
an element where ``u < keep`` and divides it by ``keep``, as the models'
dropout (``x / keep``) does on the CPU (on CUDA PyTorch multiplies by the
f32 reciprocal instead, at most a rounding apart); the backward applies the
same ``u`` to the gradient. :class:`PhiloxDropout` and :class:`RoundDraws`
are the draws that ``rounds/local_train.py::train_clients`` takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    MftView,
    check,
    require_cuda,
    stream_of,
    view,
)
from multimodal_fl_security_tpu_torch.ops.philox import (
    STREAM_FC1_IN,
    STREAM_FC1_OUT,
    keep_threshold,
    philox_bits_plain,
)

_AXES = (0, 1, 2)  # (client, sample, feature)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("client_dropout")
    p = ctypes.POINTER(MftView)
    i, u64 = ctypes.c_int, ctypes.c_ulonglong
    lib.mft_dropout.argtypes = [p, p, u64, i, i, i, i, i, u64,
                                ctypes.c_float, i, ctypes.c_void_p]
    lib.mft_dropout.restype = i
    lib.mft_drawn_dropout.argtypes = [p, ctypes.c_void_p, p, i, i, i,
                                      ctypes.c_float, i, ctypes.c_void_p]
    lib.mft_drawn_dropout.restype = i
    lib.mft_client_dropout_error_string.argtypes = [i]
    lib.mft_client_dropout_error_string.restype = ctypes.c_char_p
    return lib


def check_rate(rate: float) -> float:
    """The keep probability of a dropout ``rate`` in [0, 1); raises
    otherwise."""
    if not 0.0 <= float(rate) < 1.0:
        raise ValueError(f"dropout rates must lie in [0, 1), got {rate}")
    return 1.0 - float(rate)


def mask_scale(keep: float, dtype: torch.dtype) -> float:
    """1/keep computed in ``dtype``, as ``fused_kernel.py:408-409`` divides."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(keep, dtype=dtype))


def dropout_mask_plain(seed: int, shape, step: int, stream: int,
                       keep: float, dtype: torch.dtype,
                       device="cpu") -> torch.Tensor:
    """The mask [C, B, F] in ``dtype``: 1/keep where the word keeps the
    element, else 0, from the plain generator."""
    bits = philox_bits_plain(seed, tuple(shape), step, stream, device)
    kept = (bits < keep_threshold(keep)).to(dtype)
    return kept / torch.tensor(keep, dtype=dtype, device=device)


def dropout_apply_plain(x, *, seed, step, stream, keep, dtype):
    """Plain version of :func:`dropout_apply`."""
    m = dropout_mask_plain(seed, x.shape, step, stream, keep, dtype,
                           x.device)
    return x.to(dtype) * m


def dropout_apply(x: torch.Tensor, *, seed: int, step: int, stream: int,
                  keep: float, dtype: torch.dtype) -> torch.Tensor:
    """``x`` [C, B, F] (any strides, in ``dtype``) times its client's mask
    at global step ``step`` on ``stream``: a new contiguous [C, B, F] in
    ``dtype``. ``dropout_apply.launches`` counts kernel launches."""
    if x.dim() != 3:
        raise ValueError(f"need x [C, B, F], got {tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout runs in f32 or bf16, got {dtype}")
    if x.device.type == "cpu":
        return dropout_apply_plain(x, seed=seed, step=step, stream=stream,
                                   keep=keep, dtype=dtype)
    if x.dtype != dtype:
        raise TypeError(f"x must be in the compute dtype {dtype}, got "
                        f"{x.dtype}")
    device = require_cuda(x)
    c, b, f = x.shape
    y = torch.empty((c, b, f), dtype=dtype, device=device)
    lib = _library()
    err = lib.mft_dropout(ctypes.byref(view(x, _AXES)),
                          ctypes.byref(view(y, _AXES)),
                          int(seed) & 0xFFFFFFFFFFFFFFFF, c, b, f, step,
                          stream, keep_threshold(keep),
                          mask_scale(keep, dtype), device.index,
                          stream_of(x))
    check(lib, err, "dropout_apply", "client_dropout")
    dropout_apply.launches += 1
    return y


dropout_apply.launches = 0


def drawn_dropout_plain(x, u, *, keep, dtype):
    """Plain version of :func:`drawn_dropout`: the division in f32 by a
    device tensor, so that CUDA divides too (a Python divisor would be
    multiplied by its reciprocal there)."""
    keep_t = torch.tensor(keep, dtype=torch.float32, device=x.device)
    y = torch.where(u < keep, x.float() / keep_t, 0.0)
    return y.to(dtype)


def drawn_dropout(x: torch.Tensor, u: torch.Tensor, *, keep: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """``x`` [C, B, F] (any strides, in ``dtype``) where the drawn uniform
    ``u`` [C, B, F] (f32, contiguous) is below ``keep``, divided by
    ``keep``, else 0: a new contiguous [C, B, F] in ``dtype``.
    ``drawn_dropout.launches`` counts kernel launches."""
    if x.dim() != 3 or u.shape != x.shape:
        raise ValueError(f"need x and u [C, B, F], got {tuple(x.shape)} and "
                         f"{tuple(u.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout runs in f32 or bf16, got {dtype}")
    if x.device.type == "cpu":
        return drawn_dropout_plain(x, u, keep=keep, dtype=dtype)
    if x.dtype != dtype or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise TypeError(f"x must be in the compute dtype {dtype} and u a "
                        f"contiguous f32 tensor, got {x.dtype} and {u.dtype}")
    device = require_cuda(x, u)
    c, b, f = x.shape
    y = torch.empty((c, b, f), dtype=dtype, device=device)
    lib = _library()
    err = lib.mft_drawn_dropout(ctypes.byref(view(x, _AXES)), u.data_ptr(),
                                ctypes.byref(view(y, _AXES)), c, b, f,
                                float(keep), device.index, stream_of(x))
    check(lib, err, "drawn_dropout", "client_dropout")
    drawn_dropout.launches += 1
    return y


drawn_dropout.launches = 0

#: the Philox stream of each of fc1's two dropout layers (input, output)
_STREAMS = (STREAM_FC1_IN, STREAM_FC1_OUT)


class PhiloxDropout(NamedTuple):
    """K4's draws (``fused_local_train``): each client's rows as they lie,
    and with ``keeps`` (each layer's keep probability; () drops nothing)
    fc1's two masks of global SGD step ``step``, drawn inside the kernel
    from Philox under ``seed``, forward and backward alike."""

    seed: int
    keeps: Tuple[float, ...]
    step: int = 0

    def order(self, mask):
        return None

    def masks(self, step):
        return self._replace(step=step) if self.keeps else None

    def apply(self, t, layer, dtype):
        return dropout_apply(t, seed=self.seed, step=self.step,
                             stream=_STREAMS[layer], keep=self.keeps[layer],
                             dtype=dtype)

    again = apply


class RoundDraws:
    """The round's draws from its generator, as the benchmark's reference
    replays them: each epoch ``torch.rand([C, N]).argsort(dim=1)``; each
    step, at each dropout layer above rate 0 in forward order,
    ``torch.rand(t.shape) < keep`` (kept elements divided by keep). Models
    call ``draws(t, layer)``; the kernel step :meth:`apply`, then
    :meth:`again` on the same uniforms in its backward."""

    def __init__(self, generator: torch.Generator, rates):
        if generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        self.generator = generator
        self.keeps = tuple(check_rate(r) for r in rates)
        self.uniforms: List[Optional[torch.Tensor]] = [None] * len(rates)

    def order(self, mask):
        return torch.rand(mask.shape, generator=self.generator,
                          device=mask.device).argsort(dim=1)

    def masks(self, step):
        return self

    def _draw(self, t, layer):
        self.uniforms[layer] = None if self.keeps[layer] == 1.0 else \
            torch.rand(t.shape, generator=self.generator, device=t.device)
        return self.uniforms[layer]

    def __call__(self, t, layer):
        u, keep = self._draw(t, layer), self.keeps[layer]
        if u is None:
            return t
        return torch.where(u < keep, t / keep, torch.zeros(
            (), dtype=t.dtype, device=t.device))

    def apply(self, t, layer, dtype):
        self._draw(t, layer)
        return self.again(t, layer, dtype)

    def again(self, t, layer, dtype):
        u = self.uniforms[layer]
        return t if u is None else drawn_dropout(t, u, keep=self.keeps[layer],
                                                 dtype=dtype)
