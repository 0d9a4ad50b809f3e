"""Per-client dense layers of SimpleCNN's local training (fc1 and fc2).

Counterpart of the fc1/fc2 parts of ``multimodal_fl_security_tpu/ops/
fused_kernel.py::fused_local_train`` (K4; ``fused_train.py:407-416`` and
their VJPs). :func:`dense_fwd` and :func:`dense_bwd` launch the hand-written
kernels of ``csrc/client_dense.cu`` for CUDA tensors, or raise, and run
their ``*_plain`` versions (``torch.bmm`` in f32) for CPU tensors.

Shapes: activations ``[C, rows, K]`` of any strides, weights ``[C, F, K]``
views of the flat parameter buffer (torch's ``[out, in]`` order, so fc1's
input axis is the pooled map's (c, h, w) flatten) and biases ``[C, F]``.
Weights are rounded to ``wdtype`` where the port's ``SimpleCNN.forward``
casts them; products accumulate in f32; outputs round once to their dtype.
``wdtype`` and the geometry pick the kernel, in the open, before the launch:
bf16 runs the tensor-core ``dense_fwd_tc`` and ``dense_bwd_tc``; f32 runs
``dense_fwd_tf32`` and ``dense_bwd_tf32`` (3xTF32 on the tensor cores) where
they take the call (fc1's geometry, see :func:`dense_fwd` and
:func:`dense_bwd`), the CUDA-core ``dense_fwd`` and ``dense_bwd`` otherwise
(fc2). The rule is the C entries' ``mft_dense_{fwd,bwd}_tf32_takes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multimodal_fl_security_tpu_torch.ops import _build
from multimodal_fl_security_tpu_torch.ops._launch import (
    DTYPE_CODES,
    MftView,
    check,
    count,
    require_cuda,
    stream_of,
    view,
)

_MAT_AXES = (0, 1, 2)      # (client, row, column)
_BIAS_AXES = (0, None, 1)  # (client, -, feature)
#: the rows and output features ``dense_bwd_tc`` takes (fc1: 32 and 128)
TC_BWD_MAX_ROWS, TC_BWD_MAX_F = 32, 128


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("client_dense")
    p = ctypes.POINTER(MftView)
    i = ctypes.c_int
    lib.mft_dense_fwd.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_void_p]
    lib.mft_dense_fwd.restype = i
    lib.mft_dense_fwd_tc.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_void_p]
    lib.mft_dense_fwd_tc.restype = i
    lib.mft_dense_bwd.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_void_p]
    lib.mft_dense_bwd.restype = i
    lib.mft_dense_bwd_tc.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_void_p]
    lib.mft_dense_bwd_tc.restype = i
    lib.mft_dense_fwd_tf32.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_void_p]
    lib.mft_dense_fwd_tf32.restype = i
    lib.mft_dense_fwd_tf32_takes.argtypes = [p] * 2 + [i] * 5
    lib.mft_dense_fwd_tf32_takes.restype = i
    lib.mft_dense_bwd_tf32.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_void_p]
    lib.mft_dense_bwd_tf32.restype = i
    lib.mft_dense_bwd_tf32_takes.argtypes = [p] * 5 + [i] * 6
    lib.mft_dense_bwd_tf32_takes.restype = i
    lib.mft_client_dense_error_string.argtypes = [i]
    lib.mft_client_dense_error_string.restype = ctypes.c_char_p
    return lib


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _check(x, w, b):
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[2] or tuple(b.shape) != tuple(w.shape[:2]):
        raise ValueError(f"need x [C, rows, K], w [C, F, K] and b [C, F], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")


def dense_fwd_plain(x, w, b, *, relu=False, wdtype=torch.float32,
                    out_dtype=torch.float32):
    """Plain version of :func:`dense_fwd`."""
    _check(x, w, b)
    y = torch.baddbmm(_round(b, wdtype).unsqueeze(1), x.float(),
                      _round(w, wdtype).transpose(1, 2))
    return (torch.relu(y) if relu else y).to(out_dtype)


def dense_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              relu: bool = False, wdtype: torch.dtype = torch.float32,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y = x W^T + b`` per client, then relu if asked: [C, rows, F] in
    ``out_dtype``. ``wdtype`` bf16 runs the tensor-core kernel
    ``dense_fwd_tc``, which takes ``x`` in bf16 only (any other x raises: it
    never drops to the CUDA-core kernel). ``wdtype`` f32 runs
    ``dense_fwd_tf32`` (3xTF32) when it takes the call, chosen before the
    launch: x and w f32, K a multiple of 8, F a multiple of 64, x's rows
    16-byte aligned and w's 8-byte aligned, each with a contiguous last axis
    (fc1: K = 3,136, F = 128, w a view of the flat buffer); else the
    CUDA-core kernel ``dense_fwd`` (fc2: F = 10). ``dense_fwd.launches``
    counts the launches of all three, :data:`~._launch.KERNEL_LAUNCHES` each
    one's."""
    if x.device.type == "cpu":
        return dense_fwd_plain(x, w, b, relu=relu, wdtype=wdtype,
                               out_dtype=out_dtype)
    _check(x, w, b)
    device = require_cuda(x, w, b)
    tc = wdtype == torch.bfloat16
    if tc and x.dtype != torch.bfloat16:
        raise ValueError(f"dense_fwd with wdtype bf16 runs on the tensor-core "
                         f"kernel, which takes x in bf16; got {x.dtype}")
    c, rows, k = x.shape
    f = w.shape[1]
    y = torch.empty((c, rows, f), dtype=out_dtype, device=device)
    lib = _library()
    views = [view(x, _MAT_AXES), view(w, _MAT_AXES), view(b, _BIAS_AXES),
             view(y, _MAT_AXES)]
    refs = [ctypes.byref(v) for v in views]
    if tc:
        kernel = "dense_fwd_tc"
        err = lib.mft_dense_fwd_tc(*refs, c, rows, k, f, int(relu),
                                   device.index, stream_of(x))
    elif lib.mft_dense_fwd_tf32_takes(refs[0], refs[1], c, rows, k, f,
                                      DTYPE_CODES[wdtype]):
        kernel = "dense_fwd_tf32"
        err = lib.mft_dense_fwd_tf32(*refs, c, rows, k, f, int(relu),
                                     device.index, stream_of(x))
    else:
        kernel = "dense_fwd"
        err = lib.mft_dense_fwd(*refs, c, rows, k, f, int(relu),
                                DTYPE_CODES[wdtype], device.index,
                                stream_of(x))
    check(lib, err, kernel, "client_dense")
    count(kernel)
    dense_fwd.launches += 1
    return y


dense_fwd.launches = 0


def dense_bwd_plain(dz, x, w, gw, gb, *, mask=None, wdtype=torch.float32,
                    gdtype=torch.float32, dx_dtype=torch.float32):
    """Plain version of :func:`dense_bwd`."""
    dzf = dz.float()
    gw.copy_(_round(torch.bmm(dzf.transpose(1, 2), x.float()), gdtype))
    gb.copy_(_round(dzf.sum(dim=1), gdtype))
    dx = torch.bmm(dzf, _round(w, wdtype))
    if mask is not None:
        dx = torch.where(mask.float() > 0, _round(dx, dx_dtype),
                         torch.zeros((), device=dx.device))
    return dx.to(dx_dtype)


def dense_bwd(dz: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              gw: torch.Tensor, gb: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              wdtype: torch.dtype = torch.float32,
              gdtype: torch.dtype = torch.float32,
              dx_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Backward of ``z = x W^T + b`` from ``dz`` [C, rows, F]: writes dW
    (``gw`` [C, F, K]) and db (``gb`` [C, F]), rounded to ``gdtype``, into
    the f32 gradient buffer's views, and returns dx = dz W [C, rows, K] in
    ``dx_dtype``, times ``mask > 0`` (the previous layer's relu) when a mask
    is given. ``wdtype`` bf16 runs the tensor-core kernel ``dense_bwd_tc``,
    which takes dz and x in bf16, rows <= 32 and F <= 128 only (any other
    call raises: it never drops to the CUDA-core kernel). ``wdtype`` f32
    runs ``dense_bwd_tf32`` (3xTF32) when it takes the call, chosen before
    the launch: ``gdtype`` and ``dx_dtype`` f32 too, dz, x and w f32, rows
    <= 32, F 64 or 128, K a multiple of 8, dz's and x's rows 16-byte aligned
    and w's, dW's and dx's 8-byte aligned, each with a contiguous last axis
    (fc1); else the CUDA-core kernel ``dense_bwd`` (fc2: F = 10).
    ``dense_bwd.launches`` counts the launches of all three,
    :data:`~._launch.KERNEL_LAUNCHES` each one's."""
    if dz.device.type == "cpu":
        return dense_bwd_plain(dz, x, w, gw, gb, mask=mask, wdtype=wdtype,
                               gdtype=gdtype, dx_dtype=dx_dtype)
    _check(x, w, gb)
    if gw.dtype != torch.float32 or gb.dtype != torch.float32:
        raise TypeError("gradients are written into f32 buffers")
    device = require_cuda(dz, x, w, gw, gb,
                          *([mask] if mask is not None else []))
    c, rows, k = x.shape
    f = w.shape[1]
    tc = wdtype == torch.bfloat16
    if tc and (dz.dtype != torch.bfloat16 or x.dtype != torch.bfloat16
               or rows > TC_BWD_MAX_ROWS or f > TC_BWD_MAX_F):
        raise ValueError(
            f"dense_bwd with wdtype bf16 runs on the tensor-core kernel, "
            f"which takes dz and x in bf16, rows <= {TC_BWD_MAX_ROWS} and "
            f"F <= {TC_BWD_MAX_F}; got dz {dz.dtype}, x {x.dtype}, rows "
            f"{rows}, F {f}")
    dx = torch.empty((c, rows, k), dtype=dx_dtype, device=device)
    lib = _library()
    views = [view(dz, _MAT_AXES), view(x, _MAT_AXES), view(w, _MAT_AXES),
             view(mask, _MAT_AXES), view(gw, _MAT_AXES),
             view(gb, _BIAS_AXES), view(dx, _MAT_AXES)]
    refs = [ctypes.byref(v) for v in views]
    if tc:
        kernel = "dense_bwd_tc"
        err = lib.mft_dense_bwd_tc(*refs, c, rows, k, f, DTYPE_CODES[gdtype],
                                   device.index, stream_of(dz))
    elif lib.mft_dense_bwd_tf32_takes(
            refs[0], refs[1], refs[2], refs[4], refs[6], c, rows, k, f,
            DTYPE_CODES[wdtype], DTYPE_CODES[gdtype]):
        kernel = "dense_bwd_tf32"
        err = lib.mft_dense_bwd_tf32(*refs, c, rows, k, f, device.index,
                                     stream_of(dz))
    else:
        kernel = "dense_bwd"
        err = lib.mft_dense_bwd(*refs, c, rows, k, f, DTYPE_CODES[wdtype],
                                DTYPE_CODES[gdtype], device.index,
                                stream_of(dz))
    check(lib, err, kernel, "client_dense")
    count(kernel)
    dense_bwd.launches += 1
    return dx


dense_bwd.launches = 0
