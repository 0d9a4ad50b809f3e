"""Per-client convolutions of SimpleCNN's local training, and K3's stem conv.

Counterpart of ``multimodal_fl_security_tpu/ops/client_conv.py``
(``client_stem_conv``, K3) and of the convolution parts of
``ops/fused_kernel.py::fused_local_train`` (K4; ``fused_train.py::
forward_impl``'s stem and conv2 and their gradients). Every wrapper here
launches a hand-written kernel of ``csrc/client_conv.cu`` (or, for K3,
``csrc/client_stem_raw.cu``) for CUDA tensors, or raises, and runs its
``*_plain`` version for CPU tensors.

Tensors are passed as logical ``[C, B, channels, rows, cols]`` views of any
strides (a step's batch of the resident images, an NHWC map permuted to
this order), and weights as ``[C, C_out, C_in, K, K]`` views of the flat
parameter buffer, so nothing is copied into a kernel's layout.

The pooled epilogue (``pool=True``) is the stem in the JAX package's
ConvPoolFused form: a 3x3 SAME convolution evaluated at the four offsets
of each 2x2 window equals the 4x4 stride-2 convolution on the embedded
kernel ``w4`` (``models/simple_cnn.py:22-70`` of the JAX package;
:func:`embed_stem` here), and the window max equals the max over w4's four
channel groups. Then bias and relu. Ties in the max go to the first
position in (di, dj) order, in the kernel and in the plain version alike
(``max_pool2d``'s convention); JAX's ``reduce_max`` VJP would split the
gradient between tied positions. A 2-bit argmax (one byte) per output
carries the choice to the backward kernels.

Rounding: operands are rounded to the compute dtype (bf16 or f32) where
the port's ``SimpleCNN.forward`` casts them, products accumulate in f32,
and each output is rounded once to the compute dtype; weight gradients are
rounded to it too and stored in the f32 gradient buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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

#: the logical axes of a [C, B, ch, rows, cols] tensor, in MftView's order
_IMAGE_AXES = (0, 1, 2, 3, 4)
#: a [C, C_out, C_in, K, K] weight: (client, out, in, kh, kw)
_WEIGHT_AXES = (0, 1, 2, 3, 4)
#: a [C, C_out] bias: (client, -, channel)
_BIAS_AXES = (0, None, 1)


class ConvGeom(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "cin", "h", "w", "cout", "k", "stride", "pad", "oh", "ow",
        "pool", "cdt")]


class ConvArgs(ctypes.Structure):
    _fields_ = [("clients", ctypes.c_int), ("g", ConvGeom)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("client_conv")
    p = ctypes.POINTER(MftView)
    args = ctypes.POINTER(ConvArgs)
    for name, n_views in (("mft_conv_fwd", 3), ("mft_conv_fwd_tc", 5),
                          ("mft_conv2_fwd_tf32", 5), ("mft_stem_fwd_f32", 5),
                          ("mft_conv_wgrad_tc", 6), ("mft_conv_dgrad_tc", 5),
                          ("mft_conv2_wgrad_tf32", 6),
                          ("mft_stem_wgrad_tf32", 6),
                          ("mft_conv2_dgrad_tf32", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_views + [args, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mft_conv_tc_kind.argtypes = [args, p, p]
    lib.mft_conv_tc_kind.restype = ctypes.c_int
    lib.mft_conv_fwd_tc_kind.argtypes = [args, p]
    lib.mft_conv_fwd_tc_kind.restype = ctypes.c_int
    for takes in (lib.mft_conv2_wgrad_tf32_takes,
                  lib.mft_conv2_dgrad_tf32_takes,
                  lib.mft_conv2_fwd_tf32_takes):
        takes.argtypes = [args]
        takes.restype = ctypes.c_int
    for takes in (lib.mft_stem_fwd_f32_takes,
                  lib.mft_stem_wgrad_tf32_takes):
        takes.argtypes = [args, p]
        takes.restype = ctypes.c_int
    lib.mft_client_conv_error_string.argtypes = [ctypes.c_int]
    lib.mft_client_conv_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _stem_raw_library() -> ctypes.CDLL:
    lib = _build.load("client_stem_raw")
    p = ctypes.POINTER(MftView)
    args = ctypes.POINTER(ConvArgs)
    for kernel in ("stem_raw_tc", "stem_raw_tf32"):
        fn = getattr(lib, f"mft_{kernel}")
        fn.argtypes = [p] * 3 + [args, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        takes = getattr(lib, f"mft_{kernel}_takes")
        takes.argtypes = [args, p]
        takes.restype = ctypes.c_int
    lib.mft_client_stem_raw_error_string.argtypes = [ctypes.c_int]
    lib.mft_client_stem_raw_error_string.restype = ctypes.c_char_p
    return lib


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, as f32."""
    return t.to(dtype).float()


def _alloc(shape, dtype, device, channels_last: bool) -> torch.Tensor:
    """An empty logical [C, B, ch, rows, cols] tensor, stored NHWC
    (channels fastest) when ``channels_last``, else NCHW."""
    c, b, ch, h, w = shape
    if channels_last:
        return torch.empty((c, b, h, w, ch), dtype=dtype,
                           device=device).permute(0, 1, 4, 2, 3)
    return torch.empty(shape, dtype=dtype, device=device)


def _out_hw(h: int, w: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def _geom(x_shape, w_shape, stride, pad, pool, dtype) -> ConvArgs:
    c, b, cin, h, w = x_shape
    oh, ow = _out_hw(h, w, w_shape[-1], stride, pad)
    return ConvArgs(c, ConvGeom(b, cin, h, w, w_shape[1], w_shape[-1], stride,
                                pad, oh, ow, int(pool), DTYPE_CODES[dtype]))


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """[C, B, ch, H, W] -> [B, C*ch, H, W] (client-major channels)."""
    c, b, ch, h, w = x.shape
    return x.transpose(0, 1).reshape(b, c * ch, h, w)


def _ungrouped(y: torch.Tensor, clients: int) -> torch.Tensor:
    b, cc, h, w = y.shape
    return y.view(b, clients, cc // clients, h, w).transpose(0, 1)


def _check_conv(x, w, b, dtype):
    if x.dim() != 5 or w.dim() != 5 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[2] or w.shape[3] != w.shape[4]:
        raise ValueError(f"need x [C, B, C_in, H, W] and w [C, C_out, C_in, "
                         f"K, K], got {tuple(x.shape)} and {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != tuple(w.shape[:2]):
        raise ValueError(f"bias must be [C, C_out], got {tuple(b.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be f32 or bf16, got {dtype}")


# --------------------------------------------------------------- forward

def conv_fwd_plain(x, w, b, *, stride=1, pad=1, pool=True,
                   dtype=torch.float32, channels_last=False):
    """Plain version of :func:`conv_fwd`: grouped ``F.conv2d`` in f32 on the
    rounded operands, then (``pool``) the first-index window max, bias and
    relu."""
    _check_conv(x, w, b, dtype)
    c, bsz = x.shape[:2]
    cout = w.shape[1]
    z = _ungrouped(F.conv2d(_grouped(_round(x, dtype)),
                            _round(w, dtype).reshape(-1, *w.shape[2:]),
                            stride=stride, padding=pad, groups=c), c)
    oh, ow = z.shape[-2:]
    arg = None
    if pool:
        win = z.reshape(c, bsz, cout, oh // 2, 2, ow // 2, 2).permute(
            0, 1, 2, 3, 5, 4, 6).reshape(c, bsz, cout, oh // 2, ow // 2, 4)
        z, idx = win.max(dim=-1)  # the first maximum wins
        z = torch.relu(z + _round(b, dtype)[:, None, :, None, None])
        arg = _alloc(z.shape, torch.uint8, x.device, channels_last)
        arg.copy_(idx)
    out = _alloc(z.shape, dtype, x.device, channels_last)
    out.copy_(z)
    return out, arg


def conv_fwd(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
             stride: int = 1, pad: int = 1, pool: bool = True,
             dtype: torch.dtype = torch.float32, channels_last: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-client K x K convolution of ``x`` [C, B, C_in, H, W] with ``w``
    [C, C_out, C_in, K, K]. With ``pool``: then the 2x2 window max, ``b``
    [C, C_out] and relu, returning the pooled map [C, B, C_out, OH/2, OW/2]
    and its argmax (uint8, q = di*2 + dj); without: the raw output and None.
    Outputs are in ``dtype``, stored NHWC when ``channels_last``. Pooled,
    f32 runs ``conv2_fwd_tf32`` (3xTF32) or ``stem_fwd_f32`` (CUDA cores),
    bf16 ``conv2_fwd_tc`` or ``stem_fwd_tc`` (tensor cores); raw, f32 runs
    ``stem_raw_tf32`` (3xTF32) at K3's geometry and the CUDA-core
    ``conv_fwd`` off it, bf16 ``stem_raw_tc`` (see :func:`_fwd_kernel_for`).
    ``conv_fwd.launches`` counts the launches of all seven,
    :data:`~._launch.KERNEL_LAUNCHES` each one's."""
    if x.device.type == "cpu":
        return conv_fwd_plain(x, w, b, stride=stride, pad=pad, pool=pool,
                              dtype=dtype, channels_last=channels_last)
    _check_conv(x, w, b, dtype)
    device = require_cuda(x, w, *([b] if b is not None else []))
    a = _geom(x.shape, w.shape, stride, pad, pool, dtype)
    lib = _library()
    xv = view(x, _IMAGE_AXES)
    kernel = _fwd_kernel_for(lib, a, xv, channels_last)
    ph, pw = (a.g.oh // 2, a.g.ow // 2) if pool else (a.g.oh, a.g.ow)
    shape = (x.shape[0], x.shape[1], w.shape[1], ph, pw)
    out = _alloc(shape, dtype, device, channels_last)
    arg = _alloc(shape, torch.uint8, device, channels_last) if pool else None
    prefix = "client_conv"
    if pool:
        views = [xv, view(w, _WEIGHT_AXES), view(b, _BIAS_AXES),
                 view(out, _IMAGE_AXES), view(arg, _IMAGE_AXES)]
    else:
        views = [xv, view(w, _WEIGHT_AXES), view(out, _IMAGE_AXES)]
        if kernel != "conv_fwd":
            lib, prefix = _stem_raw_library(), "client_stem_raw"
    entry = "mft_conv_fwd_tc" if kernel.endswith("_fwd_tc") \
        else f"mft_{kernel}"
    err = getattr(lib, entry)(*[ctypes.byref(v) for v in views],
                              ctypes.byref(a), device.index, stream_of(x))
    check(lib, err, kernel, prefix)
    count(kernel)
    conv_fwd.launches += 1
    return out, arg


conv_fwd.launches = 0

#: csrc/client_conv.cu's TcKind: no tensor-core kernel, conv2's (2: the
#: stem's)
_TC_NONE, _TC_CONV2 = 0, 1


def _fwd_kernel_for(lib: ctypes.CDLL, a: ConvArgs, x: MftView,
                    channels_last: bool) -> str:
    """The forward kernel for ``a``, a route chosen here, before the
    launch. Raw (K3) at K3's geometry (4x4, stride 2, pad 1, 28x28x8 ->
    14x14x128, ``x`` in the compute dtype and NHWC with 16-byte aligned
    samples, the output NHWC): ``stem_raw_tf32`` for f32, ``stem_raw_tc``
    for bf16; any other raw f32 call runs the CUDA-core ``conv_fwd``.
    Pooled, a kernel that takes a 3x3 SAME stride-1 geometry with conv2's
    shape (32 -> 64 channels at 14x14), ``conv2_fwd_tf32`` in f32 and
    ``conv2_fwd_tc`` in bf16, or a stem's (1-8 -> 32 channels, ``x`` in
    f32), ``stem_fwd_f32`` and ``stem_fwd_tc``. Any other pooled call, and
    any other raw bf16 call, raises: it never drops to another kernel."""
    g = a.g
    f32 = g.cdt == DTYPE_CODES[torch.float32]
    if not g.pool:
        raw = "stem_raw_tf32" if f32 else "stem_raw_tc"
        if channels_last and getattr(_stem_raw_library(), f"mft_{raw}_takes")(
                ctypes.byref(a), ctypes.byref(x)):
            return raw
        if f32:
            return "conv_fwd"
        raise ValueError(
            f"conv_fwd raw in bf16 runs on the tensor-core kernel "
            f"stem_raw_tc, which takes K3's geometry only: 4x4, stride 2, "
            f"pad 1, 28x28x8 -> 14x14x128, x in bf16 and NHWC with 16-byte "
            f"aligned samples, the output NHWC; got {g.cin} -> {g.cout} at "
            f"{g.h}x{g.w}, k {g.k}, stride {g.stride}, pad {g.pad}, x dtype "
            f"code {x.dtype}, x strides {tuple(x.st)}, channels_last "
            f"{channels_last}")
    if f32:
        if lib.mft_conv2_fwd_tf32_takes(ctypes.byref(a)):
            return "conv2_fwd_tf32"
        if lib.mft_stem_fwd_f32_takes(ctypes.byref(a), ctypes.byref(x)):
            return "stem_fwd_f32"
        raise ValueError(
            f"conv_fwd pooled in f32 runs conv2_fwd_tf32, which takes a 3x3 "
            f"SAME stride-1 conv2 (32 -> 64 at 14x14), or stem_fwd_f32, "
            f"which takes a 3x3 SAME stride-1 stem (1-8 -> 32 at even sizes, "
            f"input in f32); got {g.cin} -> {g.cout} at {g.h}x{g.w}, k "
            f"{g.k}, stride {g.stride}, pad {g.pad}, x dtype code {x.dtype}")
    kind = lib.mft_conv_fwd_tc_kind(ctypes.byref(a), ctypes.byref(x))
    if kind == _TC_NONE:
        raise ValueError(
            f"conv_fwd pooled in bf16 runs on a tensor-core kernel, which "
            f"takes a 3x3 SAME stride-1 conv2 (32 -> 64 at 14x14) or stem "
            f"(1-8 -> 32, input in f32); got {g.cin} -> {g.cout} at "
            f"{g.h}x{g.w}, k {g.k}, stride {g.stride}, pad {g.pad}, x dtype "
            f"code {x.dtype}")
    return "conv2_fwd_tc" if kind == _TC_CONV2 else "stem_fwd_tc"


# --------------------------------------------------------------- backward


def _kernel_for(lib: ctypes.CDLL, a: ConvArgs, dp: MftView,
                x: Optional[MftView], wrapper: str) -> str:
    """The kernel that serves ``a``'s compute dtype, a route chosen here,
    before the launch. For f32 conv2's gradients (a pooled 3x3 SAME
    stride-1 geometry with conv2's shape, operands of any strides) run
    ``conv2_wgrad_tf32`` and ``conv2_dgrad_tf32`` in 3xTF32 on the tensor
    cores, and a stem's weight gradient (the same geometry at 1-8 -> 32
    channels, even sizes, ``x`` in f32) ``stem_wgrad_tf32``; any other f32
    call raises. For bf16 the tensor-core one, which takes a
    pooled 3x3 SAME stride-1 geometry with conv2's shape (32 -> 64 channels
    at 14x14) or, for the weight gradient only (``x`` the input's view,
    None for the input gradient), a stem's (1-8 -> 32 channels, its input
    in f32), and ``dp`` (its view) in bf16; any other bf16 call raises. No
    call drops to another kernel. The kernels read the main path's
    layouts (conv2's maps NCHW and its input NHWC, the stem's maps NHWC)
    with vector loads, any other strides one element at a time."""
    if a.g.cdt == DTYPE_CODES[torch.float32]:
        tf32 = {"conv_wgrad": "conv2_wgrad_tf32",
                "conv_dgrad": "conv2_dgrad_tf32"}[wrapper]
        if getattr(lib, f"mft_{tf32}_takes")(ctypes.byref(a)):
            return tf32
        if x is not None and lib.mft_stem_wgrad_tf32_takes(ctypes.byref(a),
                                                           ctypes.byref(x)):
            return "stem_wgrad_tf32"
        g = a.g
        stem = (" or stem_wgrad_tf32, which take a pooled 3x3 SAME stride-1 "
                "conv2 (32 -> 64 at 14x14) or stem (1-8 -> 32, input in f32)"
                if x is not None else ", which takes a pooled 3x3 SAME "
                "stride-1 conv2 (32 -> 64 at 14x14)")
        raise ValueError(
            f"{wrapper} in f32 runs {tf32}{stem}; got {g.cin} -> {g.cout} "
            f"at {g.h}x{g.w}, k {g.k}, stride {g.stride}, pad {g.pad}")
    kind = lib.mft_conv_tc_kind(ctypes.byref(a), ctypes.byref(dp),
                                None if x is None else ctypes.byref(x))
    if kind == _TC_NONE:
        g = a.g
        x_code = None if x is None else x.dtype
        raise ValueError(
            f"{wrapper} in bf16 runs on the tensor-core kernel, which takes "
            f"a pooled 3x3 SAME stride-1 conv2 (32 -> 64 at 14x14) or stem "
            f"(1-8 -> 32, input in f32, weight gradient only) with dp in "
            f"bf16; got {g.cin} -> {g.cout} at {g.h}x{g.w}, k {g.k}, stride "
            f"{g.stride}, pad {g.pad}, dtype codes: dp {dp.dtype}, x "
            f"{x_code}")
    return wrapper + "_tc"


def _dense_dz(dp, h, arg, oh, ow):
    """The conv output's gradient [C, B, C_out, OH, OW]: the pooled
    gradient through the relu (h > 0), placed at each window's argmax."""
    c, bsz, cout, ph, pw = dp.shape
    g = torch.where(h.float() > 0, dp.float(),
                    torch.zeros((), device=dp.device))
    dz = torch.zeros((c, bsz, cout, ph, pw, 4), device=dp.device)
    dz.scatter_(-1, arg.long().unsqueeze(-1), g.unsqueeze(-1))
    return dz.view(c, bsz, cout, ph, pw, 2, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(c, bsz, cout, oh, ow)


def conv_wgrad_plain(x, dp, h, arg, gw, gb, *, stride=1, pad=1,
                     dtype=torch.float32) -> None:
    """Plain version of :func:`conv_wgrad` (``conv2d_weight`` in f32)."""
    c, bsz, cin, hh, ww = x.shape
    oh, ow = _out_hw(hh, ww, gw.shape[-1], stride, pad)
    dz = _dense_dz(dp, h, arg, oh, ow)
    g = torch.nn.grad.conv2d_weight(
        _grouped(_round(x, dtype)), (c * gw.shape[1], cin, *gw.shape[3:]),
        _grouped(dz), stride=stride, padding=pad, groups=c)
    gw.copy_(_round(g.view(gw.shape), dtype))
    gb.copy_(_round(dz.sum(dim=(1, 3, 4)), dtype))


def conv_wgrad(x: torch.Tensor, dp: torch.Tensor, h: torch.Tensor,
               arg: torch.Tensor, gw: torch.Tensor, gb: torch.Tensor, *,
               stride: int = 1, pad: int = 1,
               dtype: torch.dtype = torch.float32) -> None:
    """Weight and bias gradients of a pooled conv layer, written in place
    into ``gw`` [C, C_out, C_in, K, K] and ``gb`` [C, C_out] (f32 views of
    the gradient buffer). ``x`` is the layer's input, ``dp`` the pooled
    output's gradient, ``h`` the pooled output and ``arg`` its argmax.
    For the stem this is the fold of w4's four copies into the 3x3 kernel.
    f32 runs ``conv2_wgrad_tf32`` for conv2 and ``stem_wgrad_tf32`` for
    the stem (3xTF32), bf16 the tensor-core one; any other geometry raises
    (see :func:`_kernel_for`); ``conv_wgrad.launches`` counts the launches
    of all three,
    :data:`~._launch.KERNEL_LAUNCHES` each one's."""
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dp, h, arg, gw, gb, stride=stride, pad=pad,
                                dtype=dtype)
    _check_conv(x, gw, gb, dtype)
    if gw.dtype != torch.float32 or gb.dtype != torch.float32:
        raise TypeError("gradients are written into f32 buffers")
    device = require_cuda(x, dp, h, arg, gw, gb)
    a = _geom(x.shape, gw.shape, stride, pad, True, dtype)
    lib = _library()
    views = [view(x, _IMAGE_AXES), view(dp, _IMAGE_AXES),
             view(h, _IMAGE_AXES), view(arg, _IMAGE_AXES),
             view(gw, _WEIGHT_AXES), view(gb, _BIAS_AXES)]
    kernel = _kernel_for(lib, a, views[1], views[0], "conv_wgrad")
    err = getattr(lib, f"mft_{kernel}")(*[ctypes.byref(v) for v in views],
                                        ctypes.byref(a), device.index,
                                        stream_of(x))
    check(lib, err, kernel, "client_conv")
    count(kernel)
    conv_wgrad.launches += 1


conv_wgrad.launches = 0


def conv_dgrad_plain(dp, h, arg, w, in_hw, *, pad=1, dtype=torch.float32,
                     channels_last=False):
    """Plain version of :func:`conv_dgrad` (``conv2d_input`` in f32)."""
    c, bsz = dp.shape[:2]
    cin = w.shape[2]
    oh, ow = _out_hw(in_hw[0], in_hw[1], w.shape[-1], 1, pad)
    dz = _dense_dz(dp, h, arg, oh, ow)
    dx = torch.nn.grad.conv2d_input(
        (bsz, c * cin, *in_hw), _round(w, dtype).reshape(-1, *w.shape[2:]),
        _grouped(dz), stride=1, padding=pad, groups=c)
    out = _alloc((c, bsz, cin, *in_hw), dtype, dp.device, channels_last)
    out.copy_(_ungrouped(dx, c))
    return out


def conv_dgrad(dp: torch.Tensor, h: torch.Tensor, arg: torch.Tensor,
               w: torch.Tensor, in_hw: Tuple[int, int], *, pad: int = 1,
               dtype: torch.dtype = torch.float32,
               channels_last: bool = False) -> torch.Tensor:
    """Input gradient [C, B, C_in, H, W] (in ``dtype``) of a pooled
    stride-1 conv layer with weights ``w``, conv2's shape only on the card:
    f32 runs ``conv2_dgrad_tf32`` (3xTF32), bf16 ``conv_dgrad_tc`` (see
    :func:`_kernel_for`); ``conv_dgrad.launches`` counts the launches of
    both,
    :data:`~._launch.KERNEL_LAUNCHES` each one's."""
    if dp.device.type == "cpu":
        return conv_dgrad_plain(dp, h, arg, w, in_hw, pad=pad, dtype=dtype,
                                channels_last=channels_last)
    device = require_cuda(dp, h, arg, w)
    c, bsz = dp.shape[:2]
    shape = (c, bsz, w.shape[2], *in_hw)
    a = _geom(shape, w.shape, 1, pad, True, dtype)
    dx = _alloc(shape, dtype, device, channels_last)
    lib = _library()
    views = [view(dp, _IMAGE_AXES), view(h, _IMAGE_AXES),
             view(arg, _IMAGE_AXES), view(w, _WEIGHT_AXES),
             view(dx, _IMAGE_AXES)]
    kernel = _kernel_for(lib, a, views[0], None, "conv_dgrad")
    err = getattr(lib, f"mft_{kernel}")(*[ctypes.byref(v) for v in views],
                                        ctypes.byref(a), device.index,
                                        stream_of(dp))
    check(lib, err, kernel, "client_conv")
    count(kernel)
    conv_dgrad.launches += 1
    return dx


conv_dgrad.launches = 0


# --------------------------------------------------------------- K3

STEM_HW = 28
STEM_OUT = 128


def _stem_operands(x_flat: torch.Tensor, w4: torch.Tensor):
    c, b, d = x_flat.shape
    cin = w4.shape[3]
    if d != STEM_HW * STEM_HW * cin or tuple(w4.shape) != (c, 4, 4, cin,
                                                            STEM_OUT):
        raise ValueError(f"need x_flat [C, B, 28*28*cin] and w4 [C, 4, 4, "
                         f"cin, 128], got {tuple(x_flat.shape)} and "
                         f"{tuple(w4.shape)}")
    x = x_flat.view(c, b, STEM_HW, STEM_HW, cin).permute(0, 1, 4, 2, 3)
    return x, w4.permute(0, 4, 3, 1, 2)  # HWIO -> (out, in, kh, kw)


def client_stem_conv_plain(x_flat: torch.Tensor,
                           w4: torch.Tensor) -> torch.Tensor:
    """The grouped ``F.conv2d`` version of :func:`client_stem_conv`, the
    counterpart of ``client_stem_conv_reference``."""
    x, w = _stem_operands(x_flat, w4)
    out, _ = conv_fwd_plain(x, w, None, stride=2, pad=1, pool=False,
                            dtype=x_flat.dtype, channels_last=True)
    return out.permute(0, 1, 3, 4, 2)


def client_stem_conv(x_flat: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """K3's contract: ``x_flat`` [C, B, 28*28*cin] (NHWC) and ``w4``
    [C, 4, 4, cin, 128] (HWIO) -> the per-client 4x4, stride-2, pad-1
    convolution [C, B, 14, 14, 128], no epilogue, in ``x_flat``'s dtype
    (bf16 or f32; f32 accumulation). Runs :func:`conv_fwd`'s kernel on CUDA
    (``stem_raw_tc`` in bf16, ``stem_raw_tf32`` in f32, at cin = 8 with
    16-byte aligned samples; the CUDA-core ``conv_fwd`` in f32 otherwise)
    and the plain version on the CPU."""
    if x_flat.device.type == "cpu":
        return client_stem_conv_plain(x_flat, w4)
    x, w = _stem_operands(x_flat, w4)
    out, _ = conv_fwd(x, w, None, stride=2, pad=1, pool=False,
                      dtype=x_flat.dtype, channels_last=True)
    return out.permute(0, 1, 3, 4, 2)


def embed_stem(w: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 kernel ``w`` [..., 32, cin, 3, 3] (OIHW) embedded at
    the four pool offsets of a 4x4 kernel: w4 [..., 4, 4, cin, 128] (HWIO),
    group g = (di, dj) in output channels g*32 .. g*32+31, as the JAX
    package's ``ConvPoolFused`` builds it."""
    lead = w.shape[:-4]
    cout, cin = w.shape[-4], w.shape[-3]
    hwio = w.permute(*range(len(lead)), -2, -1, -3, -4)
    w4 = w.new_zeros(lead + (4, 4, cin, 4 * cout))
    for g, (di, dj) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        w4[..., di:di + 3, dj:dj + 3, :, g * cout:(g + 1) * cout] = hwio
    return w4
