"""ctypes plumbing shared by the local-training kernels' wrappers.

``csrc/client_common.cuh`` defines ``MftView``: a pointer, five strides in
elements over the axes (client, sample, channel, row, column) and a dtype
code. :func:`view` builds one from a tensor and the tensor dimension that
plays each axis, so a kernel reads a strided slice (a step's batch of a
client's images, a layer's segment of the flat buffer) in place.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2,
               torch.int64: 3}


class MftView(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("st", ctypes.c_int64 * 5),
                ("dtype", ctypes.c_int), ("pad_", ctypes.c_int)]


def view(t: Optional[torch.Tensor],
         axes: Sequence[Optional[int]] = ()) -> MftView:
    """``t`` as an ``MftView``: ``axes[i]`` is the dimension of ``t`` that
    plays axis ``i`` of (client, sample, channel, row, column), or None.
    ``None`` gives a null view (an absent optional operand)."""
    v = MftView()
    if t is None:
        return v
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"no kernel takes {t.dtype}")
    v.ptr = t.data_ptr()
    v.dtype = DTYPE_CODES[t.dtype]
    strides = t.stride()
    for i, dim in enumerate(axes):
        if dim is not None:
            v.st[i] = strides[dim]
    return v


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str, prefix: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = getattr(lib, f"mft_{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} "
                           f"({msg})")


#: launches of each local-training kernel of ``csrc/client_conv.cu`` and
#: ``csrc/client_dense.cu``, by name. In f32 the wrappers launch the stem's
#: and conv2's pooled forward on ``stem_fwd_f32`` (CUDA cores) and
#: ``conv2_fwd_tf32``, conv2's weight and input gradients on
#: ``conv2_wgrad_tf32`` and ``conv2_dgrad_tf32``, the stem's weight
#: gradient on ``stem_wgrad_tf32``, fc1's forward and backward on
#: ``dense_fwd_tf32`` and ``dense_bwd_tf32`` (3xTF32), and the CUDA-core
#: kernels ``dense_fwd`` and ``dense_bwd`` (fc2); in bf16 the tensor-core kernels
#: ``conv2_fwd_tc``, ``stem_fwd_tc``, ``conv_wgrad_tc`` (conv2's and the
#: stem's instantiations), ``conv_dgrad_tc``, ``dense_fwd_tc`` and
#: ``dense_bwd_tc`` (fc2, with f32 weights, stays on ``dense_fwd`` and
#: ``dense_bwd``); the raw mode (K3) runs ``stem_raw_tc`` in bf16 and
#: ``stem_raw_tf32`` in f32 (``csrc/client_stem_raw.cu``) at K3's geometry,
#: and the CUDA-core ``conv_fwd`` in f32 off it. Each wrapper's
#: ``.launches`` counts all of its own.
KERNEL_LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("conv_fwd", "conv2_fwd_tc", "conv2_fwd_tf32", "stem_fwd_tc",
     "stem_fwd_f32", "stem_raw_tc", "stem_raw_tf32", "conv_wgrad_tc", "conv2_wgrad_tf32", "stem_wgrad_tf32",
     "conv_dgrad_tc", "conv2_dgrad_tf32", "dense_fwd", "dense_fwd_tc",
     "dense_fwd_tf32", "dense_bwd", "dense_bwd_tc", "dense_bwd_tf32"), 0)


def count(kernel: str) -> None:
    """One launch of ``kernel`` (a key of :data:`KERNEL_LAUNCHES`)."""
    KERNEL_LAUNCHES[kernel] += 1


def reset_kernel_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def kernel_launches() -> Dict[str, int]:
    """A copy of :data:`KERNEL_LAUNCHES`."""
    return dict(KERNEL_LAUNCHES)


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError("the kernel needs every operand on one CUDA "
                             f"device, got {t.device} and {device}")
    return device
