"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at a 700 W power limit), and the roofline rule.

A kernel's least time is the larger of its bytes over the HBM rate and its
operations over the peak rate of their type; f32 work that keeps f32's
accuracy counts at the 3xTF32 rate (three TF32 products make one f32 one),
the repository's bound rule for f32.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 495e12 / 3,  # f32-accurate: 3xTF32
    "float32_cuda_cores": 67e12,
}


def bound_s(nbytes: float, flops: float, kind: str) -> Tuple[float, str]:
    """``(seconds, "bytes" or "operations")``: the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
