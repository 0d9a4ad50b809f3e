"""Lower-precision rounding of a layer's operands, for a cell's control.

The reference computes in f32 with TF32 off. Its control (``faults.control``)
computes the layers that ``config["control"]`` names with each operand of
their products rounded to the precision below the configuration's, and the
sums in f32, as a kernel in that precision would: :func:`operand` rounds a
forward operand (an input or a weight); :func:`output` rounds the gradient
that flows back into the layer, the operand of its backward products.

- ``tf32`` (below f32): TF32's 10-bit mantissa, round to nearest, ties away
  from zero, as ``cvt.rna.tf32.f32``;
- ``fp8`` (below bf16): e4m3 with one f32 scale per tensor (its largest
  magnitude onto e4m3's 448), round to nearest even, as an fp8 GEMM with
  per-tensor scaling takes its operands;
- ``int8`` (below bf16): symmetric int8 with one scale per tensor (its
  largest magnitude onto 127), round to nearest even.
"""

from __future__ import annotations

from typing import Optional

import torch


#: per-tensor-scaled formats: the scaled tensor's largest magnitude, and the
#: rounding of a scaled f32 tensor
SCALED = {
    "fp8": (448.0, lambda y: y.to(torch.float8_e4m3fn).float()),
    "int8": (127.0, lambda y: torch.round(y)),
}


def round_to(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    if precision is None:
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        # Add half of the dropped 13 bits' range, then drop them: ties away.
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision in SCALED:
        top, cast = SCALED[precision]
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
        return cast(x / scale) * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return round_to(grad, ctx.precision), None


def operand(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    return x if precision is None else _Operand.apply(x, precision)


def output(y: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    return y if precision is None else _Output.apply(y, precision)
