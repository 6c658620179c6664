"""Operand rounding that stands for a product's precision.

A product in precision `p` is computed here as an f32 product of
operands rounded to `p`, which is what tensor cores do with bf16, TF32
and fp8 inputs and f32 sums; under autograd the gradient entering the
backward products is rounded too (`product_out`):

- `f32`: no rounding (TF32 must be off, `reference.solve.f32_products`);
- `tf32`: round to 10 mantissa bits, to nearest even;
- `bf16`: round to bfloat16, to nearest even;
- `fp8`: float8 e4m3 with one scale a tensor (its largest magnitude to
  448, the format's largest finite value), as a scaled fp8 path does.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    bits = (bits + 2**31) % 2**32 - 2**31  # back into int32's range
    return bits.to(torch.int32).view(torch.float32).reshape(t.shape)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _tf32(t)
    if precision == "bf16":
        return t.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return _fp8(t)
    raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


class _Operand(torch.autograd.Function):
    """Rounded forward; the gradient passes to the unrounded value."""

    @staticmethod
    def forward(ctx, t, precision):
        return _rounded(t, precision)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Product(torch.autograd.Function):
    """Identity forward; the gradient that enters the product's backward
    products is rounded, as the operands of those products are."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, ctx.precision), None


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product in `precision`."""
    return t if precision == "f32" else _Operand.apply(t, precision)


def product_out(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's output, whose gradient is an operand of the backward
    products in `precision`."""
    return t if precision == "f32" else _Product.apply(t, precision)
