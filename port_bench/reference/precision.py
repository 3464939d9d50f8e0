"""Rounding of the reference's convolutions to a stated precision.

The reference runs in float32 ("f32").  Its control, the nearest precision
below the configuration's bfloat16, is fp8: "fp8" rounds each convolution's
input and weight, and the gradient that reaches its output, to float8 e4m3
with one scale a tensor (its largest magnitude maps to 448, e4m3's largest
finite value), and computes the convolution in f32 on the rounded values.
"bf16" rounds the same tensors to bfloat16; it stands for the program's own
precision in the harness's tests.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16", "fp8")
_E4M3_MAX = 448.0


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to `precision`, returned in f32."""
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {precision!r}: choose from {PRECISIONS}")


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded on its way back."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.precision), None


class _Round(torch.autograd.Function):
    """x rounded forward; the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x, precision):
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


def conv3d(x: torch.Tensor, w: torch.Tensor, precision: str = "f32", **kw) -> torch.Tensor:
    """F.conv3d (NCDHW) at `precision`: input, weight and the output's
    gradient rounded; f32 arithmetic."""
    if precision != "f32":
        x = _Round.apply(x, precision)
        w = round_to(w, precision)
    y = torch.nn.functional.conv3d(x, w, **kw)
    return y if precision == "f32" else _RoundGrad.apply(y, precision)
