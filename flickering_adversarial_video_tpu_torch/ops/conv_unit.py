"""Unit3D as one op: stride-1 SAME odd-kernel conv + frozen BN + relu.

Port of ``stem_tmajor.conv_bn_relu_tmajor`` (``ops/stem_tmajor.py:300-333``)
on NDHWC.  Forward: the conv (plain ``conv3d``, cuDNN on the card), then
inference BN (no scale) and relu in the compute dtype, in
``_bn_relu_view``'s op order.  Only the relu output y is saved: the
backward recomputes the relu mask as y > 0, scales by rsqrt(var+eps), and
runs the concat-kernel input gradient -- the wide spatial conv, then for
KT >= 2 the temporal combine kernel B2 (``stem_combine.temporal_combine``),
exactly as ``_cbr_bwd`` does.  Kernel and BN cotangents are not computed:
the victim is frozen.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stem_combine import catbwd_part, temporal_combine


def bn_relu(y: torch.Tensor, mean, var, bias, eps: float) -> torch.Tensor:
    """Inference BN (no scale) + relu over the last (channel) dim, in y's dtype."""
    dt = y.dtype
    mul = torch.rsqrt(var.to(dt) + var.new_full((), eps, dtype=dt))
    return torch.relu((y - mean.to(dt)) * mul + bias.to(dt))


def masked_scale(g, y, var, eps: float) -> torch.Tensor:
    """g * (y > 0) * rsqrt(var + eps) in y's dtype: the cotangent at the
    conv output of a frozen BN + relu whose output y was saved."""
    dt = y.dtype
    mul = torch.rsqrt(var.to(dt) + var.new_full((), eps, dtype=dt))
    return g.to(dt) * (y > 0) * mul


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of NDHWC x with an odd OIDHW kernel -> NDHWC."""
    k = w.shape[2:]
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        w.to(x.dtype).contiguous(memory_format=torch.channels_last_3d),
        padding=tuple(d // 2 for d in k),
    )
    return y.permute(0, 2, 3, 4, 1)


class _ConvBNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mean, var, bias, eps):
        y = bn_relu(conv3d_same(x, w), mean, var, bias, eps).contiguous()
        ctx.save_for_backward(y, w, var)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        y, w, var = ctx.saved_tensors
        kt, kh, kw = w.shape[2:]
        g2 = masked_scale(g, y, var, ctx.eps)
        part = catbwd_part(g2, w, ((kh // 2, kh // 2), (kw // 2, kw // 2)))
        dx = temporal_combine(part, w.shape[1], kt // 2) if kt > 1 else part
        return dx, None, None, None, None, None


def conv_bn_relu(x, w, mean, var, bias, eps: float = 1e-3) -> torch.Tensor:
    """x NDHWC [B,T,H,W,Cin] in the compute dtype; w OIDHW [Cout,Cin,kt,kh,kw]
    with odd extents; BN vectors [Cout].  Returns [B,T,H,W,Cout]."""
    if any(d % 2 == 0 for d in w.shape[2:]):
        raise ValueError(f"odd kernel extents required, got {tuple(w.shape[2:])}")
    return _ConvBNReLU.apply(x.contiguous(), w.to(x.dtype), mean, var, bias, eps)
