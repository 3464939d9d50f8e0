"""The packed I3D stem conv + frozen BN + relu, kernel B1.

Port of ``stem_tmajor.stem_conv_bn_relu_view`` / ``stem_bn_relu_tmajor``
(``ops/stem_tmajor.py:144-255``) on NDHWC.

* B1 ``stem_conv_bn_relu`` replaces the Pallas
  ``stem_conv_bn_relu_view_pallas`` (``ops/stem_conv_pallas.py:152``, kernel
  ``_kernel`` :82); CUDA source ``csrc/stem_conv.cu``.  x [B,T',H',W',24] is
  the space-to-depth packed clip, pk [4,4,4,24,64] the packed kernel (DHWIO),
  SAME pads (1,2).  All 64 taps accumulate in one f32 contraction, then the
  sum is rounded to x's dtype and BN ((y-mean)*rsqrt(var+eps)+bias, with
  rsqrt taken in f32 as the Pallas kernel does) and relu follow in that dtype.
  Bound by operations on the H100 (about 631 GFLOP per call at B=8, T=64,
  224^2); the design is in the CUDA source.
* ``stem_bn_relu`` is the autograd op for a stem whose INPUT needs a
  gradient (the model's own forward): B1 forward; backward as ``_tmajor_bwd``
  -- one wide transposed conv of g*(y>0)*rsqrt(var+eps), then the temporal
  combine B2 with t_plo 1.  The attack step does not take this path: its
  input head (``packed_apply.flicker_stem``) reduces straight to d(delta).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .conv_unit import masked_scale
from .stem_combine import catbwd_part, temporal_combine

CIN, COUT, TAPS = 24, 64, 4
PADS = (1, 2)
BWD_PADS = ((2, 1), (2, 1))  # transposed spatial pads of the (1,2) forward


def pk_to_oidhw(pk: torch.Tensor) -> torch.Tensor:
    """Packed DHWIO [4,4,4,24,64] -> OIDHW [64,24,4,4,4]."""
    return pk.permute(4, 3, 0, 1, 2)


def stem_conv_bn_relu_plain(xp, pk, mean, var, bias, eps: float = 1e-3) -> torch.Tensor:
    """The same function in plain PyTorch: f32 conv, then BN/relu in x's dtype."""
    dt = xp.dtype
    lo, hi = PADS
    xf = F.pad(xp.float().permute(0, 4, 1, 2, 3), (lo, hi) * 3)
    acc = F.conv3d(xf, pk_to_oidhw(pk.float()))
    y = acc.permute(0, 2, 3, 4, 1).to(dt)
    mul = torch.rsqrt(var.float() + eps).to(dt)
    return torch.relu((y - mean.to(dt)) * mul + bias.to(dt)).contiguous()


def stem_conv_bn_relu(xp, pk, mean, var, bias, eps: float = 1e-3) -> torch.Tensor:
    """B1: xp [B,T',H',W',24], pk [4,4,4,24,64], BN vectors [64] -> y [B,T',H',W',64]."""
    if xp.dim() != 5 or xp.shape[-1] != CIN or tuple(pk.shape) != (TAPS, TAPS, TAPS, CIN, COUT):
        raise ValueError(f"stem expects x [B,T,H,W,{CIN}] and pk [4,4,4,{CIN},{COUT}], "
                         f"got {tuple(xp.shape)} and {tuple(pk.shape)}")
    if not xp.is_cuda:
        return stem_conv_bn_relu_plain(xp, pk, mean, var, bias, eps)
    b, t, h, w, _ = xp.shape
    xp = xp.contiguous()
    pk = pk.to(xp.dtype).contiguous()
    code = kernels.check(xp, pk)
    mean_f = mean.float().contiguous()
    mul_f = torch.rsqrt(var.float() + eps).contiguous()
    bias_f = bias.float().contiguous()
    kernels.check(mean_f, mul_f, bias_f, dtype=torch.float32)
    y = torch.empty((b, t, h, w, COUT), dtype=xp.dtype, device=xp.device)
    kernels.launch(
        "fav_stem_conv_bn_relu", xp.data_ptr(), pk.data_ptr(), mean_f.data_ptr(),
        mul_f.data_ptr(), bias_f.data_ptr(), y.data_ptr(), b, t, h, w, code,
        kernels.stream(),
    )
    stem_conv_bn_relu.launches += 1
    return y


stem_conv_bn_relu.launches = 0


class _StemBNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, pk, mean, var, bias, eps):
        y = stem_conv_bn_relu(xp, pk, mean, var, bias, eps)
        ctx.save_for_backward(y, pk, var)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        y, pk, var = ctx.saved_tensors
        g2 = masked_scale(g, y, var, ctx.eps)
        part = catbwd_part(g2, pk_to_oidhw(pk), BWD_PADS)
        return temporal_combine(part, CIN, 1), None, None, None, None, None


def stem_bn_relu(xp, pk, mean, var, bias, eps: float = 1e-3) -> torch.Tensor:
    """Stem conv + BN + relu with a gradient to the packed input xp."""
    return _StemBNReLU.apply(xp, pk.to(xp.dtype), mean, var, bias, eps)
