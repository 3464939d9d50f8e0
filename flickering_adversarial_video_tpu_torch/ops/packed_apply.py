"""The attack step's input head: u8 normalize + flickering delta + clip, fused
with the stem conv, whose backward reduces straight to d(delta).

Port of ``ops/packed_apply.pack_flicker_delta`` and of the T-major head
``stem_tmajor.flicker_stem_tmajor`` (``ops/stem_tmajor.py:433-636``, the
default ``FLICKER_HEAD_FUSED_REDUCE=1`` form) of the JAX package, on NDHWC.

Forward, on the space-to-depth packed uint8 clip [B,T',H',W',8C]:
``pre = u8/128 - 1 + flag * pack(delta)``; ``adv = clip(pre, lo, hi)`` in the
compute dtype; the stem conv + BN + relu (kernel B1) on adv.  Saved: the stem
output y and the u8 clip mask (2x the gradient of the clip: {0,1,2}, so 0.5 at
an exact boundary, which pixel value 0 hits exactly at -1.0).

Backward: g2 = g*(y>0)*rsqrt(var+eps); the wide transposed conv gives
``part`` (tap m's d(adv) block, still temporally unshifted); each tap's block
is shifted by (1-m) frames, multiplied by the mask and reduced over
(B, H, W) in f32 -- the combined d(adv) tensor never exists.  Then the fold
of pack_flicker_delta is transposed to d(delta) [T,1,1,C], and d(flag) is
the flag-free sum.  Kernel and BN cotangents are not computed.
"""

from __future__ import annotations

import torch

from .conv_unit import masked_scale
from .stem_combine import catbwd_part
from .stem_conv import BWD_PADS, pk_to_oidhw, stem_conv_bn_relu

EPS = 1e-3


def pack_flicker_delta(delta: torch.Tensor) -> torch.Tensor:
    """[T,1,1,C] -> [T/2,1,1,8C] in (parity_t, parity_h, parity_w, C) order;
    the h/w parities are pure broadcast."""
    t, _, _, c = delta.shape
    d = delta.reshape(t // 2, 2, 1, 1, 1, 1, c).expand(t // 2, 2, 2, 2, 1, 1, c)
    return d.reshape(t // 2, 1, 1, 8 * c)


def clip_grad_mask2(pre: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """2x the gradient of clip(pre, lo, hi) = minimum(maximum(pre, lo), hi)
    wrt pre, as uint8 {0,1,2} (tie-splitting max/min give 0.5 at a bound)."""
    two_max = 2 * (pre > lo).to(torch.uint8) + (pre == lo).to(torch.uint8)
    two_min = 2 * (pre < hi).to(torch.uint8) + (pre == hi).to(torch.uint8)
    return (two_max * two_min) // 2


class _FlickerStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed_u8, delta_applied, adv_flag, pk, mean, var, bias, lo, hi, out_dtype):
        dpk = pack_flicker_delta(delta_applied.float())
        pre = packed_u8.float() / 128.0 - 1.0 + adv_flag.float() * dpk
        adv = pre.clamp(lo, hi).to(out_dtype)
        mask2 = clip_grad_mask2(pre, lo, hi)
        del pre
        y = stem_conv_bn_relu(adv, pk.to(out_dtype), mean, var, bias, EPS)
        ctx.save_for_backward(y, mask2, dpk, adv_flag, pk.to(out_dtype), var)
        ctx.delta_shape = delta_applied.shape
        return y

    @staticmethod
    def backward(ctx, g):
        y, mask2, dpk, adv_flag, pk, var = ctx.saved_tensors
        cin = pk.shape[3]
        t = y.shape[1]
        g2 = masked_scale(g, y, var, EPS)
        part = catbwd_part(g2, pk_to_oidhw(pk), BWD_PADS)
        maskf = mask2.float() * 0.5
        s_tc = torch.zeros((t, cin), dtype=torch.float32, device=y.device)
        for m in range(pk.shape[0]):
            blk = part[..., m * cin : (m + 1) * cin]
            s = 1 - m  # d(adv) of tap m at frame t is blk[t + s]
            if abs(s) >= t:
                continue
            if s >= 0:
                prod = blk[:, s:].float() * maskf[:, : t - s]
                s_tc[: t - s] += prod.sum(dim=(0, 2, 3))
            else:
                prod = blk[:, : t + s].float() * maskf[:, -s:]
                s_tc[-s:] += prod.sum(dim=(0, 2, 3))
        d_delta = d_flag = None
        if ctx.needs_input_grad[1]:
            d_dpk = adv_flag.float() * s_tc  # [T', 8C]
            c = cin // 8
            d_delta = d_dpk.reshape(t, 2, 2, 2, c).sum(dim=(2, 3)).reshape(ctx.delta_shape)
        if ctx.needs_input_grad[2]:
            d_flag = (s_tc * dpk[:, 0, 0, :]).sum().reshape(adv_flag.shape)
        return None, d_delta, d_flag, None, None, None, None, None, None, None


def flicker_stem(
    packed_u8, delta_applied, adv_flag, pk, mean, var, bias,
    input_min: float = -1.0, input_max: float = 1.0, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """packed_u8 [B,T',H',W',8C] uint8 (host- or device-packed); delta_applied
    the value-clipped (and frame-masked) delta [T,1,1,C]; adv_flag a 0-d
    tensor; pk the packed stem kernel.  Returns the stem output
    [B,T',H',W',Cout] in out_dtype."""
    return _FlickerStem.apply(
        packed_u8, delta_applied, adv_flag, pk, mean, var, bias,
        float(input_min), float(input_max), out_dtype,
    )
