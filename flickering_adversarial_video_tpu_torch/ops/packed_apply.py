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

adv and the mask come from one pass, kernel B7 ``emit_adv_mask``, which
replaces the Pallas emitter ``emit_tmajor`` (``ops/stem_tmajor.py:363``,
kernel ``_emit_tmajor_kernel`` :350); CUDA source ``csrc/emit.cu``.  It
computes that kernel's values on NDHWC, without its transpose into the
T-major view.  A forward that needs no gradient (eval, clean) asks for no
mask, and the kernel then writes none.  Bound by bytes on the H100.

Backward: g2 = g*(y>0)*rsqrt(var+eps); the wide transposed conv gives
``part`` (tap m's d(adv) block, still temporally unshifted); each tap's block
is shifted by (1-m) frames, multiplied by the mask and reduced over
(B, H, W) in f32 -- the combined d(adv) tensor never exists.  Then the fold
of pack_flicker_delta is transposed to d(delta) [T,1,1,C], and d(flag) is
the flag-free sum.  Kernel and BN cotangents are not computed.

The vectorized sweep's slots: with a delta [N,T,1,1,C] (one per clip of the
batch of N) dl is [N,T',CH], which B7 reads a row a clip (the same kernel;
the wrapper counts these launches apart too), the backward reduces each clip's
blocks over (H, W) only, to d(delta) [N,T,1,1,C], and d(flag) is the sum
over the clips.
"""

from __future__ import annotations

import torch

from . import kernels
from .accounting import record
from .conv_unit import masked_scale
from .stem_combine import catbwd_part
from .stem_conv import BWD_PADS, pk_to_oidhw, stem_conv_bn_relu

EPS = 1e-3


def pack_flicker_delta(delta: torch.Tensor) -> torch.Tensor:
    """[..., T,1,1,C] -> [..., T/2,1,1,8C] in (parity_t, parity_h, parity_w,
    C) order; the h/w parities are pure broadcast.  Leading axes (the slots)
    are kept."""
    *lead, t, _, _, c = delta.shape
    d = delta.reshape(*lead, t // 2, 2, 1, 1, 1, 1, c).expand(*lead, t // 2, 2, 2, 2, 1, 1, c)
    return d.reshape(*lead, t // 2, 1, 1, 8 * c)


def clip_grad_mask2(pre: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """2x the gradient of clip(pre, lo, hi) = minimum(maximum(pre, lo), hi)
    wrt pre, as uint8 {0,1,2} (tie-splitting max/min give 0.5 at a bound)."""
    two_max = 2 * (pre > lo).to(torch.uint8) + (pre == lo).to(torch.uint8)
    two_min = 2 * (pre < hi).to(torch.uint8) + (pre == hi).to(torch.uint8)
    return (two_max * two_min) // 2


def emit_adv_mask_plain(packed_u8, dl, lo: float, hi: float, out_dtype, want_mask: bool = True):
    """The emitter in plain PyTorch: (adv in out_dtype, mask2 uint8 or None)
    from the packed clip [B,T',H',W',CH] and dl f32 = flag*pack(delta), [T',CH]
    (shared by the batch) or [B,T',CH] (one per clip)."""
    dl = dl.float()
    dl = dl[:, :, None, None, :] if dl.dim() == 3 else dl[:, None, None, :]
    pre = packed_u8.float() / 128.0 - 1.0 + dl
    adv = pre.clamp(lo, hi).to(out_dtype)
    return adv, (clip_grad_mask2(pre, lo, hi) if want_mask else None)


def emit_adv_mask(packed_u8, dl, lo: float, hi: float, out_dtype, want_mask: bool = True):
    """B7: packed uint8 [B,T',H',W',CH], dl f32 [T',CH] (shared by the
    batch) or [B,T',CH] (one per clip) -> (adv, mask2 or None).  `launches`
    counts every launch, `clip_launches` those with a dl a clip."""
    if packed_u8.dim() != 5 or packed_u8.dtype != torch.uint8:
        raise TypeError(f"the packed clip must be uint8 [B,T',H',W',CH], got "
                        f"{packed_u8.dtype} {tuple(packed_u8.shape)}")
    b, t, h, w, ch = packed_u8.shape
    per_clip = dl.dim() == 3
    dl_shape = (b, t, ch) if per_clip else (t, ch)
    if tuple(dl.shape) != dl_shape:
        raise ValueError(f"dl {tuple(dl.shape)} is not {list(dl_shape)}")
    n = packed_u8.numel()
    record("B7c" if per_clip else "B7", 0,
           n * (1 + torch.finfo(out_dtype).bits // 8 + want_mask) + dl.numel() * 4)
    if not packed_u8.is_cuda:
        return emit_adv_mask_plain(packed_u8, dl, lo, hi, out_dtype, want_mask)
    if out_dtype not in kernels.DTYPE_CODE:
        raise TypeError(f"kernel dtype {out_dtype} not supported (float32, bfloat16)")
    u8 = packed_u8.contiguous()
    dl = dl.float().contiguous()
    kernels.check(dl, dtype=torch.float32)
    if dl.device != u8.device:
        raise ValueError("kernel operands must lie on one CUDA device")
    adv = torch.empty(u8.shape, dtype=out_dtype, device=u8.device)
    mask2 = torch.empty(u8.shape, dtype=torch.uint8, device=u8.device) if want_mask else None
    kernels.launch(
        "fav_emit_adv_mask", u8.data_ptr(), dl.data_ptr(), adv.data_ptr(),
        mask2.data_ptr() if want_mask else None, u8.numel(), h * w * ch, t, ch,
        b if per_clip else 0, float(lo), float(hi), kernels.DTYPE_CODE[out_dtype],
        kernels.stream(),
    )
    emit_adv_mask.launches += 1
    emit_adv_mask.clip_launches += per_clip
    return adv, mask2


emit_adv_mask.launches = 0
emit_adv_mask.clip_launches = 0


class _FlickerStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed_u8, delta_applied, adv_flag, pk, mean, var, bias, lo, hi, out_dtype,
                want_grad):
        dpk = pack_flicker_delta(delta_applied.float())
        # dl folds the flag, so the emitter is a pure function of the batch;
        # d(flag) in the backward needs dpk itself; [T',CH], or [N,T',CH]
        # for a delta a clip
        dl = adv_flag.float() * dpk[..., 0, 0, :]
        adv, mask2 = emit_adv_mask(packed_u8, dl, lo, hi, out_dtype, want_mask=want_grad)
        y = stem_conv_bn_relu(adv, pk.to(out_dtype), mean, var, bias, EPS)
        if want_grad:
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
        # a shared delta: s_tc [T', 8C], summed over (B, H, W); a delta a
        # clip: [B, T', 8C], summed over (H, W) only
        per_clip = dpk.dim() == 5
        dims = (2, 3) if per_clip else (0, 2, 3)
        lead = (y.shape[0],) if per_clip else ()
        s_tc = torch.zeros(lead + (t, cin), dtype=torch.float32, device=y.device)
        s_t = s_tc.movedim(-2, 0)  # a view, frames first
        for m in range(pk.shape[0]):
            blk = part[..., m * cin : (m + 1) * cin]
            s = 1 - m  # d(adv) of tap m at frame t is blk[t + s]
            if abs(s) >= t:
                continue
            if s >= 0:
                prod = blk[:, s:].float() * maskf[:, : t - s]
                s_t[: t - s] += prod.sum(dim=dims).movedim(-2, 0)
            else:
                prod = blk[:, : t + s].float() * maskf[:, -s:]
                s_t[-s:] += prod.sum(dim=dims).movedim(-2, 0)
        d_delta = d_flag = None
        if ctx.needs_input_grad[1]:
            d_dpk = adv_flag.float() * s_tc  # [(B,) T', 8C]
            c = cin // 8
            d_delta = d_dpk.reshape(lead + (t, 2, 2, 2, c)).sum(dim=(-3, -2)).reshape(
                ctx.delta_shape)
        if ctx.needs_input_grad[2]:
            d_flag = (s_tc * dpk[..., 0, 0, :]).sum().reshape(adv_flag.shape)
        return None, d_delta, d_flag, None, None, None, None, None, None, None, None


def flicker_stem(
    packed_u8, delta_applied, adv_flag, pk, mean, var, bias,
    input_min: float = -1.0, input_max: float = 1.0, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """packed_u8 [B,T',H',W',8C] uint8 (host- or device-packed); delta_applied
    the value-clipped (and frame-masked) delta [T,1,1,C], or [B,T,1,1,C] (a
    delta a clip: the vectorized sweep's slots); adv_flag a 0-d
    tensor; pk the packed stem kernel.  Returns the stem output
    [B,T',H',W',Cout] in out_dtype."""
    want_grad = torch.is_grad_enabled() and (delta_applied.requires_grad or adv_flag.requires_grad)
    return _FlickerStem.apply(
        packed_u8, delta_applied, adv_flag, pk, mean, var, bias,
        float(input_min), float(input_max), out_dtype, want_grad,
    )
