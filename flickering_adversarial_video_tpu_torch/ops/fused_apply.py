"""Fused uint8 decode + normalize + flicker apply + clip, kernel B8.

Port of the JAX package's ``ops/fused_apply.py``: the adversarial input of
the tanh world on an UNPACKED uint8 batch,

    adv = clip(u8/128 - 1 + adv_flag * delta[t, c], -1, 1)        (f32)

in one pass (B8 forward replaces ``_fwd_kernel`` :68, called at :144), and
its backward, a masked per-(t, c) reduction of the upstream gradient to
d(delta) (B8 backward replaces ``_bwd_kernel`` :86, called at :184).  CUDA
source ``csrc/fused_apply.cu``.  The engine takes this path when
``AttackConfig.use_pallas_fused`` is set (YAML key ``USE_PALLAS_FUSED``).

What the kernel fixes, as the TPU kernel does:

* the bounds are the literals -1 and 1, not a spec's input range;
* the output is f32 whatever the model's compute dtype; g arrives as f32;
* **the tie rule is strict**: the backward passes the gradient only where
  ``-1 < pre < 1``, so at an exact bound it is 0 -- where ``jnp.clip``, the
  generic path and the packed input head (B7's mask) give 0.5.  u8 value 0
  under delta 0 sits exactly on -1, so the two configurations of the runner
  differ from the first step on any clip with a black pixel.  That is the
  JAX package's behaviour and is kept;
* d(adv_flag) is zeros (the flag is a constant gate), None for the video.

Unlike the TPU kernel there is no geometry limit (its ``H*W*C % 128`` and
``B*T % 8`` were Mosaic block constraints) and so no fallback.  The
backward is deterministic: per-block partials in a fixed order, then a
second kernel that sums them in a fixed order; it agrees with the plain
version to f32 sum order (about 1e-5 of the largest component at
[8,64,224,224,3]).  Both kernels are bound by bytes on the H100.

B8c, a delta a clip (the vectorized sweep's slots): with delta
[B,T,1,1,C], clip b of the batch takes row b (the JAX sweep's
``jax.vmap`` of ``fused_normalize_perturb`` over the slots, the flag
shared), and the backward gives d(delta) [B,T,1,1,C], each clip's masked
reduction over (H, W) alone.  The same kernel bodies with a delta clip
stride (``csrc/fused_apply.cu``), under launchers and kernel names of
their own; the wrappers count these launches apart, as ``clip_launches``
(``launches`` counts the shared delta's).  A clip's forward and d(delta)
are bit for bit the shared-delta kernels' on that clip alone.

Geometry: the JAX per-slot call has B = 1, so its ``_supported`` takes the
Pallas kernel only where ``T % 8 == 0`` and ``H*W*C % 128 == 0``; at any
other geometry (the single-video clip's T = 90) the JAX sweep runs
``_jnp_reference``, whose gradient is 0.5 at an exact bound.  The port
runs the kernel's strict rule at every geometry, slotted or not (a
standing difference, ROADMAP.md queue C).
"""

from __future__ import annotations

import torch

from . import kernels
from .accounting import record

SLICE = 16 * 256 * 4   # elements of a row per backward block; csrc kSlice
MAX_CHANNELS = 4       # csrc kMaxC


def _per_clip(delta: torch.Tensor) -> bool:
    return delta.dim() == 5


def _pre(video_u8: torch.Tensor, delta: torch.Tensor, adv_flag: torch.Tensor) -> torch.Tensor:
    x = video_u8.float() * (1.0 / 128.0) - 1.0
    d = delta.float() if _per_clip(delta) else delta.float()[None]
    return x + adv_flag.float() * d


def fused_apply_fwd_plain(video_u8, delta, adv_flag) -> torch.Tensor:
    return _pre(video_u8, delta, adv_flag).clamp(-1.0, 1.0)


def fused_apply_bwd_plain(video_u8, delta, adv_flag, g) -> torch.Tensor:
    pre = _pre(video_u8, delta, adv_flag)
    mask = (pre < 1.0) & (pre > -1.0)
    dims = (2, 3) if _per_clip(delta) else (0, 2, 3)
    dd = torch.where(mask, g.float(), g.new_zeros((), dtype=torch.float32)).sum(dim=dims)
    return (adv_flag.float() * dd).reshape(delta.shape)


def _check(video_u8, delta, adv_flag):
    if video_u8.dim() != 5 or video_u8.dtype != torch.uint8:
        raise TypeError(f"video must be uint8 [B,T,H,W,C], got {video_u8.dtype} "
                        f"{tuple(video_u8.shape)}")
    b, t, c = video_u8.shape[0], video_u8.shape[1], video_u8.shape[4]
    want = (b, t, 1, 1, c) if _per_clip(delta) else (t, 1, 1, c)
    if tuple(delta.shape) != want:
        raise ValueError(f"delta {tuple(delta.shape)} is not {list(want)} (or [{t},1,1,{c}] "
                         f"shared by the clips)")
    if adv_flag.numel() != 1:
        raise ValueError("adv_flag must hold one value")


def _operands(video_u8, delta, adv_flag):
    u8 = video_u8.contiguous()
    d = delta.detach().float().reshape(-1).contiguous()
    f = adv_flag.detach().float().reshape(1).contiguous()
    kernels.check(d, f, dtype=torch.float32)
    if not u8.is_cuda or u8.device != d.device:
        raise ValueError("kernel operands must lie on one CUDA device")
    return u8, d, f


def fused_apply_fwd(video_u8, delta, adv_flag) -> torch.Tensor:
    """B8 forward: uint8 [B,T,H,W,C], delta [T,1,1,C] (or B8c: [B,T,1,1,C],
    a row a clip), adv_flag 0-d -> f32.  `launches` counts the shared
    delta's launches, `clip_launches` B8c's."""
    _check(video_u8, delta, adv_flag)
    record("B8cf" if _per_clip(delta) else "B8f", 0,
           video_u8.numel() * (1 + 4) + (delta.numel() + 1) * 4)
    if not video_u8.is_cuda:
        return fused_apply_fwd_plain(video_u8, delta, adv_flag)
    per_clip = _per_clip(delta)
    u8, d, f = _operands(video_u8, delta, adv_flag)
    b, t, h, w, c = u8.shape
    out = torch.empty(u8.shape, dtype=torch.float32, device=u8.device)
    kernels.launch(
        "fav_fused_apply_clips_fwd" if per_clip else "fav_fused_apply_fwd", u8.data_ptr(),
        d.data_ptr(), f.data_ptr(), out.data_ptr(), b, t, h * w * c, c, kernels.stream(),
    )
    if per_clip:
        fused_apply_fwd.clip_launches += 1
    else:
        fused_apply_fwd.launches += 1
    return out


fused_apply_fwd.launches = 0
fused_apply_fwd.clip_launches = 0


def fused_apply_bwd(video_u8, delta, adv_flag, g) -> torch.Tensor:
    """B8 backward: d(delta) f32 of delta's shape ([T,1,1,C], or B8c's
    [B,T,1,1,C]) from the upstream gradient g.  `launches` counts the
    shared delta's launches, `clip_launches` B8c's."""
    _check(video_u8, delta, adv_flag)
    if g.shape != video_u8.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match the video {tuple(video_u8.shape)}")
    record("B8cb" if _per_clip(delta) else "B8b", 0,
           video_u8.numel() * (1 + 4) + (2 * delta.numel() + 1) * 4)
    if not video_u8.is_cuda:
        return fused_apply_bwd_plain(video_u8, delta, adv_flag, g)
    per_clip = _per_clip(delta)
    u8, d, f = _operands(video_u8, delta, adv_flag)
    b, t, h, w, c = u8.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"the backward kernel takes at most {MAX_CHANNELS} channels, got {c}")
    g = g.float().contiguous()
    kernels.check(g, dtype=torch.float32)
    row_len = h * w * c
    slices = max(1, -(-row_len // SLICE))
    partial = torch.empty((b * t, slices, c), dtype=torch.float32, device=u8.device)
    dd = torch.empty(delta.shape, dtype=torch.float32, device=u8.device)
    kernels.launch(
        "fav_fused_apply_clips_bwd" if per_clip else "fav_fused_apply_bwd", u8.data_ptr(),
        d.data_ptr(), f.data_ptr(), g.data_ptr(), partial.data_ptr(), dd.data_ptr(), b, t,
        row_len, c, slices, kernels.stream(),
    )
    if per_clip:
        fused_apply_bwd.clip_launches += 1
    else:
        fused_apply_bwd.launches += 1
    return dd


fused_apply_bwd.launches = 0
fused_apply_bwd.clip_launches = 0


class _FusedNormalizePerturb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, video_u8, delta, adv_flag, plain):
        ctx.save_for_backward(video_u8, delta, adv_flag)
        ctx.plain = plain
        return (fused_apply_fwd_plain if plain else fused_apply_fwd)(video_u8, delta, adv_flag)

    @staticmethod
    def backward(ctx, g):
        video_u8, delta, adv_flag = ctx.saved_tensors
        bwd = fused_apply_bwd_plain if ctx.plain else fused_apply_bwd
        d_delta = d_flag = None
        if ctx.needs_input_grad[1]:
            d_delta = bwd(video_u8, delta, adv_flag, g).to(delta.dtype)
        if ctx.needs_input_grad[2]:
            d_flag = torch.zeros_like(adv_flag)
        return None, d_delta, d_flag, None


def fused_normalize_perturb(video_u8, delta, adv_flag) -> torch.Tensor:
    """clip(u8/128-1 + adv_flag*delta, -1, 1) over uint8 [B,T,H,W,C] with
    delta [T,1,1,C] (already value-clipped and frame-masked), or [B,T,1,1,C]
    with a delta a clip (B8c), and a 0-d adv_flag tensor; f32 out, gradient
    to delta only (strict at the bounds, see the module's notes)."""
    return _FusedNormalizePerturb.apply(video_u8, delta, adv_flag, False)


def fused_normalize_perturb_plain(video_u8, delta, adv_flag) -> torch.Tensor:
    """The same function with the same backward in plain PyTorch, on any device."""
    return _FusedNormalizePerturb.apply(video_u8, delta, adv_flag, True)
