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
* d(adv_flag) is zeros (the flag is a constant gate), None for the video.

**The clip's gradient follows the JAX call's geometry.**  The JAX
``fused_normalize_perturb`` takes its Pallas kernel only where its
``_supported`` holds (``H*W*C % 128 == 0`` and ``B*T % 8 == 0``, Mosaic's
block constraints; :123) and otherwise runs ``_jnp_reference`` with
``jax.vjp``'s gradient (:47, :170).  The two differ at an exact bound: the
Pallas backward masks strictly (0 there), ``jnp.clip`` gives 0.5.  u8 value
0 under delta 0 sits exactly on -1, so a clip with a black pixel tells them
apart from the first step.  The port keeps its own copy of the predicate
(:func:`strict_rule`) and takes the rule as an argument, ``strict``: the
kernel's mask where the JAX call takes its kernel, ``jnp.clip``'s elsewhere
(g inside, g/2 on a bound, 0 outside).  The rule is all that follows the
geometry: the port's kernel runs at every geometry, with no fallback.
``strict=None`` takes the rule of the JAX call on this video (one clip,
[1,T,H,W,C], for a delta a clip: the JAX sweep vmaps the call over the
slots); the engine passes the global batch's under a mesh.

The backward is deterministic: per-block partials in a fixed order, then a
second kernel that sums them in a fixed order; it agrees with the plain
version to f32 sum order (about 1e-5 of the largest component at
[8,64,224,224,3]; g/2 is exact in f32, so the rule changes no rounding).
Both kernels are bound by bytes on the H100.

B8c, a delta a clip (the vectorized sweep's slots): with delta
[B,T,1,1,C], clip b of the batch takes row b (the JAX sweep's
``jax.vmap`` of ``fused_normalize_perturb`` over the slots, the flag
shared), and the backward gives d(delta) [B,T,1,1,C], each clip's masked
reduction over (H, W) alone.  The same kernel bodies with a delta clip
stride (``csrc/fused_apply.cu``), under launchers and kernel names of
their own; the wrappers count these launches apart, as ``clip_launches``
(``launches`` counts the shared delta's).  A clip's forward and d(delta)
are bit for bit the shared-delta kernels' on that clip alone, under
either rule.
"""

from __future__ import annotations

import torch

from . import kernels
from .accounting import record

SLICE = 16 * 256 * 4   # elements of a row per backward block; csrc kSlice
MAX_CHANNELS = 4       # csrc kMaxC
LANES, ROW_BLOCK = 128, 8  # the JAX package's _LANES, _ROW_BLOCK


def strict_rule(video_shape) -> bool:
    """Does the JAX package's ``fused_normalize_perturb`` on a uint8 video
    of `video_shape` [B,T,H,W,C] take its Pallas kernel, and so the strict
    mask?  (Its ``_supported``, ``ops/fused_apply.py:123``.)  Elsewhere it
    runs ``_jnp_reference``, whose gradient is ``jnp.clip``'s."""
    b, t, h, w, c = video_shape
    return (h * w * c) % LANES == 0 and (b * t) % ROW_BLOCK == 0


def _per_clip(delta: torch.Tensor) -> bool:
    return delta.dim() == 5


def _strict(video_u8, delta, strict) -> bool:
    """`strict`, or where None the rule of the JAX call on this video (on
    one clip of it for a delta a clip: the JAX sweep's vmapped call)."""
    if strict is not None:
        return bool(strict)
    shape = tuple(video_u8.shape)
    return strict_rule((1,) + shape[1:] if _per_clip(delta) else shape)


def _pre(video_u8: torch.Tensor, delta: torch.Tensor, adv_flag: torch.Tensor) -> torch.Tensor:
    x = video_u8.float() * (1.0 / 128.0) - 1.0
    d = delta.float() if _per_clip(delta) else delta.float()[None]
    return x + adv_flag.float() * d


def fused_apply_fwd_plain(video_u8, delta, adv_flag) -> torch.Tensor:
    return _pre(video_u8, delta, adv_flag).clamp(-1.0, 1.0)


def fused_apply_bwd_plain(video_u8, delta, adv_flag, g, strict=None) -> torch.Tensor:
    pre = _pre(video_u8, delta, adv_flag)
    g = g.float()
    zero = g.new_zeros(())
    edge = zero if _strict(video_u8, delta, strict) else 0.5 * g
    v = torch.where((pre < 1.0) & (pre > -1.0), g,
                    torch.where((pre == 1.0) | (pre == -1.0), edge, zero))
    dims = (2, 3) if _per_clip(delta) else (0, 2, 3)
    return (adv_flag.float() * v.sum(dim=dims)).reshape(delta.shape)


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


def fused_apply_bwd(video_u8, delta, adv_flag, g, strict=None) -> torch.Tensor:
    """B8 backward: d(delta) f32 of delta's shape ([T,1,1,C], or B8c's
    [B,T,1,1,C]) from the upstream gradient g, under the clip rule `strict`
    (see the module's notes; None: the JAX call's on this video).
    `launches` counts the shared delta's launches, `clip_launches` B8c's."""
    _check(video_u8, delta, adv_flag)
    if g.shape != video_u8.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match the video {tuple(video_u8.shape)}")
    record("B8cb" if _per_clip(delta) else "B8b", 0,
           video_u8.numel() * (1 + 4) + (2 * delta.numel() + 1) * 4)
    strict = _strict(video_u8, delta, strict)
    if not video_u8.is_cuda:
        return fused_apply_bwd_plain(video_u8, delta, adv_flag, g, strict)
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
        row_len, c, slices, int(strict), kernels.stream(),
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
    def forward(ctx, video_u8, delta, adv_flag, plain, strict):
        ctx.save_for_backward(video_u8, delta, adv_flag)
        ctx.plain, ctx.strict = plain, strict
        return (fused_apply_fwd_plain if plain else fused_apply_fwd)(video_u8, delta, adv_flag)

    @staticmethod
    def backward(ctx, g):
        video_u8, delta, adv_flag = ctx.saved_tensors
        bwd = fused_apply_bwd_plain if ctx.plain else fused_apply_bwd
        d_delta = d_flag = None
        if ctx.needs_input_grad[1]:
            d_delta = bwd(video_u8, delta, adv_flag, g, ctx.strict).to(delta.dtype)
        if ctx.needs_input_grad[2]:
            d_flag = torch.zeros_like(adv_flag)
        return None, d_delta, d_flag, None, None


def fused_normalize_perturb(video_u8, delta, adv_flag, strict=None) -> torch.Tensor:
    """clip(u8/128-1 + adv_flag*delta, -1, 1) over uint8 [B,T,H,W,C] with
    delta [T,1,1,C] (already value-clipped and frame-masked), or [B,T,1,1,C]
    with a delta a clip (B8c), and a 0-d adv_flag tensor; f32 out, gradient
    to delta only, at an exact bound 0 where `strict` and g/2 where not
    (None: the rule of the JAX call on this video; see the module's notes)."""
    return _FusedNormalizePerturb.apply(video_u8, delta, adv_flag, False, strict)


def fused_normalize_perturb_plain(video_u8, delta, adv_flag, strict=None) -> torch.Tensor:
    """The same function with the same backward in plain PyTorch, on any device."""
    return _FusedNormalizePerturb.apply(video_u8, delta, adv_flag, True, strict)
