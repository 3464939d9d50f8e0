"""Perturbation algebra of the tanh (TF/I3D) and mean/std (torch) worlds.

Port of the JAX package's ``attack/perturbation.py`` (FlickerSpec,
SparseSpec, TorchStyleFlickerSpec, init_delta, clip_delta, frame_mask,
apply_perturbation, apply_perturbation_torch_style).  Tanh world: inputs
live in [-1, 1]; delta is [T,1,1,C] (flickering, value-clipped to
+-0.4, initially 0) or [T,H,W,C] (the L1,2 sparse attack: no value clip,
initially 1e-8); it is gated by a frame window, optionally rolled
cyclically (the input on its time axis, delta on its own), added with a
scalar adv_flag, and the sum is clipped back to [input_min, input_max].
Clipping is minimum(maximum(x, lo), hi), whose gradient is 0.5 at an exact
bound, as jnp.clip's.

Mean/std world (the video ResNets): inputs are (x/255 - mean)/std; delta is
[T,1,1,C] in [0, 1] pixel units, initially U(-init_scale, init_scale),
clamped to +-max_norm (a runtime value: the per-video sweep escalates it),
divided by std, optionally rolled in time, added with adv_flag, and the sum
clamped to the scalar range of :attr:`TorchStyleFlickerSpec.clamp_range`.
The initial draw comes from a ``torch.Generator``, not from threefry.

The rolls take their shifts as tensors (drawn on the device by
:func:`roll_shifts`; the JAX package draws them from a PRNG key), and roll
by an index gather, (arange(T) - s) mod T, which a CUDA graph can capture.

The vectorized sweep's slots: :func:`apply_perturbation` and
:func:`apply_perturbation_torch_style` also take a delta with a slot axis,
[N, *spec.shape] against clips [N, T, H, W, 3] (slot i's delta perturbs clip
i), with per-slot shifts [N] and, in the mean/std world, a per-slot max_norm
[N]; :func:`roll_shifts` draws per-slot shifts from per-slot seeds and
counters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FlickerSpec:
    """Flickering delta in the [-1, 1] world: shape [frames, 1, 1, channels]."""

    frames: int
    channels: int = 3
    clip_eps: float = 0.4
    input_min: float = -1.0
    input_max: float = 1.0

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.frames, 1, 1, self.channels)


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    """Full [frames, height, width, channels] delta of the L1,2 sparse
    attack: initially 1e-8 everywhere, no value clip."""

    frames: int
    height: int = 224
    width: int = 224
    channels: int = 3
    input_min: float = -1.0
    input_max: float = 1.0
    init_scale: float = 1e-8
    clip_eps: Optional[float] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.frames, self.height, self.width, self.channels)


@dataclasses.dataclass(frozen=True)
class TorchStyleFlickerSpec:
    """Flickering delta of the mean/std world: [frames, height, width,
    channels] ([T,1,1,C] unless a full-frame variant is asked for), in [0, 1]
    pixel units, clamped to +-max_norm, initially U(-init_scale,
    init_scale); the Kinetics statistics by default."""

    frames: int
    channels: int = 3
    height: int = 1
    width: int = 1
    max_norm: float = 1.0
    mean: Tuple[float, ...] = (0.43216, 0.394666, 0.37645)
    std: Tuple[float, ...] = (0.22803, 0.22145, 0.216989)
    init_scale: float = 1e-6

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.frames, self.height, self.width, self.channels)

    @property
    def clamp_range(self) -> Tuple[float, float]:
        """Scalar bounds of the adversarial input in normalized units, the
        reference's reduction over channels: (max_c (0 - mean_c)/std_c,
        min_c (1 - mean_c)/std_c), each computed in f64 as numpy does."""
        lo = max((0.0 - m) / s for m, s in zip(self.mean, self.std))
        hi = min((1.0 - m) / s for m, s in zip(self.mean, self.std))
        return float(lo), float(hi)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip semantics, including the 0.5 gradient at an exact bound.
    `lo`, `hi`: Python floats, or 0-d tensors (a runtime bound on the device)."""

    def bound(b):  # 0-d tensors on the device (no host-to-device copy)
        return b.to(x.dtype) if torch.is_tensor(b) else x.new_full((), b)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def init_delta(spec, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The reference's initial delta: zeros (flickering), 1e-8 (sparse),
    U(-init_scale, init_scale) (mean/std world) from `generator` (a CPU
    generator; seeded 0 when None, as the JAX package's default key)."""
    if isinstance(spec, TorchStyleFlickerSpec):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand(spec.shape, generator=generator, dtype=dtype) * 2.0 - 1.0
        return (u * spec.init_scale).to(device)
    return torch.full(spec.shape, getattr(spec, "init_scale", 0.0), dtype=dtype, device=device)


def clip_delta(spec, delta: torch.Tensor) -> torch.Tensor:
    """The value clip at +-clip_eps; none for a spec without one (sparse)."""
    if getattr(spec, "clip_eps", None) is None:
        return delta
    return clip(delta, -spec.clip_eps, spec.clip_eps)


def frame_mask(
    num_frames: int, start: int = 0, end: Optional[int] = None, device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """[T,1,1,1] indicator of the attacked frames [start, end] (inclusive)."""
    if end is None:
        end = num_frames
    t = torch.arange(num_frames, device=device)
    return ((t >= start) & (t <= end)).to(dtype).reshape(num_frames, 1, 1, 1)


def roll_time(x: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.roll(x, shift, axis) for a 0-d integer tensor `shift`: out[i] =
    x[(i - shift) mod n] along `axis`, as an index gather.  A shift [N] rolls
    each x[j] along axis 1 by its own shift[j] (the slots' rolls)."""
    n = x.shape[axis]
    if shift.dim() == 0:
        index = torch.remainder(torch.arange(n, device=x.device) - shift, n)
        return x.index_select(axis, index)
    if axis != 1:
        raise ValueError("per-slot shifts roll axis 1 (time after the slot axis)")
    index = torch.remainder(torch.arange(n, device=x.device) - shift[:, None], n)
    index = index.reshape(index.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, index)


def _per_slot(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-slot [N] tensor shaped to broadcast against [N, ...] of `ndim`
    dims; a 0-d tensor as it is."""
    return t.reshape(t.shape + (1,) * (ndim - 1)) if t.dim() == 1 else t


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) on int64 tensors
    holding values below 2**32: no product leaves 63 bits."""
    mask = 0xFFFFFFFF
    x = x & mask
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x45D9F3B) & mask
    return x ^ (x >> 16)


def roll_shifts(seed: torch.Tensor, counter: torch.Tensor, frames: int, delta_frames: int):
    """The cyclic rolls' two shifts, (input uniform in [0, frames), delta
    uniform in [0, delta_frames)), as int64 tensors on the device (0-d, or
    [N] from per-slot seeds and counters [N]), a function of (seed, counter)
    alone, elementwise: the port's counterpart of
    ``jax.random.split(fold_in(key(seed), step))`` and ``randint``.  Its
    stream is not threefry's; no host value is read, so a CUDA graph that
    advances `counter` on the device draws new shifts each replay."""
    base = _mix(seed.long() * 0x27D4EB2F + _mix(counter.long() + 0x165667B1))
    return (torch.remainder(_mix(base ^ 0x3C6EF372), frames),
            torch.remainder(_mix(base ^ 0x0B4F1E27), delta_frames))


def apply_perturbation(
    clean: torch.Tensor,
    delta: torch.Tensor,
    spec,
    adv_flag: float | torch.Tensor = 1.0,
    mask: Optional[torch.Tensor] = None,
    cyclic_flag: float | torch.Tensor = 0.0,
    cyclic_pert_flag: float | torch.Tensor = 0.0,
    shifts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """clip(clean' + adv_flag * delta', input_min, input_max); clean
    [B,T,H,W,C] in [-1, 1].  Without `shifts`, clean' = clean and delta' =
    mask * clip(delta); with `shifts` (input shift, delta shift), each is
    blended with its roll, ``flag * rolled + (1 - flag) * plain``, with
    exactly that arithmetic in clean's dtype (the JAX package's, whose rolls
    are compiled in only with a key).  A slotted delta [N, *spec.shape]
    perturbs clip i by delta[i]; its shifts are then [N]."""
    slotted = delta.dim() == clean.dim()
    d = clip_delta(spec, delta).to(clean.dtype)
    if mask is not None:
        d = d * mask.to(clean.dtype)
    if shifts is not None:
        shift_in, shift_pert = shifts
        clean_rolled = roll_time(clean, shift_in, axis=1)
        delta_rolled = roll_time(d, shift_pert, axis=1 if slotted else 0)
        cf = torch.as_tensor(cyclic_flag, dtype=clean.dtype, device=clean.device)
        cpf = torch.as_tensor(cyclic_pert_flag, dtype=clean.dtype, device=clean.device)
        clean = cf * clean_rolled + (1.0 - cf) * clean
        d = cpf * delta_rolled + (1.0 - cpf) * d
    if not torch.is_tensor(adv_flag):
        adv_flag = clean.new_full((), float(adv_flag))
    adv = clean + adv_flag.to(clean.dtype) * (d if slotted else d[None])
    return clip(adv, spec.input_min, spec.input_max)


def apply_perturbation_torch_style(
    clean_normalized: torch.Tensor,
    delta: torch.Tensor,
    spec: TorchStyleFlickerSpec,
    adv_flag: float | torch.Tensor = 1.0,
    max_norm: float | torch.Tensor | None = None,
    cyclic_pert_flag: float | torch.Tensor = 0.0,
    shift: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The adversarial input of the mean/std world: clip delta to
    +-max_norm (the spec's when None), divide by std, blend it with its roll
    by `shift` (``cyclic_pert_flag * rolled + (1 - flag) * plain``, only
    with a shift), add adv_flag * delta, clip to the spec's scalar range;
    clean_normalized [B,T,H,W,C], arithmetic in its dtype.  `std`: the
    spec's std as a tensor on the device, made once by a caller that runs
    under a CUDA graph capture (which copies no host value); None makes it.
    A slotted delta [N, *spec.shape] perturbs clip i by delta[i], clamped to
    its own max_norm[i] (a max_norm [N]) and rolled by its own shift[i]."""
    dt = clean_normalized.dtype
    slotted = delta.dim() == clean_normalized.dim()
    if max_norm is None:
        max_norm = spec.max_norm
    if torch.is_tensor(max_norm):
        m = _per_slot(max_norm.to(dt), delta.dim())
    else:
        m = clean_normalized.new_full((), max_norm)
    d = clip(delta.to(dt), -m, m)
    if std is None:
        std = torch.tensor(spec.std, device=d.device)
    d = d / std.to(dt)
    if shift is not None:
        cpf = torch.as_tensor(cyclic_pert_flag, dtype=dt, device=d.device)
        d = cpf * roll_time(d, shift, axis=1 if slotted else 0) + (1.0 - cpf) * d
    if not torch.is_tensor(adv_flag):
        adv_flag = clean_normalized.new_full((), float(adv_flag))
    lo, hi = spec.clamp_range
    return clip(clean_normalized + adv_flag.to(dt) * (d if slotted else d[None]), lo, hi)
