"""Perturbation algebra of the tanh (TF/I3D) world.

Port of the JAX package's ``attack/perturbation.py`` (FlickerSpec,
SparseSpec, init_delta, clip_delta, frame_mask, apply_perturbation):
inputs live in [-1, 1]; delta is [T,1,1,C] (flickering, value-clipped to
+-0.4, initially 0) or [T,H,W,C] (the L1,2 sparse attack: no value clip,
initially 1e-8); it is gated by a frame window, optionally rolled
cyclically (the input on its time axis, delta on its own), added with a
scalar adv_flag, and the sum is clipped back to [input_min, input_max].
Clipping is minimum(maximum(x, lo), hi), whose gradient is 0.5 at an exact
bound, as jnp.clip's.

The rolls take their shifts as tensors (drawn on the device by
:func:`roll_shifts`; the JAX package draws them from a PRNG key), and roll
by an index gather, (arange(T) - s) mod T, which a CUDA graph can capture.
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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip semantics, including the 0.5 gradient at an exact bound."""
    # bounds as 0-d tensors made on the device (no host-to-device copy)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def init_delta(spec, device=None, dtype=torch.float32) -> torch.Tensor:
    """The reference's initial delta: zeros (flickering), 1e-8 (sparse)."""
    return torch.full(spec.shape, getattr(spec, "init_scale", 0.0), dtype=dtype, device=device)


def clip_delta(spec, delta: torch.Tensor) -> torch.Tensor:
    """The value clip at +-clip_eps; none for a spec without one (sparse)."""
    if spec.clip_eps is None:
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
    x[(i - shift) mod n] along `axis`, as an index gather."""
    n = x.shape[axis]
    index = torch.remainder(torch.arange(n, device=x.device) - shift, n)
    return x.index_select(axis, index)


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
    uniform in [0, delta_frames)), as 0-d int64 tensors on the device, a
    function of (seed, counter) alone: the port's counterpart of
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
    are compiled in only with a key)."""
    d = clip_delta(spec, delta).to(clean.dtype)
    if mask is not None:
        d = d * mask.to(clean.dtype)
    if shifts is not None:
        shift_in, shift_pert = shifts
        clean_rolled = roll_time(clean, shift_in, axis=1)
        delta_rolled = roll_time(d, shift_pert, axis=0)
        cf = torch.as_tensor(cyclic_flag, dtype=clean.dtype, device=clean.device)
        cpf = torch.as_tensor(cyclic_pert_flag, dtype=clean.dtype, device=clean.device)
        clean = cf * clean_rolled + (1.0 - cf) * clean
        d = cpf * delta_rolled + (1.0 - cpf) * d
    if not torch.is_tensor(adv_flag):
        adv_flag = clean.new_full((), float(adv_flag))
    adv = clean + adv_flag.to(clean.dtype) * d[None]
    return clip(adv, spec.input_min, spec.input_max)
