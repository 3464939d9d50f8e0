"""Perturbation algebra of the tanh (TF/I3D) world over the flickering delta.

Port of the JAX package's ``attack/perturbation.py`` (FlickerSpec, init_delta,
clip_delta, frame_mask, apply_perturbation) for the flickering attack:
inputs live in [-1, 1], delta is [T,1,1,C], value-clipped to +-0.4, gated by
a frame window and a scalar adv_flag, and the sum is clipped back to
[input_min, input_max].  Clipping is minimum(maximum(x, lo), hi), whose
gradient is 0.5 at an exact bound, as jnp.clip's.
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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip semantics, including the 0.5 gradient at an exact bound."""
    # bounds as 0-d tensors made on the device (no host-to-device copy)
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def init_delta(spec: FlickerSpec, device=None, dtype=torch.float32) -> torch.Tensor:
    """The reference initializes the flickering delta to zeros."""
    return torch.zeros(spec.shape, dtype=dtype, device=device)


def clip_delta(spec: FlickerSpec, delta: torch.Tensor) -> torch.Tensor:
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


def apply_perturbation(
    clean: torch.Tensor,
    delta: torch.Tensor,
    spec: FlickerSpec,
    adv_flag: float | torch.Tensor = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """clip(clean + adv_flag * mask * clip(delta), input_min, input_max);
    clean [B,T,H,W,C] in [-1, 1]."""
    d = clip_delta(spec, delta).to(clean.dtype)
    if mask is not None:
        d = d * mask.to(clean.dtype)
    if not torch.is_tensor(adv_flag):
        adv_flag = clean.new_full((), float(adv_flag))
    adv = clean + adv_flag.to(clean.dtype) * d[None]
    return clip(adv, spec.input_min, spec.input_max)
