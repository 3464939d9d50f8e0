"""Victim-model registry.

The port's counterpart of the JAX package's ``models/registry.py``: maps the
reference's model-selection string to a model factory, its input
normalization world and its canonical geometry.  The I3D entry is here; the
video-ResNet entries ('r3d_18', 'mc3_18', 'r2plus1d_18', 'r2plus1d_34') come
with those models.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .i3d import InceptionI3D


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """name -> factory + canonical input geometry + normalization world."""

    factory: Callable[..., Any]
    # 'tanh' = [-1, 1] via x/128-1 (I3D)
    norm_world: str
    default_frames: int
    default_size: int
    num_classes: int = 400


def _i3d_factory(num_classes=400, compute_dtype=torch.float32, device=None, pair_pools=()):
    return InceptionI3D(
        num_classes=num_classes, compute_dtype=compute_dtype, device=device, pair_pools=pair_pools
    )


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    # I3D: 90-frame 224x224 clips
    "i3d": ModelSpec(_i3d_factory, "tanh", 90, 224),
}


def create_model(
    name: str, num_classes: Optional[int] = None, compute_dtype=torch.float32, device=None,
    pair_pools=(),
) -> Tuple[Any, ModelSpec]:
    """`pair_pools`: the I3D pools routed through the index pair (kernel B9)."""
    spec = MODEL_REGISTRY[name]
    model = spec.factory(
        num_classes=num_classes or spec.num_classes, compute_dtype=compute_dtype, device=device,
        pair_pools=tuple(pair_pools),
    )
    return model, spec
