"""Victim-model registry.

The port's counterpart of the JAX package's ``models/registry.py``: maps the
reference's model-selection string ('i3d' for the TF stack; 'r3d_18',
'mc3_18', 'r2plus1d_18', 'r2plus1d_34' for the torch stack) to a model
factory, its input normalization world and its canonical geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .i3d import InceptionI3D
from .video_resnet import VideoResNet

# Kinetics statistics of the torch world
KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """name -> factory + canonical input geometry + normalization world."""

    factory: Callable[..., Any]
    # 'tanh' = [-1, 1] via x/128-1 (I3D); 'meanstd' = (x/255-mean)/std (torch)
    norm_world: str
    default_frames: int
    default_size: int
    num_classes: int = 400


def _i3d_factory(num_classes=400, compute_dtype=torch.float32, device=None, pair_pools=()):
    return InceptionI3D(
        num_classes=num_classes, compute_dtype=compute_dtype, device=device, pair_pools=pair_pools
    )


def _vr_factory(variant):
    def make(num_classes=400, compute_dtype=torch.float32, device=None, pair_pools=()):
        if pair_pools:
            raise ValueError(f"pair_pools {tuple(pair_pools)}: {variant} has no max-pool")
        return VideoResNet(variant, num_classes, compute_dtype, device)

    return make


MODEL_REGISTRY: Dict[str, ModelSpec] = {
    # I3D: 90-frame 224x224 clips
    "i3d": ModelSpec(_i3d_factory, "tanh", 90, 224),
    # torch models: 16-frame 112x112 clips; r2plus1d_34 (the torch.hub
    # ig65m/kinetics victims) 32 frames
    "r3d_18": ModelSpec(_vr_factory("r3d_18"), "meanstd", 16, 112),
    "mc3_18": ModelSpec(_vr_factory("mc3_18"), "meanstd", 16, 112),
    "r2plus1d_18": ModelSpec(_vr_factory("r2plus1d_18"), "meanstd", 16, 112),
    "r2plus1d_34": ModelSpec(_vr_factory("r2plus1d_34"), "meanstd", 32, 112),
}


def create_model(
    name: str, num_classes: Optional[int] = None, compute_dtype=torch.float32, device=None,
    pair_pools=(),
) -> Tuple[Any, ModelSpec]:
    """`pair_pools`: the I3D pools routed through the index pair (kernel B9);
    none for a video ResNet."""
    spec = MODEL_REGISTRY[name]
    model = spec.factory(
        num_classes=num_classes or spec.num_classes, compute_dtype=compute_dtype, device=device,
        pair_pools=tuple(pair_pools),
    )
    return model, spec
