"""Synthetic stand-ins for the reference's checkpoints.

The port's own copy of the JAX package's ``convert/fake_assets.py``, cut to
``i3d_var_map`` (a state dict of the port's InceptionI3D under the DeepMind
checkpoint's variable names and layouts, the inverse of
``convert/tf_i3d.convert_i3d_var_map``), ``video_resnet_state_dict`` and
``write_torchvision_pth`` (a seeded torchvision ``video_resnet`` state
dict, and a ``.pth`` of it).  The card has neither TensorFlow nor
torchvision, so ``chip_smoke.py`` makes its real-victim weights this way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_SONNET_STAT_LAYOUT = (1, 1, 1, 1)  # moving stats are [1,1,1,1,C] in the ckpt
_LEAF = {"weight": "w", "running_mean": "moving_mean", "running_var": "moving_variance"}


def i3d_var_map(state: Mapping[str, torch.Tensor], bare_names: bool = False) -> Dict[str, np.ndarray]:
    """The reference checkpoint's names (``RGB/inception_i3d/<module>/{w,b,
    beta,moving_*}``) holding the state dict's values, so that the converted
    state round-trips exactly: OIDHW kernels as DHWIO, BN statistics as
    [1,1,1,1,C].

    bare_names=True gives the Kinetics-600 checkpoints' prefix-less names."""
    prefix = "" if bare_names else "RGB/inception_i3d/"
    var_map: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, op, leaf = key.split(".")
        value = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            value = value.transpose(2, 3, 4, 1, 0)
        elif leaf in ("running_mean", "running_var"):
            value = value.reshape(_SONNET_STAT_LAYOUT + value.shape)
        name = _LEAF.get(leaf, "beta" if op == "batch_norm" else "b")
        var_map[f"{prefix}{'/'.join(modules)}/{op}/{name}"] = np.ascontiguousarray(value)
    return var_map


def video_resnet_state_dict(variant: str, num_classes: int = 400, seed: int = 0) -> Dict[str, np.ndarray]:
    """A torchvision-layout state dict (numpy) of `variant` from a numpy
    seed: conv kernels He-normal (std sqrt(2 / fan_in)), BN scale and
    variance in [0.5, 1.5), BN bias and mean N(0, 0.1), ``fc`` N(0, 0.001)
    with a zero bias (the features grow to ~20-30 by layer4 without trained
    statistics; this keeps the logits near unit scale, so the softmax does
    not saturate and an attack has a gradient); ``num_batches_tracked`` 0.  The JAX package's
    counterpart inverts its converter over a Flax init; the port draws its
    own (the card has no JAX)."""
    from ..models.video_resnet import state_shapes

    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for key, shape in state_shapes(variant, num_classes).items():
        leaf = key.rsplit(".", 1)[1]
        if key.startswith("fc."):
            v = rng.normal(0, 0.001, shape) if leaf == "weight" else np.zeros(shape)
        elif leaf == "num_batches_tracked":
            sd[key] = np.asarray(0, np.int64)
            continue
        elif len(shape) == 5:
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif leaf in ("weight", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        sd[key] = v.astype(np.float32)
    return sd


def write_torchvision_pth(path: str, variant: str, num_classes: int = 400, seed: int = 0) -> str:
    """``torch.save`` of :func:`video_resnet_state_dict` (torch tensors), as
    torchvision's ``model.state_dict()`` would be saved."""
    sd = video_resnet_state_dict(variant, num_classes=num_classes, seed=seed)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path
