"""Synthetic stand-ins for a DeepMind I3D checkpoint.

The port's own copy of the JAX package's ``convert/fake_assets.py``, cut to
``i3d_var_map``: a state dict of the port's InceptionI3D under the
reference checkpoint's variable names and layouts, the inverse of
``convert/tf_i3d.convert_i3d_var_map``.  The card has no TensorFlow with
which to write a checkpoint, so ``chip_smoke.py`` makes its real-victim
weights this way.
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
