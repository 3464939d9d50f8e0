"""Weights for the port's InceptionI3D: from a Flax variables tree, or random.

``from_flax_variables`` maps the ``{'params', 'batch_stats'}`` tree of the JAX
package's I3D (``models/i3d.py:init_i3d_params``, as numpy arrays) onto the
port's state dict: DHWIO conv kernels become OIDHW, the frozen BN's
``{mean, var}`` stats and ``bias`` param become ``running_mean``,
``running_var`` and ``bias`` (no scale; eps 1e-3 is the model's), and the
Logits conv keeps its bias.  A Flax module name with '/' (``Branch_1/...``,
``Logits/Conv3d_0c_1x1``) is one level of the port's module tree per part.

``init_i3d_state`` makes a random state dict from a numpy seed, for the card
where JAX is absent: conv kernels LeCun-normal (std 1/sqrt(fan_in)), BN and
biases at their Flax initial values.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def unit(prefix: str, p, s) -> None:
        sd[f"{prefix}.conv_3d.weight"] = _t(np.asarray(p["conv_3d"]["kernel"]).transpose(4, 3, 0, 1, 2))
        if "bias" in p["conv_3d"]:
            sd[f"{prefix}.conv_3d.bias"] = _t(p["conv_3d"]["bias"])
        if "batch_norm" in p:
            sd[f"{prefix}.batch_norm.bias"] = _t(p["batch_norm"]["bias"])
            sd[f"{prefix}.batch_norm.running_mean"] = _t(s["batch_norm"]["mean"])
            sd[f"{prefix}.batch_norm.running_var"] = _t(s["batch_norm"]["var"])

    for name, p in params.items():
        if "conv_3d" in p:  # a unit at the top level (stem, 2b, 2c, logits)
            unit(name.replace("/", "."), p, stats.get(name, {}))
        else:  # a Mixed block of units
            for sub, q in p.items():
                unit(f"{name}.{sub.replace('/', '.')}", q, stats[name][sub])
    return sd


def init_i3d_state(seed: int = 0, num_classes: int = 400) -> Dict[str, torch.Tensor]:
    """Random weights from numpy's generator: conv kernels ~ N(0, 1/fan_in);
    BN mean 0, var 1, biases 0."""
    from ..models.i3d import state_shapes

    rng = np.random.default_rng(seed)
    sd: Dict[str, torch.Tensor] = {}
    for key, shape in state_shapes(num_classes).items():
        if key.endswith("conv_3d.weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(fan_in))
        elif key.endswith("running_var"):
            a = np.ones(shape, np.float32)
        else:
            a = np.zeros(shape, np.float32)
        sd[key] = torch.from_numpy(a)
    return sd
