"""Weights for the port's InceptionI3D: from a Flax variables tree, or random.

``from_flax_variables`` maps the ``{'params', 'batch_stats'}`` tree of the JAX
package's I3D (``models/i3d.py:init_i3d_params``, as numpy arrays) onto the
port's state dict: DHWIO conv kernels become OIDHW, the frozen BN's
``{mean, var}`` stats and ``bias`` param become ``running_mean``,
``running_var`` and ``bias`` (no scale; eps 1e-3 is the model's), and the
Logits conv keeps its bias.  A Flax module name with '/' (``Branch_1/...``,
``Logits/Conv3d_0c_1x1``) is one level of the port's module tree per part.

``to_flax_variables`` is the inverse: the state dict as the Flax tree (numpy
f32), what ``convert.cli.save_variables`` writes to a ``.msgpack``.

``init_i3d_state`` makes a random state dict from a numpy seed, for the card
where JAX is absent: conv kernels LeCun-normal (std 1/sqrt(fan_in)), BN and
biases at their Flax initial values.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bf16 leaf of a .msgpack (numpy has no bf16)
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if not {"params", "batch_stats"} <= set(variables):
        raise ValueError(f"not a Flax I3D variables tree: keys {sorted(variables)}, "
                         "need 'params' and 'batch_stats'")
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


def to_flax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict as the JAX I3D's ``{'params', 'batch_stats'}``
    tree of numpy f32 arrays (conv kernels DHWIO)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in state.items():
        *path, leaf_module, leaf = key.split(".")
        # a Mixed block holds its units one level down, named Branch_k/Conv...
        unit = [path[0], "/".join(path[1:])] if path[0].startswith("Mixed_") else ["/".join(path)]
        a = value.detach().cpu().float().numpy()
        if leaf_module == "conv_3d":
            tree, name = params, "kernel" if leaf == "weight" else "bias"
            if leaf == "weight":
                a = a.transpose(2, 3, 4, 1, 0)
        elif leaf == "bias":
            tree, name = params, "bias"
        else:
            tree, name = stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        for part in unit:
            tree = tree.setdefault(part, {})
        tree.setdefault(leaf_module, {})[name] = np.ascontiguousarray(a)
    return {"params": params, "batch_stats": stats}


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


def attack_state_from_jax(delta, mu, nu, count):
    """The JAX engine's attack state as the port's: delta and the Adam
    moments (``state.opt_state.inner_state[0].mu`` / ``.nu``) as numpy arrays
    [T,1,1,C], and the step count, -> :class:`AttackState` on the CPU."""
    from ..engine.attack_step import AttackState

    return AttackState(_t(delta), _t(mu), _t(nu), int(count))


def attack_state_to_jax(state):
    """The inverse: (delta, mu, nu, count) as numpy arrays and an int."""
    sd = state.state_dict()
    return sd["delta"].numpy(), sd["mu"].numpy(), sd["nu"].numpy(), sd["step"]
