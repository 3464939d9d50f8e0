"""Weights for the port's VideoResNet from the JAX package's Flax variables,
and back.

``from_flax_variables`` maps the ``{'params', 'batch_stats'}`` tree of the
JAX package's ``models/video_resnet.VideoResNet`` (numpy arrays, or the
port's own ``.msgpack`` reader's leaves) onto the port's state dict, whose
names are torchvision's: conv kernels ``[kT,kH,kW,I,O]`` become OIDHW, Dense
``[I,O]`` becomes ``[O,I]``, a BN's ``scale``/``bias`` params and
``batch_stats`` ``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var`` (``num_batches_tracked`` 0).  ``to_flax_variables`` is the
inverse (numpy f32), what ``convert.cli.save_variables`` writes to a
``.msgpack``.  The map of names is the JAX package's
``convert/torch_video_resnet.py``'s, read the other way.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..models.video_resnet import _LAYER_COUNTS, VARIANTS


def layer_map(variant: str) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(torchvision prefix, 'conv' | 'bn', Flax module path) of every conv
    and BN of `variant`, stem to the last block ('fc' is separate)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: choose from {VARIANTS}")
    r2plus1 = variant.startswith("r2plus1d")
    if r2plus1:
        out = [("stem.0", "conv", ("stem", "conv_s")), ("stem.1", "bn", ("stem", "bn_s")),
               ("stem.3", "conv", ("stem", "conv_t")), ("stem.4", "bn", ("stem", "bn_t"))]
    else:
        out = [("stem.0", "conv", ("stem", "conv")), ("stem.1", "bn", ("stem", "bn"))]
    for layer, n in enumerate(_LAYER_COUNTS[variant.rsplit("_", 1)[1]], start=1):
        for b in range(n):
            tp, fp = f"layer{layer}.{b}", f"layer{layer}/block{b}"
            for c in (1, 2):
                if r2plus1:
                    out += [(f"{tp}.conv{c}.0.0", "conv", (fp, f"conv{c}", "conv_s")),
                            (f"{tp}.conv{c}.0.1", "bn", (fp, f"conv{c}", "bn_mid")),
                            (f"{tp}.conv{c}.0.3", "conv", (fp, f"conv{c}", "conv_t"))]
                else:
                    out.append((f"{tp}.conv{c}.0", "conv", (fp, f"conv{c}", "conv")))
                out.append((f"{tp}.conv{c}.1", "bn", (fp, f"bn{c}")))
            if layer > 1 and b == 0:  # the stride-2 block opening stages 2-4
                out += [(f"{tp}.downsample.0", "conv", (fp, "downsample_conv")),
                        (f"{tp}.downsample.1", "bn", (fp, "downsample_bn"))]
    return out


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bf16 leaf of a .msgpack (numpy has no bf16)
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def from_flax_variables(variables: Mapping[str, Any], variant: str) -> Dict[str, torch.Tensor]:
    if not {"params", "batch_stats"} <= set(variables) or "fc" not in variables["params"]:
        raise ValueError(f"not a Flax VideoResNet variables tree: keys {sorted(variables)}")
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for prefix, kind, path in layer_map(variant):
        if kind == "conv":
            sd[f"{prefix}.weight"] = _t(_get(params, path)["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
        else:
            p, s = _get(params, path), _get(stats, path)
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _t(p["scale"]), _t(p["bias"])
            sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = _t(s["mean"]), _t(s["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    sd["fc.weight"] = _t(params["fc"]["kernel"]).t().contiguous()
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def to_flax_variables(state: Mapping[str, torch.Tensor], variant: str) -> Dict[str, Any]:
    """The port's state dict as the JAX VideoResNet's ``{'params',
    'batch_stats'}`` tree of numpy f32 arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, leaf):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = leaf

    def np32(key):
        return state[key].detach().cpu().float().numpy()

    for prefix, kind, path in layer_map(variant):
        if kind == "conv":
            put(params, path, {"kernel": np32(f"{prefix}.weight").transpose(2, 3, 4, 1, 0).copy()})
        else:
            put(params, path, {"scale": np32(f"{prefix}.weight"), "bias": np32(f"{prefix}.bias")})
            put(stats, path, {"mean": np32(f"{prefix}.running_mean"),
                              "var": np32(f"{prefix}.running_var")})
    params["fc"] = {"kernel": np32("fc.weight").T.copy(), "bias": np32("fc.bias")}
    return {"params": params, "batch_stats": stats}
