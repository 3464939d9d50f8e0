"""DeepMind I3D TF1 checkpoint -> the port's InceptionI3D state dict.

The port's counterpart of the JAX package's ``convert/tf_i3d.py``: the same
name translation, mapped straight to the state-dict keys that
``convert.flax_i3d.from_flax_variables`` produces, and the checkpoint read
by the port's own bundle reader (``convert/tf_bundle.py``), not by
TensorFlow.

Name translation (checkpoint -> Flax path -> state-dict key):
  RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w
      -> params / Conv3d_1a_7x7 / conv_3d / kernel
      -> Conv3d_1a_7x7.conv_3d.weight (DHWIO -> OIDHW)
  RGB/inception_i3d/Mixed_3b/Branch_0/Conv3d_0a_1x1/batch_norm/beta
      -> params / Mixed_3b / "Branch_0/Conv3d_0a_1x1" / batch_norm / bias
      -> Mixed_3b.Branch_0.Conv3d_0a_1x1.batch_norm.bias
  .../batch_norm/moving_mean|moving_variance
      -> batch_stats / ... / batch_norm / mean|var
      -> ....batch_norm.running_mean|running_var (sonnet's [1,1,1,1,C] -> [C])
  RGB/inception_i3d/Logits/Conv3d_0c_1x1/conv_3d/{w,b}
      -> params / "Logits/Conv3d_0c_1x1" / conv_3d / kernel|bias
      -> Logits.Conv3d_0c_1x1.conv_3d.weight|bias

The Kinetics-600 checkpoints (eval_type 'rgb600') name their variables
without the ``RGB/inception_i3d/`` prefix (the reference's
kinetics_i3d_utils.py:47-56).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PREFIX = "RGB/inception_i3d/"

_LEAF_MAP = {
    "w": ("params", "kernel"),
    "b": ("params", "bias"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
# Flax leaf -> state-dict leaf (the frozen BN keeps no scale)
_STATE_LEAF = {"kernel": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

_KNOWN_TOPS = frozenset(
    ["Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3", "Logits"]
    + [f"Mixed_{s}" for s in ("3b", "3c", "4b", "4c", "4d", "4e", "4f", "5b", "5c")]
)

EVAL_TYPES = ("rgb", "rgb600")


def _flax_path(ckpt_name: str, *, bare_names: bool = False):
    """A checkpoint variable name as (collection, Flax key path), or None
    for a variable that is not I3D's.

    bare_names handles the Kinetics-600 checkpoints, whose variables lack the
    RGB/inception_i3d/ prefix."""
    name = ckpt_name
    if name.endswith(":0"):
        name = name[:-2]
    if bare_names:
        if name.startswith(_PREFIX):
            name = name[len(_PREFIX):]
        parts = name.split("/")
        if parts[0] not in _KNOWN_TOPS:
            return None
        return _translate_parts(parts)
    if not name.startswith(_PREFIX):
        return None
    return _translate_parts(name[len(_PREFIX):].split("/"))


def _translate_parts(parts):
    # parts examples:
    #   [Conv3d_1a_7x7, conv_3d, w]
    #   [Mixed_3b, Branch_0, Conv3d_0a_1x1, batch_norm, beta]
    #   [Logits, Conv3d_0c_1x1, conv_3d, w]
    leaf = parts[-1]
    if leaf not in _LEAF_MAP:
        return None
    collection, flax_leaf = _LEAF_MAP[leaf]
    op = parts[-2]  # conv_3d | batch_norm
    if parts[0].startswith("Mixed_"):
        module_path = (parts[0], "/".join(parts[1:3]))
    elif parts[0] == "Logits":
        module_path = ("/".join(parts[0:2]),)
    else:
        module_path = (parts[0],)
    return collection, module_path + (op, flax_leaf)


def _state_key(path) -> str:
    *modules, op, leaf = path
    return ".".join([m.replace("/", ".") for m in modules] + [op, _STATE_LEAF[leaf]])


def convert_i3d_var_map(var_map: Mapping[str, Any], eval_type: str = "rgb") -> Dict[str, torch.Tensor]:
    """{checkpoint variable name: ndarray} -> the port's I3D state dict
    (float32 CPU tensors).

    eval_type='rgb600' takes the Kinetics-600 checkpoints' prefix-less
    names."""
    if eval_type not in EVAL_TYPES:
        raise ValueError(f"eval_type {eval_type!r}: choose from {EVAL_TYPES}")
    sd: Dict[str, torch.Tensor] = {}
    bare = eval_type == "rgb600"
    for name, value in var_map.items():
        translated = _flax_path(name, bare_names=bare)
        if translated is None:
            continue
        _, path = translated
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] in ("mean", "var", "bias") and arr.ndim > 1:
            arr = arr.reshape(-1)  # sonnet keeps BN stats as [1,1,1,1,C]
        if path[-1] == "kernel":
            arr = arr.transpose(4, 3, 0, 1, 2)  # [kT,kH,kW,in,out] -> [out,in,kT,kH,kW]
        sd[_state_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    if not sd:
        raise ValueError("no RGB/inception_i3d variables found in the map")
    return sd


def convert_i3d_checkpoint(ckpt_path: str, eval_type: str = "rgb") -> Dict[str, torch.Tensor]:
    """Read a TF checkpoint (its prefix) from disk and convert it; reads
    the I3D variables only."""
    from .tf_bundle import BundleReader

    reader = BundleReader(ckpt_path)
    bare = eval_type == "rgb600"
    var_map = {name: reader.tensor(name) for name in reader.names()
               if _flax_path(name, bare_names=bare) is not None}
    return convert_i3d_var_map(var_map, eval_type=eval_type)

