"""YAML config system, schema-compatible with the reference's run_config.yml.

The port's own copy of the JAX package's ``utils/config.py``: the reference
loads its YAML into an easydict with sections DATA / MODEL /
SINGLE_VIDEO_ATTACK / CLASS_GEN_ATTACK / UNIVERSAL_ATTACK.  `load_config`
accepts those exact files (``configs/run_config.yml`` loads unchanged);
`default_config` supplies the reference's documented defaults, key for key
the JAX package's, so a partial YAML (or none) still runs.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import yaml


class AttrDict(dict):
    """dict with attribute access (easydict equivalent, recursive)."""

    def __init__(self, d: Optional[Dict] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = AttrDict(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = AttrDict(value) if isinstance(value, dict) else value


_COMMON_ATTACK = {
    "TARGETED_ATTACK": False,
    "TARGETED_CLASS": "javelin throw",
    "IMPROVE_ADV_LOSS": True,
    "PROB_MARGIN": 0.05,
    "USE_LOGITS": False,
    "LAMBDA": 1.0,
    "BETA_1": 0.5,
    "BETA_2": 0.5,
    "CYCLIC_ATTACK": False,
    # attacked frame window [start, end] inclusive; null = full clip
    "ATTACK_FRAME_WINDOW": None,
    "NPY_PATH": "data/videos_for_tests/npy/",
    "MODEL_NAME": "i3d",
    "COMPUTE_DTYPE": "bfloat16",
    "LEARNING_RATE": 1e-3,
}

_DEFAULTS: Dict[str, Any] = {
    "DATA": {"LABEL_MAP_PATH": "data/label_map.txt"},
    "MODEL": {
        "CKPT_PATH": "data/checkpoints/rgb_imagenet/model.ckpt",
        "CKPT_PATH_WITH_ZERO_PERT": "data/checkpoints/rgb_imagenet_with_zero_pert/model_step_00000",
        # 'rgb' (Kinetics-400) or 'rgb600'; NUM_CLASSES overrides the head
        # size (None = from EVAL_TYPE/registry); LABEL_MAP_PATH overrides the
        # embedded label map
        "EVAL_TYPE": "rgb",
        "NUM_CLASSES": None,
        "LABEL_MAP_PATH": None,
    },
    "SINGLE_VIDEO_ATTACK": {
        **_COMMON_ATTACK,
        "MAX_NUM_STEP": 2500,
        "BATCH_SIZE": 1,
        "PKL_RESULT_PATH": "result/videos_for_tests/npy/",
        "TF_RECORDS_TRAIN_PATH": ["data/kinetics/database/tfrecord_uint8/val/"],
        "TF_RECORDS_VAL_PATH": ["data/kinetics/database/tfrecord_uint8/val/"],
    },
    "CLASS_GEN_ATTACK": {
        **_COMMON_ATTACK,
        "LAMBDA": 10.0,
        "MAX_NUM_STEP": 10000,
        "BATCH_SIZE": 8,
        "PKL_RESULT_PATH": "result/generalization/model_gen_one_class/",
        "TF_RECORDS_TRAIN_PATH": ["data/kinetics/database/tfrecord/test/hula hooping"],
        "TF_RECORDS_VAL_PATH": ["data/kinetics/database/tfrecord/test/hula hooping"],
        "NUM_OF_TRAIN_TF_RECORDS": 10,
        "NUM_OF_VAL_TF_RECORDS": 5,
        "NUM_OF_VID_EACH_TF_RECORDS": 100,
    },
    "UNIVERSAL_ATTACK": {
        **_COMMON_ATTACK,
        "FLICKERING_ATTACK": True,
        "TARGETED_CLASS": "welding",
        "MAX_NUM_STEP": 10000,
        "BATCH_SIZE": 8,
        "CYCLIC_PERTURBATION_ATTACK": False,
        "PKL_RESULT_PATH": "result/generalization/universal_untargeted/",
        "TF_RECORDS_TRAIN_PATH": ["data/kinetics/database/tfrecord/test_all_cls/"],
        "TF_RECORDS_VAL_PATH": ["data/kinetics/database/tfrecord/test_all_cls/"],
        "NUM_OF_TRAIN_TF_RECORDS": 21,
        "NUM_OF_VAL_TF_RECORDS": 40,
        "NUM_OF_VID_EACH_TF_RECORDS": 50,
    },
}


def default_config() -> AttrDict:
    return AttrDict(copy.deepcopy(_DEFAULTS))


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(yml_path: Optional[str] = None) -> AttrDict:
    """Load a run_config.yml (reference schema) over the defaults."""
    if yml_path is None:
        return default_config()
    with open(yml_path, "r") as f:
        loaded = yaml.safe_load(f) or {}
    return AttrDict(_merge(copy.deepcopy(_DEFAULTS), loaded))
