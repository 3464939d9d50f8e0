"""Result artifacts (.pkl / .npy) in the reference's schemas.

The port's own copy of the JAX package's ``viz/results.py``.  Filename
convention: '{class}_beta1_{b1}_th_{thickness%:.2f}%_rg_{roughness%:.2f}%.pkl'.
Results hold numpy arrays and Python scalars only, so a pkl loads where
neither torch nor a GPU is present.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np


def result_filename(
    class_name: str, beta1: float, thickness_pct: float, roughness_pct: float
) -> str:
    return "{}_beta1_{}_th_{:.2f}%_rg_{:.2f}%.pkl".format(
        class_name.replace(" ", "_"), beta1, thickness_pct, roughness_pct
    )


def save_result_pkl(res: Dict[str, Any], result_dir: str, class_name: str) -> str:
    os.makedirs(result_dir, exist_ok=True)
    thickness = res["fatness"][-1] if res.get("fatness") else 0.0
    roughness = res["smoothness"][-1] if res.get("smoothness") else 0.0
    path = os.path.join(
        result_dir, result_filename(class_name, res.get("beta_1", 0.0), thickness, roughness)
    )
    with open(path, "wb") as f:
        pickle.dump(res, f)
    return path


def load_result(path: str) -> Dict[str, Any]:
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True).tolist()
    with open(path, "rb") as f:
        return pickle.load(f)
