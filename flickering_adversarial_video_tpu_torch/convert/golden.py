"""Recorded-logits golden fixtures for real victim weights.

The port's counterpart of the JAX package's ``convert/golden.py``, run on the
port's model, in the same ``.npz`` format, so that one golden file checks
both packages: ``dump_golden`` records the logits of a canonical
deterministic clip for a set of weights, ``verify_golden`` computes them
again and compares (top-5 order exactly, logits within `atol`).

The canonical clip comes from numpy's PCG64 stream (stable across numpy
versions by specification) through the uint8 path of the data pipeline:
x/128-1 (the tanh world, I3D) or (x/255 - mean)/std with the Kinetics
statistics (the mean/std world, the video ResNets).  ``verify_golden`` takes
the geometry the file records.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

GOLDEN_SEED = 20260816
# smaller T than the canonical clips (90) keeps the recompute cheap; every
# layer still executes
GOLDEN_GEOMETRY = {"tanh": (32, 224), "meanstd": (16, 112)}


def canonical_clip(norm_world: str, frames: int, size: int) -> np.ndarray:
    """Deterministic normalized f32 clip [1, T, S, S, 3] for a norm world."""
    rng = np.random.default_rng(GOLDEN_SEED)
    u8 = rng.integers(0, 256, (1, frames, size, size, 3), dtype=np.uint8)
    if norm_world == "tanh":
        return u8.astype(np.float32) / 128.0 - 1.0
    from ..models.registry import KINETICS_MEAN, KINETICS_STD

    x = u8.astype(np.float32) / 255.0
    return (x - np.asarray(KINETICS_MEAN, np.float32)) / np.asarray(KINETICS_STD, np.float32)


def _top5(logits_1d: np.ndarray) -> np.ndarray:
    """Top-5 indices by descending logit, ties broken by ascending class id
    (a stable sort of the negated values)."""
    return np.argsort(-logits_1d, kind="stable")[:5].astype(np.int32)


def compute_logits(
    model_name: str, state: Mapping[str, torch.Tensor], num_classes: Optional[int] = None,
    device=None, geometry: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Forward the canonical clip through the f32 model (TF32 off) -> logits
    [1, K], on `device` (CUDA unless told otherwise)."""
    from ..models.registry import create_model

    model, spec = create_model(model_name, num_classes=num_classes,
                               compute_dtype=torch.float32, device=device)
    model.load_state_dict(state)
    frames, size = geometry or GOLDEN_GEOMETRY[spec.norm_world]
    clip = torch.from_numpy(canonical_clip(spec.norm_world, frames, size)).to(model.device)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            logits = model(clip)
            logits = logits[0] if isinstance(logits, tuple) else logits  # I3D: (logits, endpoints)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return logits.float().cpu().numpy()


def dump_golden(
    model_name: str,
    state: Mapping[str, torch.Tensor],
    out_path: str,
    weights_file: str,
    num_classes: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Record the canonical-clip logits for `state` into `out_path`."""
    from ..models.registry import MODEL_REGISTRY

    spec = MODEL_REGISTRY[model_name]
    frames, size = GOLDEN_GEOMETRY[spec.norm_world]
    logits = compute_logits(model_name, state, num_classes=num_classes, device=device)
    top5 = _top5(logits[0])
    payload = dict(
        model=model_name,
        num_classes=np.int32(logits.shape[-1]),
        frames=np.int32(frames),
        size=np.int32(size),
        seed=np.int64(GOLDEN_SEED),
        norm_world=spec.norm_world,
        logits=logits,
        top5=top5,
        weights_file=os.path.basename(weights_file),
    )
    np.savez_compressed(out_path, **payload)
    return payload


def verify_golden(
    npz_path: str, weights_path: Optional[str] = None, atol: float = 5e-3,
    eval_type: str = "rgb", device=None,
) -> Dict[str, Any]:
    """Compute the golden logits again and compare.

    `weights_path` (a ``.pt``/``.pth``, a ``.msgpack`` or a TF checkpoint
    prefix, read with `eval_type`) defaults to the recorded weights_file next to the npz.
    Returns a report dict; raises AssertionError on a mismatch (the top-5
    class order must match exactly; logits within `atol`)."""
    from .cli import load_weights

    z = np.load(npz_path, allow_pickle=False)
    model_name = str(z["model"])
    if weights_path is None:
        weights_path = os.path.join(os.path.dirname(npz_path), str(z["weights_file"]))
    if not (os.path.exists(weights_path) or os.path.exists(weights_path + ".index")):
        raise FileNotFoundError(weights_path)
    state = load_weights(weights_path, eval_type=eval_type, model_name=model_name)
    logits = compute_logits(model_name, state, num_classes=int(z["num_classes"]), device=device,
                            geometry=(int(z["frames"]), int(z["size"])))
    ref = z["logits"]
    top5 = _top5(logits[0])
    max_abs = float(np.max(np.abs(logits - ref)))
    report = {
        "model": model_name,
        "max_abs_diff": max_abs,
        "top5_recorded": z["top5"].tolist(),
        "top5_recomputed": top5.tolist(),
    }
    assert top5.tolist() == z["top5"].tolist(), report
    assert max_abs < atol, report
    return report
