"""npy clip tooling: the single-video attack's input format.

The port's own copy of the JAX package's ``data/npy.py``.  The reference
stores verified clips as ``rgb_<vid>@<class>.npy`` float arrays of shape
[1, T, 224, 224, 3] in [-1, 1] and parses the label from the filename.
``build_verified_npy_set`` (sampling clips from video files) comes with the
video decoding tools (ROADMAP.md queue A item 13).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def parse_label_from_filename(filename: str) -> str:
    """'rgb_xyz@playing_guitar.npy' -> 'playing guitar'."""
    return os.path.basename(filename).split("@")[-1].rsplit(".", 1)[0].replace("_", " ")


def load_npy_clip(path: str, frames: Optional[int] = None) -> np.ndarray:
    """Load a clip, keep the trailing `frames` frames, restore the leading
    batch dim: [1, T, H, W, 3] float32."""
    clip = np.load(path)
    if clip.ndim == 5:
        clip = clip[0]
    if frames is not None:
        clip = clip[-frames:]
    return clip[np.newaxis].astype(np.float32)


def save_npy_clip(path: str, clip: np.ndarray) -> None:
    clip = np.asarray(clip, np.float32)
    if clip.ndim == 4:
        clip = clip[np.newaxis]
    np.save(path, clip)


def list_npy_videos(npy_dir: str) -> List[str]:
    return sorted(
        os.path.join(npy_dir, f) for f in os.listdir(npy_dir) if f.endswith(".npy")
    )
