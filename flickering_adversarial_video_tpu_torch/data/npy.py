"""npy clip tooling: the single-video attack's input format.

The port's own copy of the JAX package's ``data/npy.py``.  The reference
stores verified clips as ``rgb_<vid>@<class>.npy`` float arrays of shape
[1, T, 224, 224, 3] in [-1, 1] and parses the label from the filename;
``build_verified_npy_set`` makes such a set from class folders of video
files (decoded by ``data/video.py``, which needs cv2: a host tool).
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


def build_verified_npy_set(
    videos_folder: str,
    n_frames: int,
    num_of_vid: int,
    dest_folder: str,
    predict_fn,
    class_names: List[str],
    seed: int = 0,
) -> List[str]:
    """The reference's ``random_videos`` (pre_process_rgb_flow.py:239-257):
    sample one clip per class folder (the folders in a seeded shuffle), keep
    it only if the clean model's top-1 matches the folder label, save it as
    rgb_<vid>@<class>.npy; returns the paths written.

    predict_fn: [1,T,H,W,3] float in [-1,1] -> [1, K] probabilities, e.g.
    ``engine.inference.InferenceModel(engine)`` (on the engine's device:
    CUDA unless the caller built it on the CPU).
    """
    from .video import video_to_frames

    rng = np.random.default_rng(seed)
    os.makedirs(dest_folder, exist_ok=True)
    classes = [d for d in os.listdir(videos_folder)
               if os.path.isdir(os.path.join(videos_folder, d))]
    rng.shuffle(classes)
    written = []
    for cls in classes[:num_of_vid]:
        cls_dir = os.path.join(videos_folder, cls)
        vids = sorted(os.listdir(cls_dir))
        if not vids:
            continue
        vid_name = vids[int(rng.integers(len(vids)))]
        clip = video_to_frames(os.path.join(cls_dir, vid_name), n_steps=n_frames)
        if clip is None or clip.shape[1] < n_frames:
            continue
        top = int(np.asarray(predict_fn(clip)).argmax())
        if class_names.index(cls.replace("_", " ")) != top:
            continue
        dest = os.path.join(dest_folder, f"rgb_{os.path.splitext(vid_name)[0]}@{cls}.npy")
        np.save(dest, clip)
        written.append(dest)
    return written
