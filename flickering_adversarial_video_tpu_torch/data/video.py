"""mp4 -> clip preprocessing (host side).

The port's own copy of the JAX package's ``data/video.py``.  Replicates the
reference's preprocessing semantics (utils/pre_process_rgb_flow.py:30-145):
fps-resample toward 25 fps by frame skipping, aspect-preserving resize so
that the SHORT side reaches 256 (max-ratio resize, :37), scale x/128-1 into
[-1, 1], center-crop 224, keep the LAST n_steps frames.  The uint8 variant
keeps raw pixels, for the tfrecord writers (kinetics_to_tf_record_uint8.py
keeps raw uint8).

The optical-flow branch (pre_process_rgb_flow.py:104-124) is dead on every
attack path (flow=False throughout) but is rebuilt for API completeness:
``video_to_frames(..., flow=True)`` returns (clip, flow) with the
reference's postprocessing (clip +-20 px, /20, center-crop), computed by the
TV-L1 solver of ``optical_flow.py`` on the card (``device=None``) or where
``device`` says, instead of cv2's contrib DualTVL1.  The JAX package's two
deviations are kept: flow pairs are consecutive PROCESSED frames, and the
flow stack has T-1 entries aligned with the T KEPT frames (flow[t] is the
motion clip[t] -> clip[t+1]).

cv2 is an optional host dependency: without it every decode raises
``RuntimeError("cv2 unavailable")``, as in the JAX package.  The card's
machine has no cv2, so decoding is a host tool, tested on the CPU;
``frames_to_flow`` itself needs no cv2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .optical_flow import flow_for_video, postprocess_flow

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # an optional host dependency
    _HAS_CV2 = False


def resize_min_side(image: np.ndarray, target: int = 256) -> np.ndarray:
    """Aspect-preserving resize with max-ratio semantics
    (pre_process_rgb_flow.py:30-44: r = max(target/w, target/h))."""
    if not _HAS_CV2:
        raise RuntimeError("cv2 unavailable")
    h, w = image.shape[:2]
    r = max(float(target) / w, float(target) / h)
    dim = (int(w * r), int(h * r))
    return cv2.resize(image, dim, interpolation=cv2.INTER_LINEAR)


def crop_center(image: np.ndarray, size: int) -> np.ndarray:
    """Center crop (pre_process_rgb_flow.py:46-52)."""
    h, w = image.shape[:2]
    x1 = (w - size) // 2
    y1 = (h - size) // 2
    return image[y1 : y1 + size, x1 : x1 + size]


def frames_to_flow(gray_frames: np.ndarray, crop_size: int = 224, device=None) -> np.ndarray:
    """TV-L1 flow for consecutive resized gray frames, reference-postprocessed.

    [T, H, W] float gray (0..255 scale) -> [T-1, crop, crop, 2] in [-1, 1]
    (clip +-20 px then /20, pre_process_rgb_flow.py:110-113), numpy.  The
    T-1 pairs are solved as one batch on `device`: the card unless
    ``device="cpu"`` is given; without CUDA it raises."""
    gray = torch.as_tensor(np.asarray(gray_frames, np.float32), device=resolve_device(device))
    return postprocess_flow(flow_for_video(gray), crop_size=crop_size).cpu().numpy()


def video_to_frames(
    video_path: str,
    target_fps: int = 25,
    resize_height: int = 256,
    crop_size: int = 224,
    n_steps: int = 90,
    dtype: str = "float32",
    flow: bool = False,
    device=None,
) -> Optional[np.ndarray]:
    """Decode + preprocess one clip.

    Returns [1, T, crop, crop, 3]; float path in [-1, 1] (x/128-1,
    pre_process_rgb_flow.py:93), uint8 path raw pixels for the tfrecord
    writers.  None if the file cannot be opened or holds no frame.  With
    flow=True returns (clip, flow[1, T-1, crop, crop, 2]), the flow computed
    on the resized pre-crop gray frames by ``frames_to_flow`` on `device`.
    """
    if flow:
        device = resolve_device(device)  # raises before decoding without CUDA
    if not _HAS_CV2:
        raise RuntimeError("cv2 unavailable")
    capture = cv2.VideoCapture(video_path)
    if not capture.isOpened():
        return None
    fps = capture.get(cv2.CAP_PROP_FPS) or target_fps
    frame_gap = max(1, int(round(fps / target_fps)))

    frames = []
    grays = []
    frame_num = 1
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        if frame_num % frame_gap == 0:
            image = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            image = resize_min_side(image, resize_height)
            if flow:
                grays.append(cv2.cvtColor(image, cv2.COLOR_RGB2GRAY))
            if dtype == "uint8":
                image = crop_center(image, crop_size)
            else:
                image = crop_center(image.astype(np.float32) / 128.0 - 1.0, crop_size)
            frames.append(image)
        frame_num += 1
    capture.release()

    if not frames:
        return None
    clip = np.asarray(frames)
    if frame_num >= n_steps:
        clip = clip[-n_steps:]
        # the gray frames stay aligned with the kept clip frames
        grays = grays[-n_steps:]
    if flow:
        flow_arr = frames_to_flow(np.asarray(grays, np.float32), crop_size, device)
        return clip[np.newaxis], flow_arr[np.newaxis]
    return clip[np.newaxis]
