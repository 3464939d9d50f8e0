"""Host-side space-to-depth packing of uint8 clips.

A copy of the JAX package's ``data/packing.pack_video_np``: the attack step's
input head consumes the packed layout [T/2, H/2, W/2, 8C] with channel order
(parity_t, parity_h, parity_w, c), the same as ``ops.space_to_depth.pack_input``.
"""

from __future__ import annotations

import numpy as np


def pack_video_np(video: np.ndarray) -> np.ndarray:
    """[..., T, H, W, C] -> [..., T/2, H/2, W/2, 8C] (any leading batch dims)."""
    *lead, t, h, w, c = video.shape
    if t % 2 or h % 2 or w % 2:
        raise ValueError(f"even T/H/W required, got {(t, h, w)}")
    v = video.reshape(*lead, t // 2, 2, h // 2, 2, w // 2, 2, c)
    n = len(lead)
    perm = list(range(n)) + [n, n + 2, n + 4, n + 1, n + 3, n + 5, n + 6]
    return np.ascontiguousarray(v.transpose(perm)).reshape(*lead, t // 2, h // 2, w // 2, 8 * c)
