"""The work of one launch of each of the port's kernels, frozen.

A copy of the per-tag arithmetic that the port's kernel wrappers record
(``ops/*.py``, ``record(tag, flops, bytes)``), kept here so that a change to
the program cannot move the yardstick.  Bytes: each input read once, each
output written once.  FLOPs: B1's 2*M*N*K over the taps that land inside the
clip; the pools, the combine and the elementwise kernels count 0.  Shapes are
NDHWC tuples; `isz` is the activation's bytes an element (2 for bf16).

:func:`bound_s` turns (FLOPs, bytes, dtype) into the least time the H100
could take: the larger of the bytes at 3.35 TB/s and the FLOPs at the peak
for the type (dense bf16 989 TFLOP/s, f32 67 TFLOP/s; NVIDIA's data sheet).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

Shape = Tuple[int, ...]


def _n(shape: Shape) -> int:
    return math.prod(shape)


# B1: the packed stem conv [B,T',H',W',24] -> [B,T',H',W',64], 4x4x4 taps, pads (1, 2)
B1_CIN, B1_COUT, B1_TAPS, B1_PADS, B1_MAX_W = 24, 64, 4, (1, 2), 128


@lru_cache(maxsize=None)
def _taps_in_range(n: int) -> int:
    lo, hi = B1_PADS
    return sum(min(n, i + hi + 1) - max(0, i - lo) for i in range(n))


def _segments(w: int, max_w: int = B1_MAX_W):
    k = 1
    while True:
        cuts = [round(i * w / k) for i in range(k + 1)]
        segs = [(max(a - 1, 0), min(b + 2, w)) for a, b in zip(cuts, cuts[1:])]
        if all(hi - lo <= max_w for lo, hi in segs):
            return segs
        k += 1


def b1(x: Shape, isz: int):
    """[(flops, bytes)] of B1's launches on the packed clip x (one a column
    segment)."""
    b, t, h, w, _ = x
    out = []
    for lo, hi in _segments(w):
        n = b * t * h * (hi - lo)
        macs = (b * _taps_in_range(t) * _taps_in_range(h) * _taps_in_range(hi - lo)
                * B1_CIN * B1_COUT)
        out.append((2 * macs, n * B1_CIN * isz + B1_TAPS ** 3 * B1_CIN * B1_COUT * isz
                    + n * B1_COUT * isz + 3 * B1_COUT * 4))
    return out


def b2(part: Shape, cin: int, isz: int):
    """The temporal combine: part [B,T,H,W,KT*cin] -> [B,T,H,W,cin]."""
    return 0, _n(part) * isz * (1 + cin / part[-1])


def b3(x: Shape, isz: int):
    """The 3x3x3 stride-1 pool forward."""
    return 0, 2 * _n(x) * isz


def b4(x: Shape, isz: int):
    """Its backward: x and dy read, dx written (all of x's shape)."""
    return 0, 3 * _n(x) * isz


def b5(x: Shape, isz: int):
    """The (1,3,3) stride-(1,2,2) pool forward: x read, y (a quarter) written."""
    return 0, _n(x) * isz * 5 // 4


def b6(x: Shape, isz: int):
    """Its backward: x and dy (a quarter) read, dx written."""
    return 0, _n(x) * isz + _n(x) // 4 * isz + _n(x) * isz


def b7(packed: Shape, dl_elems: int, out_isz: int, mask: bool = True):
    """The emitter: packed u8 read, adv (and the u8 mask) written, dl read."""
    return 0, _n(packed) * (1 + out_isz + int(mask)) + dl_elems * 4


def bound_s(flops: float, nbytes: float, dtype: str = "bf16") -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
