"""I3D's work, frozen: the model FLOPs of a clip-step, and the port's kernel
launches of one train step with each launch's work.

Shapes follow InceptionI3D at a clip of T x H x W (all even; H and W
multiples of 32), each stride-2 layer rounding up (SAME): the stem to
[T/2, H/2, W/2, 64], MaxPool3d_2a and 3a halving H and W, the Mixed blocks
at [T/2, H/8], [T/4, H/16] and [T/8, H/32], the Logits' (2, 7, 7) average
and 1x1x1 conv.
"""

from __future__ import annotations

from typing import List, Tuple

from . import kernels as k

# (branch0 1x1, branch1 1x1, branch1 3x3, branch2 1x1, branch2 3x3, branch3 1x1)
MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
# the grid (halvings of T, of H and W) each Mixed block runs on
GRID = {"Mixed_3": (1, 3), "Mixed_4": (2, 4), "Mixed_5": (3, 5)}


def _halved(n: int, k: int) -> int:
    """n after k SAME stride-2 layers."""
    for _ in range(k):
        n = -(-n // 2)
    return n


def _grid(name: str, t: int, h: int, w: int):
    kt, ks = GRID[name[:7]]
    return _halved(t, kt), _halved(h, ks), _halved(w, ks)


def forward_macs(t: int, h: int, w: int, classes: int = 400) -> int:
    """Multiply-adds of one clip's forward: every conv's output elements
    times its input channels and taps."""
    t2, h2, w2 = _halved(t, 1), _halved(h, 1), _halved(w, 1)
    macs = t2 * h2 * w2 * 64 * 3 * 7 ** 3                           # Conv3d_1a_7x7
    g2 = t2 * _halved(h, 2) * _halved(w, 2)
    macs += g2 * 64 * 64 + g2 * 192 * 64 * 27                       # Conv3d_2b, Conv3d_2c
    cin = 192
    for name, (c0, c1a, c1b, c2a, c2b, c3) in MIXED:
        tt, hh, ww = _grid(name, t, h, w)
        g = tt * hh * ww
        macs += g * (cin * (c0 + c1a + c2a + c3) + 27 * (c1a * c1b + c2a * c2b))
        cin = c0 + c1b + c2b + c3
    macs += (_halved(t, 3) - 1) * cin * classes                     # Logits
    return macs


def clip_step_flops(t: int, h: int, w: int, classes: int = 400) -> float:
    """2 FLOPs a multiply-add, for the forward and the input gradient (the
    victim is frozen: no weight gradient)."""
    return 2.0 * 2.0 * forward_macs(t, h, w, classes)


def step_launches(b: int, t: int, h: int, w: int, head: str, isz: int = 2
                  ) -> List[Tuple[str, float, float]]:
    """(tag, FLOPs, bytes) of every port kernel launch in one train step of
    b clips.  `head`: "packed_u8" (uint8 clips through the packed input head:
    B7, B1, no B2 for the stem) or "float" (float clips through the victim's
    own forward: B1, and B2 for the stem's input gradient)."""
    out = []
    packed = (b, t // 2, h // 2, w // 2, 24)
    if head == "packed_u8":
        out.append(("B7",) + k.b7(packed, (t // 2) * 24, isz))
    elif head == "float":
        out.append(("B2",) + k.b2(packed[:4] + (4 * 24,), 24, isz))
    else:
        raise ValueError(f"head {head!r}")
    out += [("B1",) + fb for fb in k.b1(packed, isz)]
    stem = (b, t // 2, h // 2, w // 2, 64)
    out += [("B5",) + k.b5(stem, isz), ("B6",) + k.b6(stem, isz)]
    out.append(("B2",) + k.b2((b, t // 2, h // 4, w // 4, 3 * 64), 64, isz))  # Conv3d_2c
    pool3a = (b, t // 2, h // 4, w // 4, 192)
    out += [("B5",) + k.b5(pool3a, isz), ("B6",) + k.b6(pool3a, isz)]
    cin = 192
    for name, (c0, c1a, c1b, c2a, c2b, c3) in MIXED:
        tt, hh, ww = _grid(name, t, h, w)
        x = (b, tt, hh, ww, cin)
        out += [("B3",) + k.b3(x, isz), ("B4",) + k.b4(x, isz)]
        for c in (c1a, c2a):
            out.append(("B2",) + k.b2((b, tt, hh, ww, 3 * c), c, isz))
        cin = c0 + c1b + c2b + c3
        if name == "Mixed_3c":  # MaxPool3d_4a's spatial half
            x4 = (b, tt, hh, ww, cin)
            out += [("B5",) + k.b5(x4, isz), ("B6",) + k.b6(x4, isz)]
    return out
