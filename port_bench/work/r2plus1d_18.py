"""R(2+1)D-18's work, frozen: the model FLOPs of a clip-step.  None of the
port's kernels runs in it: its convs are cuDNN's, its BN PyTorch's.

Shapes follow torchvision's r2plus1d_18 at a clip of T x H x W: the stem's
(1,7,7) stride-(1,2,2) conv to 45 channels and (3,1,1) conv to 64, four
stages of two BasicBlocks (64, 128, 256, 512 channels; stages 2-4 halve T, H
and W in their first block), each conv a (1,3,3) conv to ``midplanes`` and
a (3,1,1) conv, a 1x1x1 shortcut conv where the shape changes, and ``fc``.
"""

from __future__ import annotations

from typing import List

PLANES = (64, 128, 256, 512)
BLOCKS = (2, 2, 2, 2)


def midplanes(cin: int, cout: int) -> int:
    return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)


def forward_macs(t: int, h: int, w: int, classes: int = 400) -> int:
    h2, w2 = -(-h // 2), -(-w // 2)
    macs = t * h2 * w2 * (45 * 3 * 49 + 64 * 45 * 3)  # the stem's two convs
    cin = 64
    for stage, (planes, blocks) in enumerate(zip(PLANES, BLOCKS), start=1):
        for b in range(blocks):
            s = 2 if stage > 1 and b == 0 else 1
            mid = midplanes(cin, planes)
            to, ho, wo = -(-t // s), -(-h2 // s), -(-w2 // s)
            macs += t * ho * wo * mid * cin * 9 + to * ho * wo * planes * mid * 3   # conv1
            macs += to * ho * wo * (mid * planes * 9 + planes * mid * 3)           # conv2
            if s != 1 or cin != planes:
                macs += to * ho * wo * planes * cin                               # shortcut
            t, h2, w2, cin = to, ho, wo, planes
    return macs + cin * classes


def clip_step_flops(t: int, h: int, w: int, classes: int = 400) -> float:
    """2 FLOPs a multiply-add, for the forward and the input gradient."""
    return 2.0 * 2.0 * forward_macs(t, h, w, classes)


def step_launches(b: int, t: int, h: int, w: int, head: str, isz: int = 2) -> List:
    """No port kernel runs in this model."""
    return []
