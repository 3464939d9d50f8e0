"""InceptionI3D (RGB stream), written out plainly in float32.

The layer equations of Carreira & Zisserman (arXiv:1705.07750) as
deepmind/kinetics-i3d ``i3d.py`` builds them: TF "SAME" padding everywhere,
each Unit3D a bias-free conv, an inference batch-norm with an offset and no
scale (eps 1e-3) and a ReLU; max pools pad with -inf.  The Logits head is a
VALID average pool of window (2, 7, 7), a 1x1x1 conv with bias, a spatial
squeeze and a mean over time.  The weights are a state dict under the
checkpoint's names (``Mixed_3b.Branch_1.Conv3d_0b_3x3.conv_3d.weight``,
OIDHW), the layout the harness draws.  Tensors are NCDHW inside; the input
and the logits are as the attack sees them: clip [B,T,H,W,3] in [-1, 1],
logits [B, classes].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import conv3d

BN_EPS = 1e-3
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
# the pools that follow a Mixed block: (window, stride)
POOL_AFTER = {"Mixed_3c": ((3, 3, 3), (2, 2, 2)), "Mixed_4f": ((2, 2, 2), (2, 2, 2))}


def same_pads(n: int, k: int, s: int):
    """TF SAME padding (lo, hi) of an axis of extent n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k, s, value: float) -> torch.Tensor:
    pads = []
    for n, kk, ss in reversed(list(zip(x.shape[2:], k, s))):  # F.pad: W, H, T
        pads += list(same_pads(n, kk, ss))
    return F.pad(x, pads, value=value)


def max_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    return F.max_pool3d(_pad_same(x, k, s, float("-inf")), k, s)


def unit3d(sd: Dict[str, torch.Tensor], name: str, x: torch.Tensor, precision: str,
           stride=(1, 1, 1)) -> torch.Tensor:
    """conv (SAME) + batch-norm (offset, no scale) + ReLU."""
    w = sd[f"{name}.conv_3d.weight"]
    y = conv3d(_pad_same(x, w.shape[2:], stride, 0.0), w, precision, stride=stride)
    shape = (1, -1, 1, 1, 1)
    mean = sd[f"{name}.batch_norm.running_mean"].view(shape)
    var = sd[f"{name}.batch_norm.running_var"].view(shape)
    bias = sd[f"{name}.batch_norm.bias"].view(shape)
    return torch.relu((y - mean) * torch.rsqrt(var + BN_EPS) + bias)


def logits(sd: Dict[str, torch.Tensor], clip: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """clip [B,T,H,W,3] in [-1, 1] -> logits [B, classes], f32."""
    x = clip.float().permute(0, 4, 1, 2, 3)
    x = unit3d(sd, "Conv3d_1a_7x7", x, precision, stride=(2, 2, 2))
    x = max_pool(x, (1, 3, 3), (1, 2, 2))
    x = unit3d(sd, "Conv3d_2b_1x1", x, precision)
    x = unit3d(sd, "Conv3d_2c_3x3", x, precision)
    x = max_pool(x, (1, 3, 3), (1, 2, 2))
    for name, _ in MIXED:
        second = "Conv3d_0a_3x3" if name == "Mixed_5b" else "Conv3d_0b_3x3"
        b0 = unit3d(sd, f"{name}.Branch_0.Conv3d_0a_1x1", x, precision)
        b1 = unit3d(sd, f"{name}.Branch_1.Conv3d_0b_3x3",
                    unit3d(sd, f"{name}.Branch_1.Conv3d_0a_1x1", x, precision), precision)
        b2 = unit3d(sd, f"{name}.Branch_2.{second}",
                    unit3d(sd, f"{name}.Branch_2.Conv3d_0a_1x1", x, precision), precision)
        b3 = unit3d(sd, f"{name}.Branch_3.Conv3d_0b_1x1", max_pool(x, (3, 3, 3), (1, 1, 1)),
                    precision)
        x = torch.cat([b0, b1, b2, b3], dim=1)
        if name in POOL_AFTER:
            x = max_pool(x, *POOL_AFTER[name])
    window = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
    x = F.avg_pool3d(x, window, stride=1)
    w = sd["Logits.Conv3d_0c_1x1.conv_3d.weight"]
    y = conv3d(x, w, precision) + sd["Logits.Conv3d_0c_1x1.conv_3d.bias"].view(1, -1, 1, 1, 1)
    if y.shape[3] != 1 or y.shape[4] != 1:
        raise ValueError(f"logits are not spatially squeezable: {tuple(y.shape)}")
    return y[:, :, :, 0, 0].mean(dim=2)
