"""R(2+1)D-18, written out plainly in float32.

Tran et al. (arXiv:1711.11248), as torchvision.models.video builds
``r2plus1d_18``: a (2+1)D stem (a (1,7,7) stride-(1,2,2) conv to 45
channels, BN, ReLU, a (3,1,1) conv to 64, BN, ReLU), four stages of two
BasicBlocks (64/128/256/512 channels; stages 2-4 open with stride 2), each
conv a (1,3,3) spatial conv to ``midplanes`` channels, BN, ReLU and a
(3,1,1) temporal conv, a 1x1x1 conv + BN on the shortcut where the shape
changes, then a global average and ``fc``.  Padding is symmetric; BN uses its
running statistics with scale and offset (eps 1e-5).  The weights are a
state dict under torchvision's names (``layer2.0.conv1.0.3.weight``), the
layout the harness draws.  Input: the normalized clip [B,T,H,W,3]; output:
logits [B, classes], f32.
"""

from __future__ import annotations

from typing import Dict

import torch

from .precision import conv3d

BN_EPS = 1e-5
BLOCKS = (2, 2, 2, 2)


def batch_norm(sd: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1, 1, 1, 1)
    scale = (torch.rsqrt(sd[f"{name}.running_var"] + BN_EPS) * sd[f"{name}.weight"]).view(shape)
    return (x - sd[f"{name}.running_mean"].view(shape)) * scale + sd[f"{name}.bias"].view(shape)


def conv(sd, name, x, precision, stride=(1, 1, 1), padding=(0, 0, 0)):
    return conv3d(x, sd[f"{name}.weight"], precision, stride=stride, padding=padding)


def conv2plus1(sd, name: str, x, stride: int, precision: str):
    """torchvision's Conv2Plus1D: ``name.0`` (1,3,3), ``name.1`` BN, ReLU,
    ``name.3`` (3,1,1)."""
    y = conv(sd, f"{name}.0", x, precision, (1, stride, stride), (0, 1, 1))
    y = torch.relu(batch_norm(sd, f"{name}.1", y))
    return conv(sd, f"{name}.3", y, precision, (stride, 1, 1), (1, 0, 0))


def logits(sd: Dict[str, torch.Tensor], clip: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    x = clip.float().permute(0, 4, 1, 2, 3)
    x = torch.relu(batch_norm(sd, "stem.1", conv(sd, "stem.0", x, precision, (1, 2, 2), (0, 3, 3))))
    x = torch.relu(batch_norm(sd, "stem.4", conv(sd, "stem.3", x, precision, padding=(1, 0, 0))))
    for stage, blocks in enumerate(BLOCKS, start=1):
        for b in range(blocks):
            name = f"layer{stage}.{b}"
            stride = 2 if stage > 1 and b == 0 else 1
            y = torch.relu(batch_norm(sd, f"{name}.conv1.1",
                                      conv2plus1(sd, f"{name}.conv1.0", x, stride, precision)))
            y = batch_norm(sd, f"{name}.conv2.1", conv2plus1(sd, f"{name}.conv2.0", y, 1, precision))
            if f"{name}.downsample.0.weight" in sd:
                x = batch_norm(sd, f"{name}.downsample.1",
                               conv(sd, f"{name}.downsample.0", x, precision, (stride,) * 3))
            x = torch.relu(y + x)
    x = x.mean(dim=(2, 3, 4))
    return x @ sd["fc.weight"].t() + sd["fc.bias"]
