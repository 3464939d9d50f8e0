"""Inception-v1 Inflated 3D ConvNet (I3D) in PyTorch, NDHWC, frozen victim.

Port of the JAX package's ``models/i3d.py`` (``InceptionI3D``): the packed
space-to-depth stem (kernel B1), MaxPool3d_2a/3a (kernel B5), Unit3D convs
(conv + frozen BN + relu, backward through kernel B2 for KT=3), nine Inception
Mixed blocks with the stride-1 branch pool (kernels B3/B4), MaxPool3d_4a/5a,
and the Logits head: a VALID average pool of window (min(2,T), min(7,H),
min(7,W)), a 1x1x1 conv with bias, a spatial squeeze and a mean over time.
Endpoint names, the Mixed channel table and the Mixed_5b ``Conv3d_0a_3x3``
name quirk are kept, so the module tree mirrors the Flax parameter tree
(``convert/flax_i3d.py`` maps one onto the other).

Layout: activations are [B, T, H, W, C].  The TPU-only T-major view of the JAX
package computes the same values; it is not reproduced.  Weights are stored
in float32 (conv kernels OIDHW) and cast to ``compute_dtype`` at use;
batch-norm is inference-only (offset, no scale, eps 1e-3).  The victim is
frozen: nothing here requires grad, and the backward runs only toward the
input.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.conv_unit import conv_bn_relu
from ..ops.maxpool import pool4a, pool5a
from ..ops.pool_s1 import max_pool_333
from ..ops.pool_strided import max_pool_133_s2
from ..ops.space_to_depth import pack_input, pack_stem_kernel
from ..ops.stem_conv import stem_bn_relu

I3D_ENDPOINTS = (
    "Conv3d_1a_7x7",
    "MaxPool3d_2a_3x3",
    "Conv3d_2b_1x1",
    "Conv3d_2c_3x3",
    "MaxPool3d_3a_3x3",
    "Mixed_3b",
    "Mixed_3c",
    "MaxPool3d_4a_3x3",
    "Mixed_4b",
    "Mixed_4c",
    "Mixed_4d",
    "Mixed_4e",
    "Mixed_4f",
    "MaxPool3d_5a_2x2",
    "Mixed_5b",
    "Mixed_5c",
    "Logits",
    "Predictions",
)

# (branch0 1x1, branch1 1x1, branch1 3x3, branch2 1x1, branch2 3x3, branch3 1x1)
_MIXED_CHANNELS: Dict[str, Tuple[int, int, int, int, int, int]] = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}

# Reference quirk: Mixed_5b's second Branch_2 conv is named 'Conv3d_0a_3x3'.
_BRANCH2_SECOND_NAME = {"Mixed_5b": "Conv3d_0a_3x3"}

_POOL_AFTER = {"Mixed_3c": ("MaxPool3d_4a_3x3", pool4a), "Mixed_4f": ("MaxPool3d_5a_2x2", pool5a)}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Conv(nn.Module):
    """Kernel holder (Flax ``conv_3d``): weight OIDHW, optional bias."""

    def __init__(self, cin, cout, kernel_shape, bias=False, device=None):
        super().__init__()
        self.weight = _frozen(torch.zeros(cout, cin, *kernel_shape, device=device))
        self.bias = _frozen(torch.zeros(cout, device=device)) if bias else None


class _FrozenBN(nn.Module):
    """Inference batch-norm (Flax ``batch_norm``): offset only, eps 1e-3."""

    def __init__(self, channels, device=None):
        super().__init__()
        self.bias = _frozen(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))


class Unit3D(nn.Module):
    """Stride-1 SAME conv + frozen BN + relu (ops/conv_unit.py)."""

    def __init__(self, cin, cout, kernel_shape=(1, 1, 1), device=None):
        super().__init__()
        self.conv_3d = _Conv(cin, cout, kernel_shape, device=device)
        self.batch_norm = _FrozenBN(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.batch_norm
        return conv_bn_relu(x, self.conv_3d.weight, bn.running_mean, bn.running_var, bn.bias)


class InceptionMixed(nn.Module):
    """Four parallel branches concatenated on channels."""

    def __init__(self, cin, channels, branch2_second_name="Conv3d_0b_3x3", device=None):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3 = channels
        self.Branch_0 = nn.ModuleDict({"Conv3d_0a_1x1": Unit3D(cin, c0, device=device)})
        self.Branch_1 = nn.ModuleDict({
            "Conv3d_0a_1x1": Unit3D(cin, c1a, device=device),
            "Conv3d_0b_3x3": Unit3D(c1a, c1b, (3, 3, 3), device=device),
        })
        self.Branch_2 = nn.ModuleDict({
            "Conv3d_0a_1x1": Unit3D(cin, c2a, device=device),
            branch2_second_name: Unit3D(c2a, c2b, (3, 3, 3), device=device),
        })
        self.Branch_3 = nn.ModuleDict({"Conv3d_0b_1x1": Unit3D(cin, c3, device=device)})
        self.out_channels = c0 + c1b + c2b + c3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = []
        for name in ("Branch_0", "Branch_1", "Branch_2"):
            y = x
            for unit in getattr(self, name).values():
                y = unit(y)
            branches.append(y)
        branches.append(self.Branch_3["Conv3d_0b_1x1"](max_pool_333(x)))
        return torch.cat(branches, dim=-1)


class _LogitsUnit(nn.Module):
    def __init__(self, cin, num_classes, device=None):
        super().__init__()
        self.conv_3d = _Conv(cin, num_classes, (1, 1, 1), bias=True, device=device)


class InceptionI3D(nn.Module):
    """Full I3D.  ``forward(x)`` takes [B, T, H, W, 3] in [-1, 1] with even
    T/H/W and returns (output, endpoints) like the JAX model; ``trunk(y)``
    runs everything after the stem from the stem output (the attack step
    computes the stem inside its input head).  Weights start at zero: load a
    state dict (``convert.flax_i3d``).  Runs on CUDA unless ``device`` says
    otherwise."""

    def __init__(
        self, num_classes: int = 400, compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), device=device)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), device=device)
        cin = 192
        for name, ch in _MIXED_CHANNELS.items():
            block = InceptionMixed(
                cin, ch, _BRANCH2_SECOND_NAME.get(name, "Conv3d_0b_3x3"), device=device
            )
            self.add_module(name, block)
            cin = block.out_channels
        self.Logits = nn.ModuleDict({"Conv3d_0c_1x1": _LogitsUnit(cin, num_classes, device)})

    @property
    def device(self) -> torch.device:
        return self.Conv3d_1a_7x7.conv_3d.weight.device

    def stem_params(self):
        """(packed kernel in the compute dtype, BN mean, var, bias) of the stem."""
        stem = self.Conv3d_1a_7x7
        pk = pack_stem_kernel(stem.conv_3d.weight).to(self.compute_dtype)
        bn = stem.batch_norm
        return pk, bn.running_mean, bn.running_var, bn.bias

    def forward(
        self, x: torch.Tensor, final_endpoint: str = "Logits"
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if final_endpoint not in I3D_ENDPOINTS:
            raise ValueError(f"Unknown final endpoint {final_endpoint}")
        xp = pack_input(x.to(self.compute_dtype))
        y = stem_bn_relu(xp, *self.stem_params())
        endpoints: Dict[str, torch.Tensor] = {}
        return self.trunk(y, final_endpoint, endpoints), endpoints

    def trunk(
        self, y: torch.Tensor, final_endpoint: str = "Logits",
        endpoints: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """From the stem output [B,T',H',W',64] to `final_endpoint`; fills
        `endpoints` (when given) with every endpoint on the way."""
        x = y

        def done(name: str) -> bool:
            if endpoints is not None:
                endpoints[name] = x
            return final_endpoint == name

        if done("Conv3d_1a_7x7"):
            return x
        x = max_pool_133_s2(x)
        if done("MaxPool3d_2a_3x3"):
            return x
        x = self.Conv3d_2b_1x1(x)
        if done("Conv3d_2b_1x1"):
            return x
        x = self.Conv3d_2c_3x3(x)
        if done("Conv3d_2c_3x3"):
            return x
        x = max_pool_133_s2(x)
        if done("MaxPool3d_3a_3x3"):
            return x
        for name in _MIXED_CHANNELS:
            x = getattr(self, name)(x)
            if done(name):
                return x
            if name in _POOL_AFTER:
                pool_name, pool = _POOL_AFTER[name]
                x = pool(x)
                if done(pool_name):
                    return x
        x = self._logits(x)
        if done("Logits"):
            return x
        x = torch.softmax(x, dim=-1)
        done("Predictions")
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        window = (min(2, x.shape[1]), min(7, x.shape[2]), min(7, x.shape[3]))
        # the window sum runs in f32 (the output is 1/98 of the input's size)
        x = F.avg_pool3d(x.permute(0, 4, 1, 2, 3).float(), window, stride=1)
        x = x.permute(0, 2, 3, 4, 1).to(dt)
        conv = self.Logits["Conv3d_0c_1x1"].conv_3d
        w = conv.weight.reshape(self.num_classes, -1).to(dt)
        logits = F.linear(x, w, conv.bias.to(dt))  # [B, T'', 1, 1, K]
        if logits.shape[2] != 1 or logits.shape[3] != 1:
            raise ValueError(f"logits are not spatially squeezable: {tuple(logits.shape)}")
        return logits[:, :, 0, 0].float().mean(dim=1)


def state_shapes(num_classes: int = 400) -> Dict[str, Sequence[int]]:
    """Shapes of the state dict, without allocating it."""
    model = InceptionI3D(num_classes, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}
