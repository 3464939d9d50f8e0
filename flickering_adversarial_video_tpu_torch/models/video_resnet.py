"""Video ResNets (R3D-18, MC3-18, R(2+1)D-18, R(2+1)D-34) in PyTorch, NDHWC,
frozen victims of the mean/std world.

Port of the JAX package's ``models/video_resnet.py``, written by hand (no
torchvision).  The architecture is torchvision's ``video_resnet``:

* stem: r3d/mc3 ``Conv3d(3->64, (3,7,7), stride (1,2,2), pad (1,3,3))`` + BN
  + ReLU; r2plus1d ``Conv3d(3->45, (1,7,7), (1,2,2), (0,3,3))`` + BN + ReLU +
  ``Conv3d(45->64, (3,1,1), pad (1,0,0))`` + BN + ReLU;
* four stages of BasicBlocks (64/128/256/512 channels; stages 2-4 open with
  stride 2; 2,2,2,2 blocks at depth 18 and 3,4,6,3 at 34), each conv-BN-ReLU-
  conv-BN plus the residual (a 1x1x1 conv + BN where the shape changes),
  then ReLU.  The conv builders: ``simple`` (3x3x3), ``no_temporal``
  ((1,3,3), temporal stride 1: mc3's stages 2-4) and ``2plus1`` ((1,3,3) ->
  BN -> ReLU -> (3,1,1) with ``_midplanes`` channels between);
* the global mean over T, H, W and ``fc``.

Parameters carry torchvision's state-dict names (``stem.0``,
``layer1.0.conv1.0.3``, ``layer2.0.downsample.1``, ``fc``, ...), so a
torchvision ``.pth`` loads with ``load_state_dict``
(``convert/torch_video_resnet.py`` checks its shapes first).

Numerics, held to the JAX model: padding is symmetric, torch style (not
SAME); a conv runs in the compute dtype on weights kept in f32 (OIDHW, cast
at use, as ``models/i3d.py``); batch-norm is flax's ``BatchNorm`` with
running averages: ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias`` in f32
(the bf16 input promoted by the f32 statistics), then one cast to the
compute dtype; the head averages in f32 and rounds once, runs ``fc`` in the
compute dtype and returns f32 logits.  Each batch-norm, with the ReLU after
it and a block's residual add where there is one, is one epilogue: kernel B12
forward and backward on the card (``ops/bn_epilogue.py``), bit-equal to the
plain chain.

The stem's first conv (C_in = 3, spatial stride 2) runs as the JAX package's
default does on an even H and W: space-to-depth packed (C_in 12, a (kt,4,4)
stride-1 kernel, spatial pads (2,1)), which computes the same function as
the plain conv (:func:`stem_conv_plain`, taken at an odd H or W).  The TPU
layout devices of the JAX model (the output-packed stride-1 backward,
``FLICKER_RESNET_OUTPACK``, and the factor-4 stem) change no value and are
not carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.bn_epilogue import bn_epilogue
from ..ops.space_to_depth import pack_input, pack_kernel_axis

VARIANTS = ("r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34")
# BasicBlocks per stage
_LAYER_COUNTS = {"18": (2, 2, 2, 2), "34": (3, 4, 6, 3)}
_PLANES = (64, 128, 256, 512)
BN_EPS = 1e-5


def _midplanes(in_planes: int, out_planes: int) -> int:
    return (in_planes * out_planes * 3 * 3 * 3) // (in_planes * 3 * 3 + 3 * out_planes)


def _stage_convs(variant: str) -> Tuple[str, str, str, str]:
    family = variant.rsplit("_", 1)[0]
    if family == "r3d":
        return ("simple",) * 4
    if family == "mc3":
        return ("simple", "no_temporal", "no_temporal", "no_temporal")
    if family == "r2plus1d":
        return ("2plus1",) * 4
    raise ValueError(f"unknown variant {variant!r}: choose from {VARIANTS}")


def conv3d_ndhwc(x: torch.Tensor, w: torch.Tensor, stride=(1, 1, 1), padding=(0, 0, 0)):
    """Conv of NDHWC x (compute dtype) with an OIDHW kernel cast to x's dtype,
    symmetric `padding` -> NDHWC."""
    wc = w.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wc, stride=tuple(stride), padding=tuple(padding))
    return y.permute(0, 2, 3, 4, 1)


def pack_spatial_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIDHW [O,C,kt,7,7] of a stride-(1,2,2) pad-3 conv -> OIDHW
    [O,4C,kt,4,4] of the stride-1 conv on the (H, W) space-to-depth input
    (channel order (parity_h, parity_w, c), as ``pack_input``), pads (2,1)."""
    k = w.permute(2, 3, 4, 1, 0)  # [kt,7,7,C,O]
    k, pad_h = pack_kernel_axis(k, 1, 3)  # [kt,4,2,7,C,O]
    k, pad_w = pack_kernel_axis(k, 3, 3)  # [kt,4,2,4,2,C,O]
    if (pad_h, pad_w) != ((2, 1), (2, 1)):
        raise ValueError(f"unexpected packed stem pads {pad_h}, {pad_w}")
    kt, kh, ph, kw, pw, c, o = k.shape
    k = k.permute(0, 1, 3, 2, 4, 5, 6).reshape(kt, kh, kw, ph * pw * c, o)
    return k.permute(4, 3, 0, 1, 2)


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stem's first conv as torchvision writes it: (kt,7,7), stride
    (1,2,2), pads (kt//2,3,3)."""
    return conv3d_ndhwc(x, w, (1, 2, 2), (w.shape[2] // 2, 3, 3))


def stem_conv_packed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv on the (H, W) space-to-depth input (even H and W): C_in
    12, a (kt,4,4) stride-1 kernel, spatial pads (2,1) (the JAX package's
    ``_packed_spatial_conv``)."""
    xp = F.pad(pack_input(x, axes=(2, 3)), (0, 0, 2, 1, 2, 1))
    return conv3d_ndhwc(xp, pack_spatial_kernel(w), padding=(w.shape[2] // 2, 0, 0))


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Conv3d(nn.Module):
    """A bias-free conv (torchvision ``nn.Conv3d(..., bias=False)``'s state:
    ``weight`` OIDHW) on NDHWC activations."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1), padding=(0, 0, 0), device=None):
        super().__init__()
        self.weight = _frozen(torch.zeros(cout, cin, *kernel, device=device))
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_ndhwc(x, self.weight, self.stride, self.padding)


class StemConv(Conv3d):
    """The stem's first conv (C_in 3, stride (1,2,2)): space-to-depth packed
    on an even H and W, else plain; one function either way."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            return stem_conv_packed(x, self.weight)
        return stem_conv_plain(x, self.weight)


class BatchNorm3d(nn.Module):
    """torchvision ``nn.BatchNorm3d``'s state (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), applied as
    flax's inference batch-norm over the last (channel) dim (eps 1e-5), then
    ReLU where `relu`: one kernel each way on the card (``ops/bn_epilogue``,
    B12, which also gives the arithmetic), so the ``nn.ReLU`` that
    torchvision puts after it is an ``nn.Identity`` here (the module
    indices, hence the state-dict names, stay torchvision's)."""

    def __init__(self, channels, device=None, relu: bool = False):
        super().__init__()
        self.relu = relu
        self.weight = _frozen(torch.ones(channels, device=device))
        self.bias = _frozen(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.epilogue(x, None, self.relu)

    def epilogue(self, x: torch.Tensor, residual, relu: bool) -> torch.Tensor:
        """relu(bn(x) [+ residual]) where `relu`, else bn(x); a residual
        only with `relu`."""
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return bn_epilogue(x, self.running_mean, mul, self.bias, residual, relu)


class Linear(nn.Module):
    """torchvision's ``fc`` state (``weight`` [K, 512], ``bias`` [K])."""

    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.weight = _frozen(torch.zeros(cout, cin, device=device))
        self.bias = _frozen(torch.zeros(cout, device=device))


def _conv_builder(kind: str, cin: int, cout: int, mid: int, stride: int, device) -> nn.Module:
    s = stride
    if kind == "simple":
        return Conv3d(cin, cout, (3, 3, 3), (s, s, s), (1, 1, 1), device)
    if kind == "no_temporal":
        return Conv3d(cin, cout, (1, 3, 3), (1, s, s), (0, 1, 1), device)
    return nn.Sequential(  # 2plus1: torchvision's Conv2Plus1D
        Conv3d(cin, mid, (1, 3, 3), (1, s, s), (0, 1, 1), device),
        BatchNorm3d(mid, device, relu=True),
        nn.Identity(),
        Conv3d(mid, cout, (3, 1, 1), (s, 1, 1), (1, 0, 0), device),
    )


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock`` (expansion 1); ``_midplanes`` once per
    block, shared by its two convs.  ``conv2``'s batch-norm also adds the
    residual and applies the block's ReLU, in one epilogue."""

    def __init__(self, cin: int, planes: int, kind: str, stride: int = 1, device=None):
        super().__init__()
        mid = _midplanes(cin, planes)
        self.conv1 = nn.Sequential(_conv_builder(kind, cin, planes, mid, stride, device),
                                   BatchNorm3d(planes, device, relu=True), nn.Identity())
        self.conv2 = nn.Sequential(_conv_builder(kind, planes, planes, mid, 1, device),
                                   BatchNorm3d(planes, device))
        self.downsample = None
        if stride != 1 or cin != planes:
            ts = 1 if kind == "no_temporal" else stride
            self.downsample = nn.Sequential(
                Conv3d(cin, planes, (1, 1, 1), (ts, stride, stride), device=device),
                BatchNorm3d(planes, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        conv, bn = self.conv2
        return bn.epilogue(conv(self.conv1(x)), residual, True)


class VideoResNet(nn.Module):
    """``forward(x)``: [B,T,H,W,3] mean/std-normalized clip -> f32 logits
    [B, num_classes].  Weights start at torchvision's initial BN state and
    zero kernels: load a state dict.  Runs on CUDA unless ``device`` says
    otherwise."""

    def __init__(self, variant: str = "r3d_18", num_classes: int = 400,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        convs = _stage_convs(variant)
        device = resolve_device(device)
        self.variant, self.num_classes, self.compute_dtype = variant, num_classes, compute_dtype
        if variant.startswith("r2plus1d"):
            self.stem = nn.Sequential(
                StemConv(3, 45, (1, 7, 7), device=device),
                BatchNorm3d(45, device, relu=True), nn.Identity(),
                Conv3d(45, 64, (3, 1, 1), padding=(1, 0, 0), device=device),
                BatchNorm3d(64, device, relu=True), nn.Identity())
        else:
            self.stem = nn.Sequential(
                StemConv(3, 64, (3, 7, 7), device=device),
                BatchNorm3d(64, device, relu=True), nn.Identity())
        cin = 64
        counts = _LAYER_COUNTS[variant.rsplit("_", 1)[1]]
        for i, (planes, kind, n) in enumerate(zip(_PLANES, convs, counts), start=1):
            blocks = []
            for b in range(n):
                blocks.append(BasicBlock(cin, planes, kind, 2 if (i > 1 and b == 0) else 1, device))
                cin = planes
            self.add_module(f"layer{i}", nn.Sequential(*blocks))
        self.fc = Linear(512, num_classes, device)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.stem(x.to(dt))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.mean(x, dim=(1, 2, 3), dtype=torch.float32).to(dt)
        x = F.linear(x, self.fc.weight.to(dt)) + self.fc.bias.to(dt)
        return x.float()


def r3d_18(num_classes: int = 400, compute_dtype=torch.float32, device=None) -> VideoResNet:
    return VideoResNet("r3d_18", num_classes, compute_dtype, device)


def mc3_18(num_classes: int = 400, compute_dtype=torch.float32, device=None) -> VideoResNet:
    return VideoResNet("mc3_18", num_classes, compute_dtype, device)


def r2plus1d_18(num_classes: int = 400, compute_dtype=torch.float32, device=None) -> VideoResNet:
    return VideoResNet("r2plus1d_18", num_classes, compute_dtype, device)


def r2plus1d_34(num_classes: int = 400, compute_dtype=torch.float32, device=None) -> VideoResNet:
    """The torch.hub ig65m/kinetics victim family: 359/487-way heads for the
    ig65m checkpoints."""
    return VideoResNet("r2plus1d_34", num_classes, compute_dtype, device)


def state_shapes(variant: str, num_classes: int = 400) -> dict:
    """Shapes of the state dict, without allocating it."""
    model = VideoResNet(variant, num_classes, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}
