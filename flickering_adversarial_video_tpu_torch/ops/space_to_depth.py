"""Space-to-depth packing of the I3D stem (input and kernel).

Port of ``pack_input`` and ``pack_conv_spatiotemporal`` of the JAX
package's ``ops/space_to_depth.py``.  The 7x7x7 stride-2 SAME stem conv on
C_in=3 (pads (2,3) at even extents) equals a 4x4x4 stride-1 conv with
C_in=24 and pads (1,2) on the input packed by 2x2x2 blocks: for a packed
axis, output i reads original positions 2i + j - pad_lo, i.e. cell
floor((j - pad_lo)/2) and parity (j - pad_lo) % 2, so the kernel's taps split
by parity.  Channel order is (parity_t, parity_h, parity_w, c).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def pack_input(x: torch.Tensor, axes: Sequence[int] = (1, 2, 3)) -> torch.Tensor:
    """Pack factor-2 blocks of `axes` into channels: [..., C] -> [..., 2^k C]."""
    axes = sorted(a % x.dim() for a in axes)
    for ax in axes:
        if x.shape[ax] % 2:
            raise ValueError(f"axis {ax} extent {x.shape[ax]} is odd")
    shape = []
    for i, s in enumerate(x.shape):
        shape += [s // 2, 2] if i in axes else [s]
    out = x.reshape(shape)
    # position of each axis (and of each parity) after the splits
    pos, parity, p = [], [], 0
    for i in range(x.dim()):
        pos.append(p)
        if i in axes:
            parity.append(p + 1)
            p += 2
        else:
            p += 1
    others = [pos[i] for i in range(x.dim() - 1)]
    out = out.permute(others + parity + [pos[-1]])
    new = [x.shape[i] // 2 if i in axes else x.shape[i] for i in range(x.dim() - 1)]
    return out.reshape(new + [x.shape[-1] * 2 ** len(axes)])


def pack_kernel_axis(kernel: torch.Tensor, axis: int, pad_lo: int):
    """Split one tap axis by parity: [.., K, ..] -> [.., K', 2, ..] plus the
    packed pads (lo, hi)."""
    k = kernel.shape[axis]
    shift = pad_lo % 2
    padded = k + shift
    if padded % 2:
        padded += 1
    cfg = [0, 0] * kernel.dim()
    # F.pad lists pads from the last dim backwards
    j = kernel.dim() - 1 - axis
    cfg[2 * j], cfg[2 * j + 1] = shift, padded - k - shift
    kp = F.pad(kernel, cfg)
    shape = list(kp.shape)
    shape[axis : axis + 1] = [padded // 2, 2]
    kp = kp.reshape(shape)
    lo = (pad_lo + 1) // 2
    return kp, (lo, padded // 2 - 1 - lo)


def pack_conv_spatiotemporal(
    kernel: torch.Tensor, pad_lo: Tuple[int, int, int]
) -> Tuple[torch.Tensor, Tuple[Tuple[int, int], ...]]:
    """DHWIO [kT,kH,kW,Cin,Cout] -> packed [kT',kH',kW',8Cin,Cout] + pads."""
    kp, pad_t = pack_kernel_axis(kernel, 0, pad_lo[0])
    kp, pad_h = pack_kernel_axis(kp, 2, pad_lo[1])
    kp, pad_w = pack_kernel_axis(kp, 4, pad_lo[2])
    kt, pt, kh, ph, kw, pw, cin, cout = kp.shape
    kp = kp.permute(0, 2, 4, 1, 3, 5, 6, 7).reshape(kt, kh, kw, pt * ph * pw * cin, cout)
    return kp, (pad_t, pad_h, pad_w)


def pack_stem_kernel(kernel_oidhw: torch.Tensor) -> torch.Tensor:
    """The stem's OIDHW [64,3,7,7,7] kernel -> packed DHWIO [4,4,4,24,64]
    (stride 1, pads (1,2) on every axis)."""
    kp, pads = pack_conv_spatiotemporal(kernel_oidhw.permute(2, 3, 4, 1, 0), (2, 2, 2))
    if pads != ((1, 2), (1, 2), (1, 2)):
        raise ValueError(f"unexpected packed stem pads {pads}")
    return kp.contiguous()
