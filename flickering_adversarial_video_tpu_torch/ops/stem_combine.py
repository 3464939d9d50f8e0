"""The concat-kernel input-gradient of a frozen conv, with kernel B2.

Port of ``stem_tmajor._catbwd_part`` / ``_catbwd_lane_combine``
(``ops/stem_tmajor.py:200-241``) on NDHWC.  The input gradient of a
stride-1 conv with a [KT,kh,kw] kernel is computed as

1. ``catbwd_part``: ONE wide spatial conv of the upstream gradient with all
   KT spatially flipped tap kernels concatenated on output channels
   (``part`` [B,T,H,W,KT*Cin], tap m's block at channels [m*Cin, (m+1)*Cin)).
   This conv was plain XLA in the JAX package and stays a plain
   ``torch.nn.functional.conv2d`` here.
2. ``temporal_combine`` (B2): ``dx[t] = sum_m part_m[t + t_plo - m]``, zero
   past the edges, added in the tensor dtype in ascending m.  It replaces the
   Pallas ``catbwd_lane_combine_pallas`` (``ops/stem_combine_pallas.py:74``,
   ``_kernel`` :63); CUDA source ``csrc/stem_combine.cu``.  Bound by bytes on
   the H100 (read part once, write dx once).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .accounting import nbytes, record


def catbwd_part(
    g2: torch.Tensor, w: torch.Tensor, pads: Tuple[Tuple[int, int], Tuple[int, int]]
) -> torch.Tensor:
    """g2 [B,T,H,W,Cout], w OIDHW [Cout,Cin,KT,kh,kw], pads the transposed
    spatial pads ((h_lo, h_hi), (w_lo, w_hi)) -> part [B,T,H,W,KT*Cin]."""
    b, t, h, wd, cout = g2.shape
    _, cin, kt, kh, kw = w.shape
    wb = w.flip(3, 4).permute(2, 1, 0, 3, 4).reshape(kt * cin, cout, kh, kw)
    wb = wb.to(g2.dtype).contiguous(memory_format=torch.channels_last)
    g = g2.reshape(b * t, h, wd, cout).permute(0, 3, 1, 2)
    (hl, hh), (wl, wh) = pads
    ph, pw = max(hl, hh), max(wl, wh)
    part = F.conv2d(g, wb, padding=(ph, pw))
    # symmetric padding by the larger side, then the window of the asked pads
    part = part[:, :, ph - hl : ph - hl + h, pw - wl : pw - wl + wd]
    return part.permute(0, 2, 3, 1).reshape(b, t, h, wd, kt * cin)


def _shift_t(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[:, t] = x[:, t + s], zero past the temporal edge."""
    if s == 0:
        return x
    n = x.shape[1]
    out = torch.zeros_like(x)
    if abs(s) < n:
        if s > 0:
            out[:, : n - s] = x[:, s:]
        else:
            out[:, -s:] = x[:, : n + s]
    return out


def temporal_combine_plain(part: torch.Tensor, cin: int, t_plo: int) -> torch.Tensor:
    n_taps = part.shape[-1] // cin
    acc = None
    for m in range(n_taps):
        sl = _shift_t(part[..., m * cin : (m + 1) * cin], t_plo - m)
        acc = sl if acc is None else acc + sl
    return acc.contiguous()


def temporal_combine(part: torch.Tensor, cin: int, t_plo: int) -> torch.Tensor:
    """B2: part [B,T,H,W,KT*Cin] -> dx [B,T,H,W,Cin]."""
    if part.dim() != 5 or part.shape[-1] % cin:
        raise ValueError(f"part {tuple(part.shape)} is not [B,T,H,W,KT*{cin}]")
    record("B2", 0, nbytes(part) * (1 + cin / part.shape[-1]))
    if not part.is_cuda:
        return temporal_combine_plain(part, cin, t_plo)
    part = part.contiguous()
    b, t, h, w, ktc = part.shape
    code = kernels.check(part)
    out = torch.empty((b, t, h, w, cin), dtype=part.dtype, device=part.device)
    kernels.launch(
        "fav_temporal_combine", part.data_ptr(), out.data_ptr(),
        b, t, h * w, cin, ktc // cin, t_plo, code, kernels.stream(),
    )
    temporal_combine.launches += 1
    return out


temporal_combine.launches = 0
