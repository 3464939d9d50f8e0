"""The (1,3,3)/(1,2,2) SAME spatial max pool, pads (0,1): kernels B5, B6, B9.

Port of ``stem_tmajor.strided_pool_view`` (``ops/stem_tmajor.py:718-830``)
of the JAX package on NDHWC [B,T,H,W,C] with even H and W: MaxPool3d_2a,
MaxPool3d_3a and the spatial half of MaxPool3d_4a.

* B5 ``pool133_s2_fwd`` replaces the Pallas ``_strided_fwd_kernel``
  (``ops/pallas_pool.py:206``) as ``strided_pool_view`` launches it (:754);
  CUDA source ``csrc/pool_strided.cu``, its body shared with B9's forward in
  ``csrc/pool_s2_strip.cuh``.  Bound by bytes on the H100.  The same function
  in the TPU's other layouts, which the port's b-major NDHWC makes one:
  ``strided_spatial_pool_conv`` (``ops/pallas_pool.py:263``, the same kernel
  body) and ``spatial_pool_132`` (:742, kernel :50); their backward is XLA's
  select-and-scatter, which is B6's rule.
* B6 ``pool133_s2_bwd`` is the backward: a window's cotangent goes where
  the XLA select-and-scatter (GE) the JAX package runs here (:796-827) sends
  it, its first maximal element in H-then-W raster order on NaN-free data.
  Its kernel replaces the Pallas ``s2_pool_view_bwd_pallas``
  (``ops/pool_s2_view_pallas.py:246``), gated off in the JAX package and on
  the main path here; same CUDA source.  The two JAX routes differ only on a
  window holding a NaN, where the Pallas kernel routes nothing; the port
  follows select-and-scatter.  Bound by bytes.  A cell's up to four window
  contributions are summed in f32 in ascending tap order and rounded once,
  in the kernel and in its plain version, so the two are bit-equal.
* B9 ``pool133_s2_pair_fwd`` / ``pool133_s2_pair_bwd`` replace the Pallas pair
  ``strided_spatial_pool_pair`` (``ops/pallas_pool.py:474``; ``_pair_fwd_kernel``
  :397, ``_pair_bwd_kernel`` :429): the forward also stores each window's
  first-match argmax index k = kh*3+kw (uint8; 9 where no candidate equals
  the value, i.e. NaN), and the backward routes dy by that index alone, so
  the autograd op ``max_pool_133_s2_pair`` saves the index and never x.  CUDA
  source ``csrc/pool_pair.cu``; both bound by bytes.  The same f32 sum, one
  rounding, as B6 (the TPU kernel adds in the cotangent dtype).

B5, B6 and B9 march a block down H over a frame's full width, a thread a
window column and 16-byte channel vector, so they take a width up to 1024
(the wrappers raise above it).

Callers route the pool by its static geometry, as the JAX package's
``_max_pool_same`` (``models/i3d.py:485-509``) and ``ops/maxpool.max_pool_same``
do: even H and W take B5/B6 (or the pair B9); an odd H or W takes the generic
SAME pool of ``ops/maxpool.py`` (pads (1,1) on that axis), which is XLA's
reduce-window and select-and-scatter in the JAX package, no Pallas kernel,
with the pair switch set or not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels
from .accounting import nbytes, record
from .maxpool import max_pool_plain

WINDOW, STRIDES = (1, 3, 3), (1, 2, 2)


def pool133_s2_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return max_pool_plain(x, WINDOW, STRIDES)


def pool133_s2_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """XLA's select-and-scatter (GE) routing, with f32 sums in ascending tap
    order and one rounding: each window scans its 9 taps in raster order,
    pads (-inf) included, and moves to a tap unless the kept value is >= it.
    Without NaN that is the first maximum in H-then-W order; a NaN is taken
    and then left for the next tap (a pad taken so routes nothing)."""
    cands = _window_candidates(x.float())
    kept = cands[0]
    idx = torch.zeros(kept.shape, dtype=torch.uint8, device=x.device)
    for k in range(1, 9):
        move = ~(kept >= cands[k])
        kept = torch.where(move, cands[k], kept)
        idx = torch.where(move, torch.full_like(idx, k), idx)
    return pool133_s2_pair_bwd_plain(idx, dy)


MAX_WIDTH = 1024  # the strip kernels' full-width rows: W/2 threads a channel vector


def _check_width(w: int, kernel: str) -> None:
    if w > MAX_WIDTH:
        raise ValueError(f"the {kernel} kernel takes a width up to {MAX_WIDTH}; got {w}")


def pool133_s2_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """B6: dx of the pool from x and dy."""
    record("B6", 0, nbytes(x) + nbytes(dy) + x.numel() * dy.element_size())
    if not x.is_cuda:
        return pool133_s2_bwd_plain(x, dy)
    b, t, h, w, c = x.shape
    if dy.shape != (b, t, h // 2, w // 2, c):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    _check_width(w, "B6")
    code = kernels.check(x, dy)
    dx = torch.empty_like(x, dtype=dy.dtype)
    kernels.launch(
        "fav_pool_s2_bwd", x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        b * t, h, w, c, code, kernels.stream(),
    )
    pool133_s2_bwd.launches += 1
    return dx


pool133_s2_bwd.launches = 0


def pool133_s2_fwd(x: torch.Tensor) -> torch.Tensor:
    """B5: y[b,t,ho,wo,c] = max of rows 2ho..2ho+2, cols 2wo..2wo+2 in range."""
    if x.dim() != 5 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"expected NDHWC with even H, W; got {tuple(x.shape)}")
    _check_width(x.shape[3], "B5")
    record("B5", 0, nbytes(x) * 5 // 4)
    if not x.is_cuda:
        return pool133_s2_fwd_plain(x)
    b, t, h, w, c = x.shape
    code = kernels.check(x)
    y = torch.empty((b, t, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    kernels.launch(
        "fav_pool_s2_fwd", x.data_ptr(), y.data_ptr(), b * t, h, w, c, code, kernels.stream()
    )
    pool133_s2_fwd.launches += 1
    return y


pool133_s2_fwd.launches = 0


class _Pool133S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool133_s2_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return pool133_s2_bwd(x, dy.contiguous())


def max_pool_133_s2(x: torch.Tensor) -> torch.Tensor:
    """(1,3,3)/(1,2,2) SAME max pool over NDHWC: B5 forward, B6 backward."""
    return _Pool133S2.apply(x.contiguous())


def _window_candidates(x: torch.Tensor) -> list:
    """The 9 candidates of every window in row-major order k = kh*3+kw, each
    [B,T,H/2,W/2,C]; -inf outside the frame (the (0,1) pads)."""
    b, t, h, w, c = x.shape
    xp = x.new_full((b, t, h + 1, w + 1, c), float("-inf"))
    xp[:, :, :h, :w] = x
    return [xp[:, :, kh : kh + h : 2, kw : kw + w : 2] for kh in range(3) for kw in range(3)]


def pool133_s2_pair_fwd_plain(
    x: torch.Tensor, want_idx: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, idx): the pool's values and, per window, the smallest k whose
    candidate equals the value compared in f32; 9 where none does."""
    cands = _window_candidates(x)
    y = cands[0]
    for cand in cands[1:]:
        y = torch.maximum(y, cand)
    y = y.contiguous()
    if not want_idx:
        return y, None
    y32 = y.float()
    idx = torch.full(y.shape, 9, dtype=torch.uint8, device=x.device)
    for k in range(8, -1, -1):  # descending: the smallest matching k wins
        idx = torch.where(cands[k].float() == y32, torch.full_like(idx, k), idx)
    return y, idx


def pool133_s2_pair_bwd_plain(idx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx from (idx, dy): tap k of window (a,b) is cell (2a+kh, 2b+kw); a
    cell's terms are summed in f32 in ascending k and rounded once."""
    b, t, ho, wo, c = dy.shape
    acc = torch.zeros((b, t, 2 * ho + 1, 2 * wo + 1, c), dtype=torch.float32, device=dy.device)
    g = dy.float()
    zero = torch.zeros_like(g)
    for k in range(9):
        kh, kw = divmod(k, 3)
        acc[:, :, kh : kh + 2 * ho : 2, kw : kw + 2 * wo : 2] += torch.where(idx == k, g, zero)
    return acc[:, :, : 2 * ho, : 2 * wo].to(dy.dtype).contiguous()


def pool133_s2_pair_fwd(
    x: torch.Tensor, want_idx: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B9 forward: (y, idx uint8), or (y, None) when no index is wanted (the
    kernel then writes values only)."""
    if x.dim() != 5 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"expected NDHWC with even H, W; got {tuple(x.shape)}")
    _check_width(x.shape[3], "B9 forward")
    record("B9f", 0, nbytes(x) * 5 // 4 + (x.numel() // 4 if want_idx else 0))
    if not x.is_cuda:
        return pool133_s2_pair_fwd_plain(x, want_idx)
    b, t, h, w, c = x.shape
    code = kernels.check(x)
    y = torch.empty((b, t, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(y.shape, dtype=torch.uint8, device=x.device) if want_idx else None
    kernels.launch(
        "fav_pool_pair_fwd", x.data_ptr(), y.data_ptr(), idx.data_ptr() if want_idx else None,
        b * t, h, w, c, code, kernels.stream(),
    )
    pool133_s2_pair_fwd.launches += 1
    return y, idx


pool133_s2_pair_fwd.launches = 0


def pool133_s2_pair_bwd(idx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """B9 backward: dx [B,T,2H',2W',C] of the pool from the index and dy."""
    if idx.dtype != torch.uint8 or idx.shape != dy.shape or dy.dim() != 5:
        raise ValueError(
            f"expected a uint8 index of dy's shape [B,T,H',W',C]; got {idx.dtype} "
            f"{tuple(idx.shape)} for dy {tuple(dy.shape)}"
        )
    _check_width(2 * dy.shape[3], "B9 backward")
    record("B9b", 0, nbytes(idx, dy) + 4 * nbytes(dy))
    if not dy.is_cuda:
        return pool133_s2_pair_bwd_plain(idx, dy)
    b, t, ho, wo, c = dy.shape
    code = kernels.check(dy)
    if idx.device != dy.device or not idx.is_contiguous():
        raise ValueError("the index must be contiguous and lie on dy's device")
    dx = torch.empty((b, t, 2 * ho, 2 * wo, c), dtype=dy.dtype, device=dy.device)
    kernels.launch(
        "fav_pool_pair_bwd", idx.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        b * t, ho, wo, c, code, kernels.stream(),
    )
    pool133_s2_pair_bwd.launches += 1
    return dx


pool133_s2_pair_bwd.launches = 0


class _Pool133S2Pair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want_grad):
        y, idx = pool133_s2_pair_fwd(x, want_idx=want_grad)
        if want_grad:
            ctx.save_for_backward(idx)  # never x
        return y

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return pool133_s2_pair_bwd(idx, dy.contiguous()), None


def max_pool_133_s2_pair(x: torch.Tensor) -> torch.Tensor:
    """(1,3,3)/(1,2,2) SAME max pool over NDHWC: B9 forward and backward.
    The residual is the uint8 index (a quarter of x's elements, one byte
    each); a forward that needs no gradient stores none."""
    want_grad = torch.is_grad_enabled() and x.requires_grad
    return _Pool133S2Pair.apply(x.contiguous(), want_grad)

