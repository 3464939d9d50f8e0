"""The (1,3,3)/(1,2,2) SAME spatial max pool, pads (0,1), kernel B5.

Port of ``stem_tmajor.strided_pool_view`` (``ops/stem_tmajor.py:718-830``)
of the JAX package on NDHWC [B,T,H,W,C] with even H and W: MaxPool3d_2a,
MaxPool3d_3a and the spatial half of MaxPool3d_4a.

* B5 ``pool133_s2_fwd`` replaces the Pallas ``_strided_fwd_kernel``
  (``ops/pallas_pool.py:206``) as ``strided_pool_view`` launches it (:754);
  CUDA source ``csrc/pool_strided.cu``.  Bound by bytes on the H100.
* B6 ``pool133_s2_bwd`` is the backward: a window's cotangent goes to its
  first maximal element in H-then-W raster order (the GE select rule of the
  XLA select-and-scatter the JAX package runs here, :796-827).  Its kernel
  replaces the Pallas ``s2_pool_view_bwd_pallas``
  (``ops/pool_s2_view_pallas.py:246``), gated off in the JAX package and on
  the main path here; same CUDA source.  Bound by bytes.  A cell's up to four
  window contributions are summed in f32 and rounded once, in the kernel and
  in its plain version.
"""

from __future__ import annotations

import torch

from . import kernels
from .maxpool import max_pool_plain, max_pool_route_plain

WINDOW, STRIDES = (1, 3, 3), (1, 2, 2)


def pool133_s2_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return max_pool_plain(x, WINDOW, STRIDES)


def pool133_s2_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """First-match routing (H, then W) with f32 sums, one rounding."""
    return max_pool_route_plain(x.float(), dy.float(), WINDOW, STRIDES).to(dy.dtype)


def pool133_s2_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """B6: dx of the pool from x and dy."""
    if not x.is_cuda:
        return pool133_s2_bwd_plain(x, dy)
    b, t, h, w, c = x.shape
    if dy.shape != (b, t, h // 2, w // 2, c):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
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
