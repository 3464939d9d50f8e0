"""The stride-1 3x3x3 SAME max pool (Inception branch_3), kernels B3 and B4.

Port of ``ops/pool_s1_view_pallas.py`` and ``stem_tmajor.stride1_pool333_view``
(``ops/stem_tmajor.py:893-909``) of the JAX package, on NDHWC [B,T,H,W,C]
instead of the TPU's [H,W,C,T'B] view.

* B3 ``pool333_fwd`` replaces ``_fwd_impl`` (``pool_s1_view_pallas.py:331``,
  ``_fwd_kernel`` :140); CUDA source ``csrc/pool_s1.cu``.  It also computes
  ``overlap_pool_333`` (``ops/pallas_pool.py:664``: ``_overlap_fwd_kernel``
  :132, ``_overlap_fwd_kernel_blocked`` :148 and the conv-layout
  ``_conv_fwd_kernel`` :593), the same pool on b-major NDHWC in three TPU
  blockings (held in ``tests/test_torch_port_pool_pair.py``).
* B4 ``pool333_bwd`` replaces ``_bwd_impl`` (:370, ``_bwd_kernel`` :166).
* ``max_pool_333`` is the autograd op (the counterpart of the public VJP
  ``s1_pool333_view_pallas`` :427): B3 forward, B4 backward, x the only
  residual.

Both are bound by bytes on the H100 (one read of x, one write of y; reads of
x and dy, one write of dx).  The design notes are in the CUDA source.  The
backward routes T, then H, then W, each stage summing in f32 in ascending tap
order, and rounds once: the plain version's arithmetic, so B4 is bit-equal
to it (for finite dy).  The TPU kernel adds in the cotangent dtype per
routing stage: equal in f32, within bf16 rounding otherwise.
"""

from __future__ import annotations

import torch

from . import kernels
from .accounting import nbytes, record
from .maxpool import max_pool_plain, max_pool_route_plain

WINDOW, STRIDES = (3, 3, 3), (1, 1, 1)


def pool333_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return max_pool_plain(x, WINDOW, STRIDES)


def pool333_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """First-match routing (T, then H, then W) with f32 sums, one rounding."""
    return max_pool_route_plain(x.float(), dy.float(), WINDOW, STRIDES).to(dy.dtype)


def _dims(x: torch.Tensor):
    if x.dim() != 5:
        raise ValueError(f"expected NDHWC [B,T,H,W,C], got {tuple(x.shape)}")
    return x.shape


def pool333_fwd(x: torch.Tensor) -> torch.Tensor:
    """B3: y = 3x3x3 stride-1 SAME max pool of x (NDHWC)."""
    record("B3", 0, 2 * nbytes(x))
    if not x.is_cuda:
        return pool333_fwd_plain(x)
    b, t, h, w, c = _dims(x)
    code = kernels.check(x)
    y = torch.empty_like(x)
    kernels.launch(
        "fav_pool_s1_fwd", x.data_ptr(), y.data_ptr(), b, t, h, w, c, code, kernels.stream()
    )
    pool333_fwd.launches += 1
    return y


pool333_fwd.launches = 0


def pool333_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """B4: dx of the pool from x and dy (first match in raster t, h, w)."""
    record("B4", 0, nbytes(x) + 2 * nbytes(dy))
    if not x.is_cuda:
        return pool333_bwd_plain(x, dy)
    b, t, h, w, c = _dims(x)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    code = kernels.check(x, dy)
    dx = torch.empty_like(dy)
    kernels.launch(
        "fav_pool_s1_bwd", x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        b, t, h, w, c, code, kernels.stream(),
    )
    pool333_bwd.launches += 1
    return dx


pool333_bwd.launches = 0


class _Pool333(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool333_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return pool333_bwd(x, dy.contiguous())


def max_pool_333(x: torch.Tensor) -> torch.Tensor:
    """(3,3,3)/(1,1,1) SAME max pool over NDHWC: B3 forward, B4 backward."""
    return _Pool333.apply(x.contiguous())
