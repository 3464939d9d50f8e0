"""SAME max pooling on NDHWC with the first-match routing backward.

Port of the JAX package's ``ops/maxpool.py`` (``_pool_axis``/``_route_axis``)
and of the view pools ``stem_tmajor.pool4a_view`` / ``pool5a_view``
(``ops/stem_tmajor.py:1018-1033``), in plain PyTorch.

A 3-D SAME max pool is separable: pool W, then H, then T.  Routing the
cotangent back T first, then H, then W, each stage sending a window's
gradient to the FIRST candidate equal to the pooled value, selects the
lexicographically first maximal element of the window in (t, h, w) raster
order -- the tie rule of XLA's select-and-scatter (GE) and of TF's
max_pool3d gradient.  These helpers are also the plain versions behind the
pool kernels of ``pool_s1.py`` (B3/B4) and ``pool_strided.py`` (B5).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NDHWC axes of T, H and W
T_AXIS, H_AXIS, W_AXIS = 1, 2, 3


def same_pads(n: int, w: int, s: int) -> Tuple[int, int, int]:
    """TF SAME: (out, pad_lo, pad_hi) for extent n, window w, stride s."""
    out = -(-n // s)
    total = max((out - 1) * s + w - n, 0)
    return out, total // 2, total - total // 2


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, value: float) -> torch.Tensor:
    if lo == 0 and hi == 0:
        return x
    shape = list(x.shape)
    shape[axis] = x.shape[axis] + lo + hi
    out = x.new_full(shape, value)
    out.narrow(axis, lo, x.shape[axis]).copy_(x)
    return out


def _strided(x: torch.Tensor, axis: int, start: int, count: int, s: int) -> torch.Tensor:
    """x[..., start : start + (count-1)*s + 1 : s, ...] along `axis` (a view)."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, start + (count - 1) * s + 1, s)
    return x[tuple(idx)]


def pool_axis(x: torch.Tensor, axis: int, w: int, s: int) -> torch.Tensor:
    """1-D SAME max pool along `axis`."""
    if w == 1 and s == 1:
        return x
    out, lo, hi = same_pads(x.shape[axis], w, s)
    xp = _pad_axis(x, axis, lo, hi, float("-inf"))
    acc = None
    for k in range(w):
        cand = _strided(xp, axis, k, out, s)
        acc = cand if acc is None else torch.maximum(acc, cand)
    return acc.contiguous()


def route_axis(
    g: torch.Tensor, pooled: torch.Tensor, source: torch.Tensor, axis: int, w: int, s: int
) -> torch.Tensor:
    """Send cotangent g (on the pooled grid) back onto the source grid along
    `axis`, each window to its first candidate equal to the pooled value.
    Adds run in g's dtype in ascending tap order."""
    if w == 1 and s == 1:
        return g
    n = source.shape[axis]
    out, lo, hi = same_pads(n, w, s)
    src = _pad_axis(source, axis, lo, hi, float("-inf"))
    shape = list(source.shape)
    shape[axis] = src.shape[axis]
    acc = g.new_zeros(shape)
    taken = torch.zeros(pooled.shape, dtype=torch.bool, device=g.device)
    for k in range(w):
        eq = (_strided(src, axis, k, out, s) == pooled) & ~taken
        taken |= eq
        view = _strided(acc, axis, k, out, s)
        view.add_(g * eq.to(g.dtype))
    return acc.narrow(axis, lo, n).contiguous()


def _pool3d(x, window, strides):
    """W, then H, then T; returns (m_w, m_hw, y)."""
    m_w = pool_axis(x, W_AXIS, window[2], strides[2])
    m_hw = pool_axis(m_w, H_AXIS, window[1], strides[1])
    y = pool_axis(m_hw, T_AXIS, window[0], strides[0])
    return m_w, m_hw, y


def max_pool_plain(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """tf.nn.max_pool3d(padding='SAME') over NDHWC, values only."""
    return _pool3d(x, window, strides)[2]


def max_pool_route_plain(
    x: torch.Tensor, dy: torch.Tensor, window: Sequence[int], strides: Sequence[int]
) -> torch.Tensor:
    """First-match gradient of max_pool_plain: routes T, then H, then W."""
    m_w, m_hw, y = _pool3d(x, window, strides)
    g = route_axis(dy, y, m_hw, T_AXIS, window[0], strides[0])
    g = route_axis(g, m_hw, m_w, H_AXIS, window[1], strides[1])
    return route_axis(g, m_w, x, W_AXIS, window[2], strides[2])


class _MaxPoolSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides):
        ctx.save_for_backward(x)
        ctx.window, ctx.strides = window, strides
        return max_pool_plain(x, window, strides)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return max_pool_route_plain(x, dy.contiguous(), ctx.window, ctx.strides), None, None


def max_pool_same(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """SAME max pool over NDHWC with the first-match backward; saves x only."""
    return _MaxPoolSame.apply(x, tuple(window), tuple(strides))


def pool4a(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d_4a_3x3 ((3,3,3)/(2,2,2)): the spatial (1,3,3)/(1,2,2) pool
    (kernel B5), then the temporal window-3 stride-2 pool.  The chained
    backward routes temporal first, then spatial -- the composite order."""
    from .pool_strided import max_pool_133_s2

    return max_pool_same(max_pool_133_s2(x), (3, 1, 1), (2, 1, 1))


def pool5a(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d_5a_2x2 ((2,2,2)/(2,2,2))."""
    return max_pool_same(x, (2, 2, 2), (2, 2, 2))
