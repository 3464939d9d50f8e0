"""The video ResNets' frozen batch-norm epilogue, with kernel B12.

Forward, over the last (channel) dim of an NDHWC activation x of dtype T
(bfloat16 or float32), with f32 tables mean, mul (``rsqrt(var + eps) *
weight``, which ``models/video_resnet.BatchNorm3d`` computes) and bias [C]:

    y = relu(T(((x - mean) * mul) + bias) [+ residual])

flax's inference ``BatchNorm`` (``use_running_average=True``) in its op
order: f32, x promoted by the f32 statistics, then one cast to T.  Then,
where asked, ReLU, or a BasicBlock's residual add (in T) and ReLU; a
residual is added only before a ReLU.  Backward from the upstream g and the
saved y: ``g' = 0 where y <= 0 else g`` (where ReLU ran), ``dx =
T(f32(g') * mul)`` and ``d residual = g'``: what autograd computes through
the plain chain (``threshold_backward``, the casts, the broadcast multiply).

B12 replaces no Pallas kernel: the JAX package leaves this chain to XLA,
which fuses it.  In PyTorch the chain is about six elementwise kernels each
way; B12 is one CUDA kernel each way (``csrc/bn_epilogue.cu``: B12f the
forward, B12b the backward), bound by bytes on the H100, bit-equal to the
plain chain.  On a CPU tensor the wrappers compute the plain chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels
from .accounting import nbytes, record


def bn_epilogue_fwd_plain(x, mean, mul, bias, residual=None, relu=False) -> torch.Tensor:
    y = ((x - mean) * mul + bias).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def bn_epilogue_bwd_plain(g, mul, y=None, residual=False):
    """(dx, d residual or None); `y` the forward's output where ReLU ran
    (where a residual was added, too)."""
    gp = g if y is None else torch.ops.aten.threshold_backward(g, y, 0)
    return (gp.float() * mul).to(g.dtype), (gp if residual else None)


def _check_tables(x: torch.Tensor, *tables: torch.Tensor) -> None:
    for t in tables:
        if t.shape != (x.shape[-1],):
            raise ValueError(f"table {tuple(t.shape)} is not [C] of x {tuple(x.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"table dtype {t.dtype}, expected float32")
        if t.device != x.device:
            raise ValueError(f"table on {t.device}, x on {x.device}")


def bn_epilogue_fwd(x, mean, mul, bias, residual=None, relu=False) -> torch.Tensor:
    """B12f: y as the module docstring gives it, x's shape and dtype."""
    _check_tables(x, mean, mul, bias)
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not x's {tuple(x.shape)}")
    if residual is not None and not relu:
        raise ValueError("a residual is added only before a ReLU")
    record("B12f", 0, 2 * nbytes(x) + nbytes(residual, mean, mul, bias))
    if not x.is_cuda:
        return bn_epilogue_fwd_plain(x, mean, mul, bias, residual, relu)
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    code = kernels.check(x, *(() if residual is None else (residual,)))
    kernels.check(mean, mul, bias, dtype=torch.float32)
    y = torch.empty_like(x)
    if x.numel():
        kernels.launch(
            "fav_bn_epilogue_fwd", x.data_ptr(), 0 if residual is None else residual.data_ptr(),
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(),
            x.shape[-1], int(relu), code, kernels.stream(),
        )
        bn_epilogue_fwd.launches += 1
    return y


def bn_epilogue_bwd(g, mul, y=None, residual=False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B12b: (dx, d residual or None) from the upstream g; `y` the
    forward's output where ReLU ran (None: no ReLU, hence no residual)."""
    _check_tables(g, mul)
    if y is not None and y.shape != g.shape:
        raise ValueError(f"y {tuple(y.shape)} is not g's {tuple(g.shape)}")
    if residual and y is None:
        raise ValueError("a residual is added only before a ReLU")
    record("B12b", 0, nbytes(g, y, mul) + nbytes(g) * (2 if residual else 1))
    if not g.is_cuda:
        return bn_epilogue_bwd_plain(g, mul, y, residual)
    g = g.contiguous()
    y = None if y is None else y.contiguous()
    code = kernels.check(g, *(() if y is None else (y,)))
    kernels.check(mul, dtype=torch.float32)
    dx = torch.empty_like(g)
    dres = torch.empty_like(g) if residual else None
    if g.numel():
        kernels.launch(
            "fav_bn_epilogue_bwd", g.data_ptr(), 0 if y is None else y.data_ptr(),
            mul.data_ptr(), dx.data_ptr(), 0 if dres is None else dres.data_ptr(), g.numel(),
            g.shape[-1], code, kernels.stream(),
        )
        bn_epilogue_bwd.launches += 1
    return dx, dres


bn_epilogue_fwd.launches = 0
bn_epilogue_bwd.launches = 0


class _BNEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, mul, bias, residual, relu):
        y = bn_epilogue_fwd(x, mean, mul, bias, residual, relu)
        ctx.save_for_backward(mul, y if relu else None)
        ctx.residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, g):
        mul, y = ctx.saved_tensors
        dx, dres = bn_epilogue_bwd(g, mul, y, ctx.residual)
        return dx, None, None, None, dres, None


def bn_epilogue(x, mean, mul, bias, residual=None, relu=False) -> torch.Tensor:
    """The epilogue with its gradient to x (and the residual): B12f forward,
    B12b backward on CUDA tensors."""
    return _BNEpilogue.apply(x, mean, mul, bias, residual, relu)
