"""Perceptual regularizers on the flickering delta (time on axis 0).

Port of the JAX package's ``attack/regularizers.py``:
thinness mean(d^2), first-order mean((d - roll(d,1))^2), second-order
mean((-2d + roll(d,1) + roll(d,-1))^2), each + 1e-12; L1,2 sum_t
sqrt(mean over the other dims of d^2) + 1e-12.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def thinness_reg(delta: torch.Tensor) -> torch.Tensor:
    return (delta**2).mean() + _EPS


def first_order_diff_reg(delta: torch.Tensor) -> torch.Tensor:
    return ((delta - torch.roll(delta, 1, dims=0)) ** 2).mean() + _EPS


def second_order_diff_reg(delta: torch.Tensor) -> torch.Tensor:
    lap = -2.0 * delta + torch.roll(delta, 1, dims=0) + torch.roll(delta, -1, dims=0)
    return (lap**2).mean() + _EPS


def l12_regularizer(delta: torch.Tensor) -> torch.Tensor:
    per_frame = (delta**2).mean(dim=tuple(range(1, delta.dim())))
    return torch.sqrt(per_frame).sum() + _EPS
