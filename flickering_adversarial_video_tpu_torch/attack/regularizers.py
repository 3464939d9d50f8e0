"""Perceptual regularizers on the flickering delta (time on axis 0).

Port of the JAX package's ``attack/regularizers.py``:
thinness mean(d^2), first-order mean((d - roll(d,1))^2), second-order
mean((-2d + roll(d,1) + roll(d,-1))^2), each + 1e-12; L1,2 sum_t
sqrt(mean over the other dims of d^2) + 1e-12.

Two weightings of the first three, as in the reference:
  * TF style (single_video_npy.py:56), ``flicker_regularizer``:
    b1*thin + b2*diff + b3*lap, b3 defaulting to b2 (the universal driver
    reuses beta_2 for the laplacian, i3d_adversarial_main_universal.py:130);
  * torch style (model.py:198-209), ``flicker_regularizer_torch``:
    b1*thin + (1-b1)*(diff + lap).
The attack engine sums its terms inline in its own op order (held bit-equal
on the card); these are the public functions.
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


def flicker_regularizer(delta: torch.Tensor, beta1=0.5, beta2=0.5, beta3=None) -> torch.Tensor:
    """TF-style weighted sum (i3d_adversarial_main_single_video_npy.py:56);
    beta3 defaults to beta2."""
    if beta3 is None:
        beta3 = beta2
    return (beta1 * thinness_reg(delta) + beta2 * first_order_diff_reg(delta)
            + beta3 * second_order_diff_reg(delta))


def flicker_regularizer_torch(delta: torch.Tensor, beta1=0.5) -> torch.Tensor:
    """Torch-style weighting (model.py:198-209)."""
    return beta1 * thinness_reg(delta) + (1.0 - beta1) * (
        first_order_diff_reg(delta) + second_order_diff_reg(delta))


def l12_regularizer(delta: torch.Tensor) -> torch.Tensor:
    per_frame = (delta**2).mean(dim=tuple(range(1, delta.dim())))
    return torch.sqrt(per_frame).sum() + _EPS
