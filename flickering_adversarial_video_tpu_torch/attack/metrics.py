"""Perceptual and fooling metrics (port of the JAX package's attack/metrics.py).

thickness = mean|d|, roughness = mean|d - roll(d, 1)|; a batch is fooled when
every argmax(adv) != label (untargeted) or == target (targeted);
fooling_counts gives the (miss, valid) counters, where with
exclude_misclassify only clips the clean model gets right count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def thickness(delta: torch.Tensor) -> torch.Tensor:
    return delta.abs().mean()


def roughness(delta: torch.Tensor) -> torch.Tensor:
    return (delta - torch.roll(delta, 1, dims=0)).abs().mean()


def relative_percent(value, full_scale: float = 2.0):
    return value / full_scale * 100.0


def _target(pred, labels, target_class):
    return labels if target_class is None else torch.full_like(pred, target_class)


def is_adversarial(
    adv_probs: torch.Tensor, labels: torch.Tensor, *, targeted: bool = False,
    target_class: Optional[int] = None,
) -> torch.Tensor:
    pred = adv_probs.argmax(-1)
    if targeted:
        return (pred == _target(pred, labels, target_class)).all()
    return (pred != labels).all()


def fooling_counts(
    adv_probs, clean_probs, labels, *, targeted: bool = False,
    target_class: Optional[int] = None, exclude_misclassify: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    adv_pred = adv_probs.argmax(-1)
    if targeted:
        miss_cond = adv_pred == _target(adv_pred, labels, target_class)
    else:
        miss_cond = adv_pred != labels
    if exclude_misclassify:
        valid = clean_probs.argmax(-1) == labels
        return (miss_cond & valid).sum().to(torch.int32), valid.sum().to(torch.int32)
    return miss_cond.sum().to(torch.int32), torch.full(
        (), labels.shape[0], dtype=torch.int32, device=labels.device
    )
