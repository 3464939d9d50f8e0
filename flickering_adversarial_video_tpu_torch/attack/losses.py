"""Adversarial losses: the "improved" hinge and the CE loss, each targeted or
untargeted, on probabilities or logits.

Port of the JAX package's ``attack/losses.py``, quirks kept: the max
non-label statistic is max(x - one_hot(label)), and the logit-mode margins
are log(1 + m / label_prob) (targeted) and log(1 + m / (1e-5 +
max_non_label_prob)) (untargeted).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class PredictionStats(NamedTuple):
    label_prob: torch.Tensor
    max_non_label_prob: torch.Tensor
    label_logits: torch.Tensor
    max_non_label_logits: torch.Tensor
    probs: torch.Tensor


def label_and_max_other(logits: torch.Tensor, labels: torch.Tensor) -> PredictionStats:
    z = logits.float()
    probs = torch.softmax(z, dim=-1)
    classes = torch.arange(z.shape[-1], device=z.device)
    one_hot = (labels.long()[:, None] == classes).to(probs.dtype)
    return PredictionStats(
        (probs * one_hot).sum(-1),
        (probs - one_hot).amax(-1),
        (z * one_hot).sum(-1),
        (z - one_hot).amax(-1),
        probs,
    )


def improved_hinge_loss(
    logits, labels, *, margin: float = 0.05, targeted: bool = False, use_logits: bool = False
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    s = label_and_max_other(logits, labels)
    if targeted:
        if use_logits:
            to_min, to_max = s.max_non_label_logits, s.label_logits
            loss_margin = torch.log(1.0 + margin * (1.0 / s.label_prob))
        else:
            to_min, to_max = s.max_non_label_prob, s.label_prob
            loss_margin = torch.full_like(s.label_prob, margin)
        prob_to_min, prob_to_max = s.max_non_label_prob, s.label_prob
    else:
        if use_logits:
            to_min, to_max = s.label_logits, s.max_non_label_logits
            loss_margin = torch.log(1.0 + margin * (1.0 / (1e-5 + s.max_non_label_prob)))
        else:
            to_min, to_max = s.label_prob, s.max_non_label_prob
            loss_margin = torch.full_like(s.label_prob, margin)
        prob_to_min, prob_to_max = s.label_prob, s.max_non_label_prob
    gap = to_min - (to_max - loss_margin)
    per_example = torch.maximum(torch.zeros_like(gap), torch.minimum(gap**2 / loss_margin, gap))
    aux = {"prob_to_min": prob_to_min, "prob_to_max": prob_to_max,
           "per_example": per_example, "probs": s.probs}
    return per_example.sum(), aux


def ce_attack_loss(
    logits, labels, *, targeted: bool = False
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    s = label_and_max_other(logits, labels)
    if targeted:
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        per_example = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
        prob_to_min, prob_to_max = s.max_non_label_prob, s.label_prob
    else:
        per_example = -torch.log(1.0 - s.label_prob + 1e-6)
        prob_to_min, prob_to_max = s.label_prob, s.max_non_label_prob
    aux = {"prob_to_min": prob_to_min, "prob_to_max": prob_to_max,
           "per_example": per_example, "probs": s.probs}
    return per_example.mean(), aux


def adversarial_loss(
    logits, labels, *, improve_loss: bool = True, margin: float = 0.05,
    targeted: bool = False, use_logits: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The IMPROVE_ADV_LOSS switch."""
    if improve_loss:
        return improved_hinge_loss(
            logits, labels, margin=margin, targeted=targeted, use_logits=use_logits
        )
    return ce_attack_loss(logits, labels, targeted=targeted)
