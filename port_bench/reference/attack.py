"""The attack's optimizer step, written out plainly in float32.

The flickering attack of Pony et al. (arXiv:2002.05123) as its reference
code states it, in both input worlds:

* tanh (I3D): x = u8/128 - 1 (a float clip is taken as it is), delta clipped
  to +-0.4, adv = clip(x + delta, -1, 1);
* mean/std (the video ResNets): x = (u8/255 - mean)/std, delta clipped to
  +-max_norm and divided by std, adv = clip(x + delta, lo, hi) with the
  scalar range lo = max_c(-mean_c/std_c), hi = min_c((1 - mean_c)/std_c).

Clipping is min(max(x, lo), hi), whose gradient is 1/2 at an exact bound.
The loss is the untargeted "improved" hinge on probabilities, summed over the
batch: gap = p_label - (p_max_other - m), max(0, min(gap^2/m, gap)), with
p_max_other = max(p - onehot(label)); plus beta0 times the regularizers of
delta (tanh: raw delta, b1*thin + b2*diff + b3*lap; mean/std: delta clipped
to +-max_norm, b1*thin + (1-b1)*(diff + lap)), thin = mean(d^2), diff =
mean((d - roll(d,1))^2), lap = mean((-2d + roll(d,1) + roll(d,-1))^2), each
+ 1e-12, the roll over time.  Adam is optax's: b1 0.9, b2 0.999, eps 1e-8,
bias-corrected.  The batch runs in blocks of clips, its gradient summed.

``grad_clips`` (a control, never the reference itself) lets the gradient
flow from the batch's first ``grad_clips`` clips alone, scaled by B over
them (the mean taken over the rest), while every clip's logits, loss and
probabilities stay as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)
TANH_DELTA_CLIP = 0.4
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _clip(x, lo, hi):
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def adversarial_clip(world: str, video: torch.Tensor, delta: torch.Tensor, max_norm: float):
    """The perturbed clip [B,T,H,W,3] in f32; delta [T,1,1,3] (shared) or
    [B,T,1,1,3] (one a clip)."""
    d = delta if delta.dim() == video.dim() else delta[None]
    if world == "tanh":
        x = video.float() / 128.0 - 1.0 if video.dtype == torch.uint8 else video.float()
        return _clip(x + _clip(d, -TANH_DELTA_CLIP, TANH_DELTA_CLIP), -1.0, 1.0)
    mean = torch.tensor(KINETICS_MEAN, device=video.device)
    std = torch.tensor(KINETICS_STD, device=video.device)
    x = video.float()
    if video.dtype == torch.uint8:
        x = x / 255.0
    x = (x - mean) / std
    lo = max(-m / s for m, s in zip(KINETICS_MEAN, KINETICS_STD))
    hi = min((1.0 - m) / s for m, s in zip(KINETICS_MEAN, KINETICS_STD))
    return _clip(x + _clip(d, -max_norm, max_norm) / std, lo, hi)


def hinge(logits: torch.Tensor, labels: torch.Tensor, margin: float):
    """The untargeted improved hinge, summed over the batch, and the sums of
    p_label and p_max_other."""
    p = torch.softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), p.shape[-1]).float()
    p_label, p_other = (p * onehot).sum(-1), (p - onehot).amax(-1)
    gap = p_label - (p_other - margin)
    loss = torch.clamp(torch.minimum(gap ** 2 / margin, gap), min=0.0).sum()
    return loss, p_label.detach().sum(), p_other.detach().sum()


def regularizer(world: str, delta: torch.Tensor, attack: Dict) -> torch.Tensor:
    eps = 1e-12
    if world == "meanstd":
        delta = _clip(delta, -attack["max_norm"], attack["max_norm"])
    prev, nxt = torch.roll(delta, 1, dims=0), torch.roll(delta, -1, dims=0)
    thin = (delta ** 2).mean() + eps
    diff = ((delta - prev) ** 2).mean() + eps
    lap = ((-2.0 * delta + prev + nxt) ** 2).mean() + eps
    if world == "meanstd":
        return attack["beta1"] * thin + (1.0 - attack["beta1"]) * (diff + lap)
    return attack["beta1"] * thin + attack["beta2"] * diff + attack["beta3"] * lap


def adam(delta, mu, nu, count: int, grad, lr: float):
    """optax.adam's update after `count` earlier steps."""
    t = count + 1
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * grad ** 2 + ADAM_B2 * nu
    mu_hat = mu / (1 - ADAM_B1 ** t)
    nu_hat = nu / (1 - ADAM_B2 ** t)
    return delta - lr * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS), mu, nu


def _gradient_from(z: torch.Tensor, first: int, grad_clips: int, scale: float) -> torch.Tensor:
    """z, clips [first, first + len(z)) of a batch, with the same value and
    a gradient that flows from the batch's clips below `grad_clips` alone,
    times `scale`."""
    kept = (torch.arange(first, first + z.shape[0], device=z.device) < grad_clips)[:, None]
    return torch.where(kept, z * scale - z.detach() * (scale - 1.0), z.detach())


def loss_and_grad(logits_fn: Callable, world: str, video: torch.Tensor, labels: torch.Tensor,
                  delta: torch.Tensor, attack: Dict, block: int, grad_clips: Optional[int] = None):
    """(total loss, d(total)/d(delta), the batch's mean p_label and mean
    p_max_other, its logits) of one batch, `block` clips at a time."""
    d = delta.detach().clone().requires_grad_(True)
    total = attack["beta0"] * regularizer(world, d, attack)
    total.backward()
    total, p_label, p_other, logits = total.detach(), 0.0, 0.0, []
    n = video.shape[0]
    for i in range(0, n, block):
        part = slice(i, i + block)
        adv = adversarial_clip(world, video[part], d, attack.get("max_norm", 1.0))
        z = logits_fn(adv)
        zg = z if grad_clips is None else _gradient_from(z, i, grad_clips,
                                                         n / grad_clips if grad_clips else 0.0)
        loss, pl, po = hinge(zg, labels[part], attack["margin"])
        loss.backward()
        total, p_label, p_other = total + loss.detach(), p_label + pl, p_other + po
        logits.append(z.detach())
    return total, d.grad.detach(), float(p_label) / n, float(p_other) / n, torch.cat(logits)


def hinge_branch(probs: torch.Tensor, labels: torch.Tensor, margin: float):
    """(slope, rival) of each clip's hinge at probabilities `probs` [B, K]:
    d(hinge)/d(gap) (0 below gap 0, 2 gap / margin up to the margin, 1
    above) and the class of p_max_other."""
    p = probs.double()
    onehot = torch.nn.functional.one_hot(labels.long().to(p.device), p.shape[-1]).double()
    p_label, rival = (p * onehot).sum(-1), (p - onehot).argmax(-1)
    gap = p_label - (p.gather(-1, rival[:, None])[:, 0] - margin)
    slope = torch.where(gap >= margin, torch.ones_like(gap),
                        torch.clamp(2.0 * gap / margin, min=0.0))
    return slope, rival


def clip_basis(logits_fn: Callable, world: str, video: torch.Tensor, labels: torch.Tensor,
               delta: torch.Tensor, attack: Dict, slope: torch.Tensor, rival: torch.Tensor):
    """(the regularizers' share of d(total)/d(delta), [each clip's share])
    at `delta`, each clip's hinge taken on the branch and rival class given
    (``hinge_branch`` of the program's probabilities): slope_i times the
    gradient of p_label - p_rival, a clip at a time."""
    d = delta.detach().clone().requires_grad_(True)
    (reg,) = torch.autograd.grad(attack["beta0"] * regularizer(world, d, attack), d)
    shares = []
    for i in range(video.shape[0]):
        adv = adversarial_clip(world, video[i:i + 1], d, attack.get("max_norm", 1.0))
        p = torch.softmax(logits_fn(adv).float(), dim=-1)[0]
        gap = p[int(labels[i])] - p[int(rival[i])]
        (g,) = torch.autograd.grad(float(slope[i]) * gap, d)
        shares.append(g.detach())
    return reg.detach(), shares


def follow(logits_fn: Callable, world: str, batches: Sequence, delta0: torch.Tensor,
           attack: Dict, block: int, grad_clips: Optional[int] = None) -> Dict[str, List]:
    """The reference's steps from delta0, one a (video, labels) of
    `batches`: the loss of each (on the pre-update delta), its mean p_label
    and p_max_other and its logits, each gradient, and delta after each
    step."""
    delta = delta0.float()
    mu, nu = torch.zeros_like(delta), torch.zeros_like(delta)
    out = {"loss": [], "grad": [], "delta": [], "p_label": [], "p_other": [], "logits": []}
    for count, (video, labels) in enumerate(batches):
        loss, g, p_label, p_other, z = loss_and_grad(logits_fn, world, video, labels, delta,
                                                     attack, block, grad_clips)
        out["logits"].append(z)
        delta, mu, nu = adam(delta, mu, nu, count, g, attack["learning_rate"])
        out["loss"].append(float(loss))
        out["p_label"].append(p_label)
        out["p_other"].append(p_other)
        out["grad"].append(g)
        out["delta"].append(delta.clone())
    return out
