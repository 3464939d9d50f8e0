"""The comparison that decides ``correct``.

Each number sets what the program's timed path produced against the
plain reference on the same inputs, taken by the worst step or slot; a
``_gap`` is a relative gap of magnitudes (|a - b| / |b|):

* ``loss_gap``: each checked step's total loss (on the pre-update delta);
* ``prob_gap``: each checked step's mean p_label and mean p_max_other, the
  two probabilities the hinge compares;
* ``logit_gap``: each checked step's logits, as the program's
  probabilities give them back, against the reference's: the relative
  error of the logit vector (the worst step);
* ``clean_logit_gap``: the same of a slot's clean clip, whose probabilities
  the sweep's clean check computed;
* ``grad_gap``: the norm of the first gradient as Adam got it, worked out
  from the program's first moment after one step (mu = (1 - b1) g);
* ``grad_dir_gap``: 1 - the cosine between that gradient and the
  reference's;
* ``grad_err``: the error of that gradient, element by element:
  ||g - g_ref|| / ||g_ref||;
* ``clip_weight_err``: each clip's weight in the program's gradient at each
  checked step (worked out from its first moments), fitted on the
  reference's gradient of each clip at the program's delta and on the
  program's own hinge branch (``clip_weights``), against the reference's
  weight of 1: the median of |c - 1| over the steps' clips (``_worst`` the
  largest).  A gradient of half the batch, the mean taken over it, reads 1;
* ``first_step_err``: the g^2-weighted share of delta's elements whose
  first step went against the reference's gradient, twice
  (``first_step_err``); in a sweep, the reference's gradient on the
  program's hinge branch and rival class at the slot's first step, since a
  clip whose two best other classes tie moves towards either;
* ``change_gap``: the norm of delta's change over the checked steps;
* ``change_err``: the error of that change, element by element:
  ||c - c_ref|| / ||c_ref||.  Adam's first steps move each element by about
  lr sign(g), so the norm of the change hardly sees the gradient; its
  error counts the elements that moved the other way;
* ``bookkeeping``: slots whose step count, escalations or final max_norm
  differ from what the sweep's stop rule gives on the slot's own verdicts
  (an exact count), and ``missing``: slots that gave no result.

A batched cell compares one run of steps over its batch; a sweep compares
each slot's, takes the worst and the median slot's numbers (``_worst``,
``_median``) and the logits of all slots at once.

delta is one leaf, so "the worst leaf" is that leaf.  Each number has its
limit in ``limits/<cell>.json``; a number above its limit, or one that is not
finite, makes the run incorrect.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Sequence

import torch

HERE = Path(__file__).resolve().parent


def rel(a: float, b: float) -> float:
    if b == 0:
        return 0.0 if a == 0 else math.inf
    return abs(a - b) / abs(b)


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double().cpu()))


def steps_numbers(losses: Sequence[float], delta_after: torch.Tensor, delta0: torch.Tensor,
                  ref: Dict[str, List], grads: Sequence[torch.Tensor] = None, bases=None,
                  probs=None, step_probs=None, delta_first: torch.Tensor = None,
                  first_grad_ref: torch.Tensor = None) -> Dict[str, float]:
    """The numbers of one checked run of steps against the reference's
    (``reference.attack.follow``); `delta_after` is the program's delta
    after the last checked step, `delta_first` after the first, `grads` its
    gradient at each checked step and `bases` the reference's shares of it
    there (``reference.attack.clip_basis``), `probs` each step's (mean
    p_label, mean p_max_other), `step_probs` each step's probabilities
    [B, classes].  `first_grad_ref` is the reference's first gradient on
    the program's hinge branch (``reference.attack.clip_basis``), against
    which the first step is read (by default the reference's own)."""
    n = len(ref["loss"])
    change = delta_after.cpu().double() - delta0.cpu().double()
    change_ref = ref["delta"][-1].cpu().double() - delta0.cpu().double()
    out = {
        "loss_gap": max(rel(float(a), b) for a, b in zip(losses[:n], ref["loss"])),
        "change_gap": rel(norm(change), norm(change_ref)),
        "change_err": error(change, change_ref),
    }
    if delta_first is not None:
        out["first_step_err"] = first_step_err(
            delta_first - delta0.to(delta_first.device),
            ref["grad"][0] if first_grad_ref is None else first_grad_ref)
    if grads is not None:
        g0 = grads[0]
        out["grad_gap"] = rel(norm(g0), norm(ref["grad"][0]))
        out["grad_err"] = error(g0, ref["grad"][0])
        g, r = g0.double().cpu().flatten(), ref["grad"][0].double().cpu().flatten()
        out["grad_dir_gap"] = 1.0 - float(g @ r / (g.norm() * r.norm()))
    if bases is not None:
        weights = torch.cat([clip_weights(g, reg, shares)
                             for g, (reg, shares) in zip(grads, bases)])
        out["clip_weight_err"] = float((weights - 1.0).abs().median())
        out["clip_weight_err_worst"] = float((weights - 1.0).abs().max())
    if probs is not None:
        out["prob_gap"] = max(max(rel(a, ra), rel(b, rb)) for (a, b), ra, rb in
                              zip(probs[:n], ref["p_label"], ref["p_other"]))
    if step_probs is not None:
        out["logit_gap"] = max(logit_gap(p, z) for p, z in zip(step_probs[:n], ref["logits"]))
    return out


def clip_weights(grad: torch.Tensor, reg_grad: torch.Tensor,
                 shares: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each clip's weight in the program's gradient at a step: the
    least-squares c of grad - reg_grad = sum_i c_i shares[i], the
    reference's share of each clip on the program's own hinge branch (a clip
    whose hinge is flat there, a zero share, has no weight to read).  The
    reference's weights are all 1; a clip whose hinge the program left out of
    the gradient reads 0, and one it counted twice 2.  The program's rounding
    error lies mostly outside the span of the clips' shares (B of T*3
    elements), so it moves the weights little."""
    g = (grad.double().cpu() - reg_grad.double().cpu()).reshape(-1, 1)
    cols = [c.double().cpu().reshape(-1) for c in shares]
    cols = [c for c in cols if float(c.abs().max()) > 0]
    if not cols:
        return torch.ones(0, dtype=torch.float64)
    return torch.linalg.lstsq(torch.stack(cols, dim=1), g).solution[:, 0]


def first_step_err(step: torch.Tensor, grad_ref: torch.Tensor) -> float:
    """How far the program's first step went against the reference's
    gradient: 1 - sum_j g_j^2 s_j / sum_j g_j^2, s_j +1 where element j
    moved down the reference's gradient, -1 where it moved up, 0 where it
    did not move.  Adam's first step moves each element by lr sign(g);
    rounding flips the sign of the elements whose gradient is small, which
    the weight g^2 counts little.  A delta left unmoved reads 1, a step down
    another gradient about 1."""
    g = grad_ref.double().cpu().reshape(-1)
    s = -torch.sign(step.double().cpu().reshape(-1))
    if s.numel() != g.numel():
        return math.inf
    return 1.0 - float((g * g.abs() * s).sum() / (g * g).sum())


def error(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over every element."""
    a, b = a.double().cpu().reshape(-1), b.double().cpu().reshape(-1)
    if a.numel() != b.numel():
        return math.inf
    nb = float(torch.linalg.vector_norm(b))
    d = float(torch.linalg.vector_norm(a - b))
    return d / nb if nb > 0 else (0.0 if d == 0 else math.inf)


def logit_gap(probs: torch.Tensor, logits: torch.Tensor) -> float:
    """The relative error of the program's logits, read back from its
    probabilities (log p is the logits less a constant a clip): ||a - b|| /
    ||b|| over every clip and class, a and b the program's log p and the
    reference's logits, each centred over a clip's classes (those whose
    probability the program did not round to 0)."""
    p = torch.as_tensor(probs).double().cpu()
    z = logits.double().cpu()
    if p.numel() != z.numel():
        return math.inf  # the program answered for other clips than it was given
    p = p.reshape(z.shape)
    keep = p > 1e-30
    a = torch.where(keep, torch.log(p.clamp_min(1e-300)), 0.0)
    z = torch.where(keep, z, 0.0)
    count = keep.sum(-1, keepdim=True)
    a = torch.where(keep, a - a.sum(-1, keepdim=True) / count, 0.0)
    b = torch.where(keep, z - z.sum(-1, keepdim=True) / count, 0.0)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def worst(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def joint_logit_gaps(logits: Dict[str, List]) -> Dict[str, float]:
    """A sweep's logit gaps over all its slots at once: ``logit_gap`` the
    worst checked step's (each slot's probabilities at that step against
    the reference's logits), ``clean_logit_gap`` the clean clips'.
    `logits` holds, a slot each, "program" (its steps' probabilities, or
    None) and "reference" (its steps' logits), and "clean_program" /
    "clean_reference" where the sweep gives clean probabilities."""
    out = {}
    if logits["program"] and all(p is not None for p in logits["program"]):
        steps = min(len(p) for p in logits["program"])
        out["logit_gap"] = max(
            logit_gap(torch.cat([torch.as_tensor(p[s]).reshape(1, -1) for p in logits["program"]]),
                      torch.cat([z[s].reshape(1, -1).cpu() for z in logits["reference"]]))
            for s in range(steps))
    if logits.get("clean_program"):
        out["clean_logit_gap"] = logit_gap(
            torch.cat([torch.as_tensor(p).reshape(1, -1) for p in logits["clean_program"]]),
            torch.cat([z.reshape(1, -1).cpu() for z in logits["clean_reference"]]))
    return out


def slots_numbers(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """A sweep's numbers over its slots: the worst and the median slot's
    change (its error and the gap of its norm), loss and probability gaps."""
    out = {}
    for k in ("first_step_err", "change_err", "change_gap", "loss_gap", "prob_gap"):
        if k in rows[0]:
            out[f"{k}_worst"] = max(r[k] for r in rows)
            out[f"{k}_median"] = statistics.median(r[k] for r in rows)
    return out


def limits(cell: str) -> Dict[str, float]:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    """Every limited number is there, finite and within its limit."""
    return all(math.isfinite(numbers.get(k, math.inf)) and numbers[k] <= lim[k] for k in lim)


def report(numbers: Dict[str, float], lim: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The numbers beside their limits, as the result line carries them; a
    number that is missing or not finite shows as null (JSON has no inf)."""
    def shown(v):
        return v if v is not None and math.isfinite(v) else None

    return {k: {"value": shown(numbers.get(k)), "limit": lim[k]} for k in lim}
