"""Epoch-cadenced universal attack of the torch world: the reference's
``fit`` / ``train_an_epoch`` around the attack step.

Port of the JAX package's ``engine/epoch_fit.py``.  Per epoch a train phase
(optimizer steps; with ``track_probs`` each is ``train_eval_step``, the step
and its batch's fooling counters in one program) and a valid phase (eval
only), each counting exclude-misclassified fooling; the epoch's result dict
has the JAX package's keys ('train/time', 'train/loss',
'train/fooling_ratio', 'train/pert_thickness', 'train/pert_roughness',
'train/inf_norm', 'train/perturbation', 'train/steps_per_sec', and the same
for 'valid/...'), appended to a running list saved as
'{model_name}_{epoch:03d}.npy'.  The counters and losses stay on the device
until a phase ends.

LR schedule: step decay (gamma, step_size = ceil(2/3 epochs) by default) or
the one-cycle policy, fed through the runtime learning-rate flag.  Resume:
delta and the epoch from the newest result's 'valid/perturbation'.
"""

from __future__ import annotations

import glob
import math
import os
import re
from dataclasses import replace
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..data.video_dataset import PrefetchIterator
from .attack_step import AttackEngine, AttackState, RuntimeFlags
from .loops import StepTimer, _to_device


def find_resume(model_dir: str, model_name: str):
    """(delta, last_epoch) from the newest epoch result, else (None, 0)."""
    best, best_epoch = None, 0
    for p in glob.glob(os.path.join(model_dir, f"{model_name}_*.npy")):
        m = re.search(r"_(\d+)\.npy$", p)
        if m and int(m.group(1)) >= best_epoch:
            best_epoch, best = int(m.group(1)), p
    if best is None:
        return None, 0
    results = np.load(best, allow_pickle=True).tolist()
    if not results:
        return None, 0
    return np.asarray(results[-1]["valid/perturbation"]), best_epoch


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float = 0.1) -> float:
    return base_lr * (gamma ** ((epoch - 1) // max(step_size, 1)))


def one_cycle_lr(
    max_lr: float,
    epoch: int,
    total_epochs: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> float:
    """LR of 1-indexed `epoch` under the reference's one-cycle policy:
    ``torch.optim.lr_scheduler.OneCycleLR`` with total_steps = epochs, cosine
    annealing and torch's default factors, stepped once an epoch (a cosine
    warm-up from max_lr/div_factor to max_lr over the first pct_start, then
    a cosine anneal to max_lr/(div_factor*final_div_factor)).  Only delta
    trains, so the policy's momentum half is inert (Adam's betas stay)."""
    step_num = epoch - 1  # the scheduler's value during epoch e is its step e-1
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor

    def cos_anneal(start: float, end: float, pct: float) -> float:
        return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))

    up_steps = pct_start * total_epochs - 1
    if up_steps <= 0:
        return max_lr if step_num == 0 else cos_anneal(
            max_lr, min_lr, step_num / max(total_epochs - 1, 1))
    if step_num <= up_steps:
        return cos_anneal(initial_lr, max_lr, step_num / up_steps)
    down_steps = (total_epochs - 1) - up_steps
    return cos_anneal(max_lr, min_lr, (step_num - up_steps) / max(down_steps, 1e-9))


def fit_universal_epochs(
    engine: AttackEngine,
    train_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
    valid_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
    flags: RuntimeFlags,
    *,
    epochs: int,
    lr: float,
    model_dir: str,
    model_name: str,
    lr_step_size: Optional[int] = None,
    lr_gamma: float = 0.1,
    use_one_cycle_policy: bool = False,
    warmup_pct: float = 0.3,
    start_epoch: int = 1,
    state: Optional[AttackState] = None,
    save: bool = True,
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Epochs `start_epoch`..`epochs`; returns this call's epoch results
    (the file of an epoch holds those of this call up to it).  `seed`: the
    initial delta's generator when no `state` is given, and the cyclic
    rolls' seed."""
    if lr_step_size is None:
        lr_step_size = int(math.ceil(2 / 3 * epochs))
    os.makedirs(model_dir, exist_ok=True)
    if state is None:
        state = engine.init_state(torch.Generator().manual_seed(seed))
    results: List[Dict[str, Any]] = []

    for epoch in range(start_epoch, epochs + 1):
        if use_one_cycle_policy:
            epoch_lr = one_cycle_lr(lr, epoch, epochs, pct_start=warmup_pct)
        else:
            epoch_lr = step_lr(lr, epoch, lr_step_size, lr_gamma)
        epoch_flags = replace(flags, learning_rate=epoch_lr)
        result: Dict[str, Any] = {}
        for phase in ("train", "valid"):
            timer = StepTimer()
            miss = torch.zeros((), dtype=torch.int64, device=engine.device)
            valid = torch.zeros_like(miss)
            losses = []
            batches = train_batches_fn() if phase == "train" else valid_batches_fn()

            def produce(batches=batches):
                # decode and the move to the device on the producer thread
                for b in batches:
                    yield _to_device({k: v for k, v in b.items() if k != "paths"}, engine.device)

            for batch in PrefetchIterator(produce(), depth=2):
                timer.tick()
                if phase == "train" and engine.track_probs:
                    state, metrics = engine.train_eval_step(state, batch, epoch_flags, seed)
                    losses.append(metrics["total_loss"])
                    miss += metrics["miss"]
                    valid += metrics["valid"]
                else:
                    if phase == "train":
                        state, metrics = engine.train_step(state, batch, epoch_flags, seed)
                        losses.append(metrics["total_loss"])
                    ev = engine.eval_step(state.delta, batch, epoch_flags, seed)
                    miss += ev["miss"]
                    valid += ev["valid"]
            timer.tick()
            pert = engine.reg_delta(state.delta, epoch_flags).cpu().numpy()
            loss_values = torch.stack(losses).tolist() if losses else []
            result[f"{phase}/time"] = timer.total
            result[f"{phase}/loss"] = float(np.mean(loss_values)) if loss_values else 0.0
            result[f"{phase}/fooling_ratio"] = int(miss) / max(int(valid), 1)
            result[f"{phase}/pert_thickness"] = float(np.abs(pert).mean())
            result[f"{phase}/pert_roughness"] = float(
                np.abs(np.roll(pert, 1, axis=0) - pert).mean())
            result[f"{phase}/inf_norm"] = float(np.abs(pert).max())
            result[f"{phase}/perturbation"] = pert
            result[f"{phase}/steps_per_sec"] = timer.steps_per_sec
        results.append(result)
        print(
            f"epoch {epoch}: lr={epoch_lr:.2e} "
            f"train_fool={result['train/fooling_ratio']:.3f} "
            f"valid_fool={result['valid/fooling_ratio']:.3f} "
            f"thick={result['valid/pert_thickness']:.4f}"
        )
        if save:
            np.save(os.path.join(model_dir, f"{model_name}_{epoch:03d}.npy"), results)
    return results
