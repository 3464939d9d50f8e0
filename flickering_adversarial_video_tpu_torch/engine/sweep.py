"""Per-video attack sweep of the torch world: the reference's
``fit_many_videos`` / ``fit_single_video_attack`` around the attack step.

Port of the JAX package's ``engine/sweep.py``, with its semantics:

* the completion ledger: an existing result ``.npy`` whose ``is_adversarial``
  history holds True skips the video; ``None`` saved there marks one in
  progress;
* each video's delta is drawn again, U(-0.005, 0.005)
  (:func:`draw_init_delta`), with max_norm reset;
* the loop runs ``while step < n_iter or not fooled``; a step counter past
  n_iter escalates the L-inf budget (max_norm *= 1.3) and resets the
  counter, and the fourth escalation ends the video;
* the result dict's keys: 'loss/total', 'loss/adv_loss', 'loss/reg_loss',
  'perturbation/thickness', 'perturbation/roughness',
  'perturbation/inf_norm', 'perturbation', 'prob_clean_input', 'label',
  'is_adversarial', 'final_max_norm', 'escalations', 'steps_per_sec'.

The escalating max_norm is the runtime flag ``RuntimeFlags.max_norm``, one
value of the engine's static scalar buffer: an escalation rewrites a device
value, and the step's graph is neither captured again nor reads the host.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .attack_step import AttackEngine, RuntimeFlags
from .loops import StepTimer

HISTORY = ("loss/total", "loss/adv_loss", "loss/reg_loss", "perturbation/thickness",
           "perturbation/roughness")
# the step metrics the history reads, in HISTORY's order, and the stop flag
_READ = ("total_loss", "adv_loss", "reg_loss", "thickness", "roughness", "is_adversarial")


def result_path_for(model_dir: str, video_path: str, class_name: str) -> str:
    """'{vid_name}_@{class_name}.npy'."""
    vid_name = os.path.basename(str(video_path))
    return os.path.join(model_dir, f"{vid_name}_@{class_name.replace(' ', '_')}.npy")


def should_skip(dest_path: str) -> bool:
    if not os.path.exists(dest_path):
        return False
    res = np.load(dest_path, allow_pickle=True)
    res = res.tolist() if hasattr(res, "tolist") else res
    if res is None:
        return False
    return bool(np.asarray(res.get("is_adversarial", [False])).any())


def draw_init_delta(shape: Tuple[int, ...], seed: int, init_scale: float) -> torch.Tensor:
    """A video's initial delta, U(-init_scale, init_scale), from a torch
    generator seeded with the video's seed (the JAX package draws it with
    threefry from ``fold_in(key(seed), 1)``; the streams differ)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * init_scale


def fit_single_video(
    engine: AttackEngine,
    batch: Dict[str, np.ndarray],
    flags: RuntimeFlags,
    *,
    n_iter: int = 3000,
    max_norm: float = 0.2,
    escalation: float = 1.3,
    max_chances: int = 4,
    seed: int = 0,
    init_scale: float = 0.005,
    track_history: bool = True,
) -> Optional[Dict[str, Any]]:
    """Attack one clip in the mean/std world.  Returns None when the clean
    model misclassifies it.  A targeted attack optimizes toward the
    config's ``target_class`` (fed through the labels); the clean skip
    checks the true label."""
    label = int(np.asarray(batch["labels"])[0])
    attack_labels = np.asarray(batch["labels"])
    if engine.config.targeted and engine.config.target_class is not None:
        attack_labels = np.full_like(attack_labels, engine.config.target_class)
    device_batch = {
        "video": torch.as_tensor(np.asarray(batch["video"]), device=engine.device),
        "labels": torch.as_tensor(attack_labels, device=engine.device).long(),
    }
    state = engine.init_state(torch.Generator().manual_seed(seed))
    clean_probs = engine.forward(state.delta, device_batch, flags, adversarial=False,
                                 seed=seed).cpu().numpy()
    if int(clean_probs.argmax()) != label:
        return None

    delta = draw_init_delta(tuple(state.delta.shape), seed, init_scale).to(engine.device)
    state = replace(state, delta=delta)

    dyn_max_norm = max_norm
    hist: Dict[str, list] = {k: [] for k in HISTORY + ("perturbation", "is_adversarial")}
    timer = StepTimer()
    step = 0
    chances = 0
    fooled = False
    while step < n_iter or not fooled:
        if step > n_iter:
            chances += 1
            dyn_max_norm *= escalation
            step = 0
        if chances == max_chances:
            break
        timer.tick()
        state, metrics = engine.train_step(state, device_batch,
                                           replace(flags, max_norm=dyn_max_norm), seed)
        # the step's scalars in one read of the device
        values = torch.stack([metrics[k].float() for k in _READ]).tolist()
        fooled = bool(values[-1])
        if track_history:
            for k, v in zip(HISTORY, values):
                hist[k].append(v)
            hist["perturbation"].append(
                np.clip(state.delta.cpu().numpy(), -dyn_max_norm, dyn_max_norm))
            hist["is_adversarial"].append(fooled)
        step += 1

    final_pert = np.clip(state.delta.cpu().numpy(), -dyn_max_norm, dyn_max_norm)
    result = {
        **hist,
        "perturbation/inf_norm": float(np.abs(final_pert).max()),
        "prob_clean_input": clean_probs,
        "label": np.asarray(batch["labels"]),
        "final_max_norm": dyn_max_norm,
        "escalations": chances,
        "steps_per_sec": timer.steps_per_sec,
    }
    if not track_history:
        result["is_adversarial"] = [fooled]
        result["perturbation"] = [final_pert]
    return result


def fit_many_videos(
    engine: AttackEngine,
    batches: Iterable[Dict[str, np.ndarray]],
    flags: RuntimeFlags,
    *,
    model_dir: str,
    label_names,
    n_iter: int = 3000,
    max_norm: float = 0.2,
    save: bool = True,
    max_videos: Optional[int] = None,
) -> Dict[str, Any]:
    """The per-video attack over a stream of batches of one clip, video
    `i` with seed `i`."""
    os.makedirs(model_dir, exist_ok=True)
    done = skipped_exist = skipped_misclassified = 0
    results = []
    for vid_num, batch in enumerate(batches):
        if max_videos is not None and vid_num >= max_videos:
            break
        label = int(np.asarray(batch["labels"])[0])
        path = batch.get("paths", [f"video{vid_num}"])[0]
        dest = result_path_for(model_dir, path, label_names[label])
        if should_skip(dest):
            skipped_exist += 1
            continue
        if save:
            np.save(dest, None)  # the in-progress placeholder
        res = fit_single_video(engine, batch, flags, n_iter=n_iter, max_norm=max_norm,
                               seed=vid_num)
        if res is None:
            skipped_misclassified += 1
            continue
        if save:
            np.save(dest, res)
        results.append((dest, bool(np.asarray(res["is_adversarial"]).any())))
        done += 1
    return {
        "attacked": done,
        "skipped_existing": skipped_exist,
        "skipped_misclassified": skipped_misclassified,
        "results": results,
    }
