"""Attack loops: single-video, epoch (class-gen) and step-driven (universal).

Port of the JAX package's ``engine/loops.py``.  Host-side orchestration
around the attack step: the clip stays on the device through a step, and
metrics stay tensors.  The batched loop reads them to Python floats only on
a `log_every` step, so the host does not wait for the device on the steps
between; the single-video loop must know after every step whether the clip
is fooled, and reads that step's scalars in one transfer.

Loop semantics: the single-video attack stops at `step > max_step and
fooled` (it never stops early and runs past max_step until it fools;
``stop_rule="early"`` offers first-success stopping, `hard_cap` bounds the
never-fooled case); the universal attack is step-driven with periodic eval
and checkpoints (the tf.estimator cadence of the reference); class-gen takes
an epoch as one pass over the train shards and evaluates and checkpoints at
epoch ends.

Over ranks (an engine with a mesh, ``parallel/mesh.py``): each rank reads its
own shards, so its streams end at their own times.  The batched loop asks
every rank, before each step, whether it still has a batch (a host
collective), and an epoch ends when any rank's stream ends, so that no rank
waits in the step's collective for a batch that will not come; the fooling
eval sums the ranks' counts once, at its end, since their validation streams
give different numbers of batches.  Checkpoints and scalars are rank 0's
(the runners give the other ranks no writer and a checkpointer that does not
save).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data.video_dataset import PrefetchIterator
from ..parallel import mesh as mesh_lib
from .attack_step import AttackEngine, AttackState, RuntimeFlags

LOGGED = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
          "laplacian_norm_reg", "thickness", "roughness")
WRITTEN = LOGGED + ("prob_to_min", "prob_to_max")  # what the scalar writer gets
# spans a torch.profiler trace of a loop shows: one per optimizer step (the
# host's side of it) and one per pass over the validation stream
STEP_SPAN, EVAL_SPAN = "attack_loop/train_step", "attack_loop/eval"


def flags_from_config(attack_cfg, learning_rate: Optional[float] = None) -> RuntimeFlags:
    """RuntimeFlags from a run_config.yml attack section.

    beta3 := BETA_2, matching the reference scripts' wiring."""
    return RuntimeFlags(
        adv_flag=1.0,
        cyclic_flag=float(attack_cfg.get("CYCLIC_ATTACK", False)),
        cyclic_pert_flag=float(attack_cfg.get("CYCLIC_PERTURBATION_ATTACK", False)),
        beta0=float(attack_cfg.get("LAMBDA", 1.0)),
        beta1=float(attack_cfg.get("BETA_1", 0.5)),
        beta2=float(attack_cfg.get("BETA_2", 0.5)),
        beta3=float(attack_cfg.get("BETA_2", 0.5)),
        learning_rate=float(
            learning_rate
            if learning_rate is not None
            else attack_cfg.get("LEARNING_RATE", 1e-3)
        ),
    )


def evaluate_fooling(
    engine: AttackEngine,
    delta: torch.Tensor,
    batches: Iterable[Dict[str, np.ndarray]],
    flags: RuntimeFlags,
    seed: int = 0,
) -> Dict[str, float]:
    """Fooling rate over a validation stream with exclude-misclassified
    accounting: miss_rate = sum(miss)/sum(valid).  `seed` draws the cyclic
    rolls of the eval steps.  With a mesh, `batches` is the rank's stream and
    the counts are summed over the ranks once, at the end."""
    miss = torch.zeros((), dtype=torch.int64, device=engine.device)
    valid = torch.zeros_like(miss)
    n_batches = 0
    for batch in batches:
        out = engine.eval_step(delta, batch, flags, seed)
        miss += out["miss"]
        valid += out["valid"]
        n_batches += 1
    if engine.mesh is not None:
        miss, valid, n_batches = mesh_lib.all_reduce(engine.mesh, torch.stack(
            [miss, valid, torch.full_like(miss, n_batches)])).tolist()
    miss, valid = int(miss), int(valid)
    return {
        "miss_rate": miss / max(valid, 1),
        "total_valid_videos": valid,
        "batches": n_batches,
    }


class StepTimer:
    """steps/sec tracker over the intervals between ticks."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.first = 0.0  # the first interval
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            if self.count == 0:
                self.first = now - self._last
            self.total += now - self._last
            self.count += 1
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        return self.count / self.total if self.total else 0.0

    @property
    def steps_per_sec_after_first(self) -> float:
        """steps/sec without the first interval: on CUDA the first step of a
        batch shape also captures its graph (engine/step_graph.py)."""
        rest = self.total - self.first
        return (self.count - 1) / rest if self.count > 1 and rest > 0 else 0.0


SINGLE_VIDEO_SCALARS = WRITTEN + ("is_adversarial",)


def single_video_attack(
    engine: AttackEngine,
    clip: np.ndarray,
    label: int,
    flags: RuntimeFlags,
    *,
    target_label: Optional[int] = None,
    max_step: int = 2500,
    stop_rule: str = "reference",
    hard_cap: Optional[int] = None,
    track_history: bool = True,
    seed: int = 0,
    init_generator: Optional[torch.Generator] = None,
    log_fn: Optional[Callable[[int, Dict], None]] = None,
) -> Optional[Dict[str, Any]]:
    """Attack one clip until fooled.

    `label` is the TRUE class (the clean-prediction skip check uses it); for
    targeted attacks `target_label` is the class the attack drives toward and
    is what the loss and the stop rule see.  Returns None when the clean model
    misclassifies the clip, else a result dict in the reference's schema,
    holding numpy arrays and Python scalars only.

    `seed` draws the cyclic rolls (with the step count, on the device;
    ``AttackEngine.train_step``), as the JAX loop's ``fold_in(key(seed),
    step)``.  `init_generator` draws a mean/std spec's initial delta,
    U(-init_scale, init_scale) (seeded 0 when None), as the JAX loop's
    ``init_key``.
    """
    attack_label = label if target_label is None else target_label
    video = np.asarray(clip if clip.ndim == 5 else clip[None])
    batch = {
        "video": torch.as_tensor(video, device=engine.device),
        "labels": torch.as_tensor(np.asarray([attack_label], np.int64), device=engine.device),
    }
    state = engine.init_state(init_generator)
    clean_probs = engine.forward(state.delta, batch, flags, adversarial=False,
                                 seed=seed).cpu().numpy()
    if int(clean_probs.argmax()) != label:
        return None

    hist: Dict[str, List] = {k: [] for k in WRITTEN + ("perturbation", "softmax")}
    timer = StepTimer()
    step = 0
    fooled = False
    cap = hard_cap if hard_cap is not None else max_step * 40
    while True:
        timer.tick()
        state, metrics = engine.train_step(state, batch, flags, seed)
        # the step's scalars in one read of the device
        values = dict(zip(
            SINGLE_VIDEO_SCALARS,
            torch.stack([metrics[k].float() for k in SINGLE_VIDEO_SCALARS]).tolist(),
        ))
        fooled = bool(values["is_adversarial"])
        if track_history:
            for k in WRITTEN:
                percent = k in ("thickness", "roughness")  # of the [-1, 1] range
                hist[k].append(values[k] / 2.0 * 100 if percent else values[k])
            hist["perturbation"].append(state.delta.cpu().numpy())
            if "probs" in metrics:
                hist["softmax"].append(metrics["probs"].cpu().numpy())
        if log_fn is not None:
            log_fn(step, metrics)
        done_reference = step > max_step and fooled
        done_early = stop_rule == "early" and fooled
        if done_reference or done_early or step >= cap:
            break
        step += 1

    return {
        "correct_cls_id": label,
        "correct_cls_prob": float(clean_probs.max()),
        "softmax_init": clean_probs,
        "rgb_sample": video,
        "total_loss_l": hist["total_loss"],
        "adv_loss_l": hist["adv_loss"],
        "reg_loss_l": hist["reg_loss"],
        "norm_reg_loss_l": hist["norm_reg"],
        "diff_norm_reg_loss_l": hist["diff_norm_reg"],
        "perturbation": hist["perturbation"],
        "adv_video": engine.adversarial_video(state.delta, batch, flags).cpu().numpy(),
        "softmax": hist["softmax"],
        "total_steps": step,
        "beta_0": float(flags.beta0),
        "beta_1": float(flags.beta1),
        "beta_2": float(flags.beta2),
        "beta_3": float(flags.beta3),
        "fatness": hist["thickness"],
        "smoothness": hist["roughness"],
        "is_adversarial": fooled,
        "final_delta": state.delta.cpu().numpy(),
        "steps_per_sec": timer.steps_per_sec,
    }


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Move a host batch: through pinned memory and a non-blocking copy on
    CUDA, so that the copy overlaps the step that is running.  A tensor the
    pipeline already filled in pinned memory (``tfrecord_batches(pin_memory=True)``)
    is copied from where it lies."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out[k] = t
    return out


def batched_attack_loop(
    engine: AttackEngine,
    train_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
    val_batches_fn: Callable[[], Iterable[Dict[str, np.ndarray]]],
    flags: RuntimeFlags,
    *,
    max_steps: int,
    state: Optional[AttackState] = None,
    eval_every_epochs: int = 1,
    eval_every_steps: Optional[int] = None,
    checkpointer=None,
    checkpoint_every: Optional[int] = None,
    writer=None,
    log_every: int = 50,
    targeted_label: Optional[int] = None,
    seed: int = 0,
    start_step: int = 0,
) -> Dict[str, Any]:
    """Shared engine for class-gen (epoch cadence) and universal (step cadence).

    - checkpoint_every=None -> checkpoint at epoch ends (class-gen mode);
      an int -> every N steps (estimator mode).
    - eval_every_steps: an int evaluates every N optimizer steps and
      SUPERSEDES the epoch-boundary cadence (epoch-end evals are skipped so
      eval cost stays bounded).  None -> epoch-boundary eval only
      (eval_every_epochs).
    - writer: viz.tensorboard.ScalarWriter or None.
    - seed: draws the cyclic rolls of the train and eval steps.
    """
    if state is None:
        state = engine.init_state()
    timer = StepTimer()
    step = start_step
    history: Dict[str, List] = {k: [] for k in LOGGED}
    history.update(fool_rate=[], fool_rate_steps=[], perturbation=[])

    def run_eval():
        with record_function(EVAL_SPAN):
            ev = evaluate_fooling(engine, state.delta, val_batches_fn(), flags, seed)
        history["fool_rate"].append(ev["miss_rate"])
        history["fool_rate_steps"].append(step)
        if writer is not None:
            writer.scalar("Eval/fooling_ratio", ev["miss_rate"], step)
        return ev

    def produce():
        """Parse + pack + move to the device on the producer thread, so the
        host pipeline overlaps the device's steps (on the engine's card: the
        thread's current card is its own)."""
        if engine.device.type == "cuda" and engine.device.index is not None:
            torch.cuda.set_device(engine.device)
        for batch in train_batches_fn():
            if targeted_label is not None:
                batch = {**batch, "labels": np.full_like(batch["labels"], targeted_label)}
            yield _to_device(batch, engine.device)

    run_eval()
    epoch = 0
    while step < max_steps:
        epoch += 1
        batches_this_epoch = 0
        batches = PrefetchIterator(produce(), depth=2)
        try:
            while True:
                batch_on_device = next(batches, None)
                # an epoch ends when any rank's stream ends
                if not mesh_lib.all_ranks(engine.mesh, batch_on_device is not None):
                    break
                batches_this_epoch += 1
                if step >= max_steps:
                    break
                timer.tick()
                with record_function(STEP_SPAN):
                    state, metrics = engine.train_step(state, batch_on_device, flags, seed)
                step += 1
                if step % log_every == 0 or step == 1:
                    # the step's one read of the device
                    values = torch.stack([metrics[k].float() for k in WRITTEN]).tolist()
                    m = dict(zip(WRITTEN, values))
                    for k in LOGGED:
                        history[k].append(m[k])
                    if writer is not None:
                        writer.attack_step_scalars(m, step)
                if checkpointer is not None and checkpoint_every and step % checkpoint_every == 0:
                    checkpointer.save(state)
                if eval_every_steps and step % eval_every_steps == 0:
                    run_eval()
                    history["perturbation"].append(state.delta.cpu().numpy())
        finally:
            batches.close()
        if batches_this_epoch == 0:
            # an empty pipeline would otherwise spin this while-loop forever
            raise RuntimeError(
                "train pipeline yielded no batches (no shards found / all "
                "records filtered) — check TF_RECORDS_*_PATH (*.tfrecords)"
            )
        if eval_every_steps is None and epoch % eval_every_epochs == 0:
            run_eval()
            history["perturbation"].append(state.delta.cpu().numpy())
        if (
            epoch % eval_every_epochs == 0
            and checkpointer is not None
            and not checkpoint_every
        ):
            checkpointer.save(state)

    final_eval = run_eval()
    if checkpointer is not None:
        checkpointer.save(state)
    return {
        "state": state,
        "history": history,
        "final_eval": final_eval,
        "steps": step,
        "steps_per_sec": timer.steps_per_sec,
        "steps_per_sec_after_first": timer.steps_per_sec_after_first,
    }
