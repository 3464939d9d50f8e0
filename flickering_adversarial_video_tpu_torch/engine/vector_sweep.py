"""Vectorized per-video attack sweep: N independent single-video attacks in
flight as one batched program, refilled from the queue of videos at chunk
boundaries.

Port of the JAX package's ``engine/vector_sweep.py`` (``SlotState`` :44,
``VectorSweepEngine`` :56, ``vector_single_video_attacks`` :298,
``vector_fit_many_videos`` :478).  Each slot carries its own delta, Adam
moments and count, stop-rule step, escalations and max_norm; the N clips are
one batch of N through the victim (``AttackEngine._slot_step``: per-slot
loss terms, the gradient of their sum, a per-slot Adam; the victim's BN is
frozen, so the clips do not meet).  Every iteration first runs the stop
rule's bookkeeping as masked tensor arithmetic, in each family's sequential
order (the JAX sweep's ``_chunk_impl``, :238-270):

* ``escalate`` (the torch world's per-video sweep, ``engine/sweep.py``): exit
  when step >= n_iter and fooled; past n_iter stuck steps escalate max_norm
  (x escalation) and reset the step to 0; the max_chances-th escalation ends
  the video;
* ``reference`` (the TF single-video attack, ``loops.single_video_attack``):
  after the executed step k, exit when k > n_iter and fooled, or k >= the
  hard cap (40 n_iter by default);
* ``early``: the first fooling exits (same cap).

Then one step runs on every slot and the finished ones keep their state
(``torch.where``) until the host refills them.  Two counters stay apart: the
Adam count, which never resets (and draws the cyclic rolls, count + 1, as the
sequential step does), and the stop rule's step, which an escalation resets.

On CUDA an iteration is one CUDA graph replayed ``chunk`` times a chunk
(``engine/step_graph.SlotGraph``), its outputs written into ``[chunk, N,
...]`` device buffers read once a chunk; on the CPU the same iteration runs
eagerly.  The state and the slot inputs are the graph's static tensors:
refills and parks write into them in place, and ``run_chunk`` donates the
state handed to it (clone what you keep).  The per-slot trajectories are the
sequential sweep's, up to the batched forward's float reassociation.

Over ranks (``mesh=``, the JAX sweep's slot axis sharded over its device
mesh, :94-117): `slots` must be a multiple of the mesh's W, and each rank
runs slots / W of them over its own share of the videos, with no collective
(a slot touches only its own clip and delta).  The caller deals the videos:
rank r gets videos r, r + W, r + 2W, ... of the whole list, and video j of
its share keeps the seed of its place in the whole list (r + W j), so its
initial draw and result do not depend on W.

A torch.profiler trace of a call shows the host's side of it in spans
(``SPANS``): the call, and inside it, one after another, each clean check
(``candidate``), each slot filled or parked (``refill``), each chunk's
replays and its capture (``chunk``), the chunk's read of its outputs
(``read``), the per-slot history of its rows (``history``) and each
finished slot's result (``result``).  No span is opened inside the captured
iteration or a per-slot loop, and none reads the device.  Host counts of the
same work (``sweep_counts``, ``COUNTS``) add up over the process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import deque
from functools import partial
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..attack import perturbation as pert_lib
from . import sweep as sweep_lib
from .attack_step import AttackEngine, RuntimeFlags
from .step_graph import SlotGraph

STOP_RULES = ("escalate", "reference", "early")
# what a chunk's delta history may hold on the device (delta_post: chunk x N
# x |delta| f32; 54 MB a slot-step for a sparse delta of 90x224x224x3)
HISTORY_BYTES = 8 << 30
# the slot step's per-slot metrics a chunk records
_METRICS = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
            "laplacian_norm_reg", "prob_to_min", "prob_to_max", "thickness", "roughness",
            "is_adversarial", "probs")
# spans a torch.profiler trace of a sweep call shows (the host's side; a
# span's device work is what it enqueues)
SPANS = ("vector_sweep/call", "vector_sweep/candidate", "vector_sweep/refill",
         "vector_sweep/chunk", "vector_sweep/read", "vector_sweep/history", "vector_sweep/result")
(CALL_SPAN, CANDIDATE_SPAN, REFILL_SPAN, CHUNK_SPAN, READ_SPAN, HISTORY_SPAN,
 RESULT_SPAN) = SPANS
# the sweep's host counts: calls; chunks; iterations (graph replays or eager
# iterations); slot_iterations (iterations x this rank's slots) and the live
# slots' share of them; slots refilled and parked; results
COUNTS = ("calls", "chunks", "iterations", "slot_iterations", "live_slot_iterations", "refills",
          "parks", "results")
_counts = dict.fromkeys(COUNTS, 0)


def sweep_counts() -> Dict[str, int]:
    return dict(_counts)


def reset_sweep_counts() -> None:
    _counts.update(dict.fromkeys(COUNTS, 0))


@dataclasses.dataclass
class SlotState:
    """Per-slot attack state, every tensor stacked over the N slots."""

    delta: torch.Tensor     # [N, *spec.shape] f32
    mu: torch.Tensor        # Adam's first moment
    nu: torch.Tensor        # Adam's second moment
    count: torch.Tensor     # [N] int32: Adam's count, never reset
    step: torch.Tensor      # [N] int32: the stop rule's, reset to 0 on escalation
    chances: torch.Tensor   # [N] int32: escalations used
    max_norm: torch.Tensor  # [N] f64: the slot's dynamic max_norm
    fooled: torch.Tensor    # [N] bool: the last executed step's is_adversarial
    done: torch.Tensor      # [N] bool: stop rule met (or chances spent), or parked

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


class VectorSweepEngine:
    """N-slot vectorized per-video attack over one frozen victim, with the
    engine's loss, metrics and optimizer, so the semantics are the
    sequential sweep's."""

    def __init__(
        self,
        engine: AttackEngine,
        slots: int,
        *,
        n_iter: int = 3000,
        escalation: float = 1.3,
        max_chances: int = 4,
        init_scale: float = 0.005,
        mesh=None,
        stop: str = "escalate",
        hard_cap: Optional[int] = None,
        record_delta: bool = True,
    ):
        if stop not in STOP_RULES:
            raise ValueError(f"unknown stop rule {stop!r}: choose from {STOP_RULES}")
        if slots < 1:
            raise ValueError(f"slots must be positive, got {slots}")
        world = 1 if mesh is None else mesh.world
        if slots % world:
            raise ValueError(f"slots ({slots}) must be a multiple of the mesh size ({world})")
        self.engine = engine
        self.slots = slots // world  # this rank's
        self.n_iter = n_iter
        self.escalation = escalation
        self.max_chances = max_chances
        self.init_scale = init_scale
        self.stop = stop
        self.hard_cap = hard_cap if hard_cap is not None else n_iter * 40
        self.record_delta = record_delta
        self._graph: Optional[SlotGraph] = None

    # ---------- state ----------

    def _fresh_delta(self, seed: int) -> torch.Tensor:
        """A new video's initial delta (on the CPU).  'escalate': the
        sequential sweep's draw, U(-init_scale, init_scale) from the video's
        seed (``sweep.draw_init_delta``, so the two sweeps can resume each
        other); 'reference' / 'early': the spec's own start, as
        ``loops.single_video_attack``'s (zeros for the flickering delta)."""
        spec = self.engine.spec
        if self.stop == "escalate":
            return sweep_lib.draw_init_delta(tuple(spec.shape), seed, self.init_scale)
        return pert_lib.init_delta(spec)

    def init_slots(self) -> SlotState:
        """N slots on the engine's device, all done (empty) until refilled."""
        n, dev = self.slots, self.engine.device
        delta = torch.zeros((n,) + tuple(self.engine.spec.shape), device=dev)
        zeros = partial(torch.zeros, n, device=dev)
        return SlotState(delta, torch.zeros_like(delta), torch.zeros_like(delta),
                         zeros(dtype=torch.int32), zeros(dtype=torch.int32),
                         zeros(dtype=torch.int32), zeros(dtype=torch.float64),
                         zeros(dtype=torch.bool), torch.ones(n, dtype=torch.bool, device=dev))

    def refill_slot(self, state: SlotState, i: int, seed: int, max_norm: float) -> SlotState:
        """Slot i started afresh for a new video, written in place."""
        state.delta[i].copy_(self._fresh_delta(seed))
        for t in (state.mu, state.nu, state.count, state.step, state.chances, state.fooled,
                  state.done):
            t[i] = 0
        state.max_norm[i] = max_norm
        _counts["refills"] += 1
        return state

    def park_slot(self, state: SlotState, i: int) -> SlotState:
        """Slot i marked done (the queue is empty): it keeps its state."""
        state.done[i] = True
        _counts["parks"] += 1
        return state

    def chunk_that_fits(self, chunk: int) -> int:
        """`chunk`, cut so that a chunk's delta history fits HISTORY_BYTES;
        raises when one iteration's does not."""
        if not self.record_delta:
            return chunk
        per_step = self.slots * int(np.prod(self.engine.spec.shape)) * 4
        fits = HISTORY_BYTES // per_step
        if fits < 1:
            raise ValueError(
                f"one iteration's delta history of {self.slots} slots takes {per_step} bytes, "
                f"more than the {HISTORY_BYTES} a chunk may hold: run fewer slots or turn off "
                "track_history")
        return min(chunk, fits)

    # ---------- one iteration, and the chunk ----------

    def _iterate(self, packed: bool, scalars: torch.Tensor, delta, mu, nu, count, step, chances,
                 max_norm, fooled, done, videos, labels, seeds) -> Dict[str, torch.Tensor]:
        """One iteration on the state's tensors, updated in place: the stop
        rule's bookkeeping, one slot step (inactive slots frozen), the
        iteration's outputs ([N, ...] each) returned.  `step` counts the
        executed steps; `fooled` is the last executed step's verdict."""
        if self.stop == "escalate":
            # the sequential sweep's order: the exit check (its while
            # condition), the escalation, the chances cap, then a step
            done_now = done | ((step >= self.n_iter) & fooled)
            escalate = (step > self.n_iter) & ~done_now
            chances_now = chances + escalate.to(chances.dtype)
            max_norm_now = torch.where(escalate, max_norm * self.escalation, max_norm)
            step_now = torch.where(escalate, torch.zeros_like(step), step)
            done_now = done_now | (chances_now >= self.max_chances)
        else:
            # single_video_attack breaks after the executed step k = step - 1
            k = step - 1
            fooled_exit = ((k > self.n_iter) & fooled) if self.stop == "reference" else fooled
            done_now = done | ((step > 0) & (fooled_exit | (k >= self.hard_cap)))
            chances_now, max_norm_now, step_now = chances, max_norm.clone(), step
        active = ~done_now
        (new_delta, new_mu, new_nu, new_count), m = self.engine._slot_step(
            delta, mu, nu, count, videos, packed, labels, scalars, max_norm_now.float(), seeds,
            active)
        new = (new_delta, new_mu, new_nu, new_count, torch.where(active, step_now + 1, step_now),
               chances_now, max_norm_now, torch.where(active, m["is_adversarial"], fooled),
               done_now)
        for dst, src in zip((delta, mu, nu, count, step, chances, max_norm, fooled, done), new):
            dst.copy_(src)
        ys = {k: m[k] for k in _METRICS if k in m}
        ys.update(active=active, max_norm=max_norm_now)
        if self.record_delta:
            ys["delta_post"] = new_delta
        return ys

    def run_chunk(self, state: SlotState, videos: torch.Tensor, labels: torch.Tensor,
                  seeds: torch.Tensor, flags: RuntimeFlags, chunk: int, packed: bool = False,
                  eager: bool = False) -> Tuple[SlotState, Dict[str, torch.Tensor]]:
        """`chunk` iterations on the slots' clips `videos` [N, ...] (as
        ``AttackEngine.prepare_batch`` gives them; `packed` says which),
        `labels` [N] and the rolls' `seeds` [N]: (the state, the iterations'
        outputs [chunk, N, ...]).  On CUDA one graph replay an iteration: the
        state handed in is donated (the returned one holds the graph's static
        tensors) and the outputs are views of the graph's buffers, which the
        next chunk overwrites.  `eager` runs the iterations eagerly in place
        (the CPU's way; on the card the reference the graph is held to)."""
        _counts["chunks"] += 1
        _counts["iterations"] += chunk
        _counts["slot_iterations"] += chunk * self.slots
        with record_function(CHUNK_SPAN):
            scalars = self.engine._step_scalars(flags, None)
            given = state.tensors() + (videos, labels, seeds)
            iterate = partial(self._iterate, packed, scalars)
            if eager or not self.engine.graphed:
                outs = [iterate(*given) for _ in range(chunk)]
                return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
            if self._graph is None:
                self._graph = SlotGraph(iterate, given, chunk)
            for static, t in zip(self._graph.static, given):
                if (t.shape, t.dtype) != (static.shape, static.dtype):
                    raise ValueError(f"slot tensor {tuple(t.shape)} {t.dtype} does not match "
                                     f"the graph's {tuple(static.shape)} {static.dtype}")
            ys = self._graph.run(given, chunk)
            return SlotState(*self._graph.static[:len(given) - 3]), ys

    def graph_stats(self) -> Dict[str, float]:
        """The slot graph's pool bytes and capture seconds; empty without one."""
        g = self._graph
        return {} if g is None else {"pool_bytes": g.pool_bytes, "capture_s": g.capture_s}


def _slot_inputs(engine: AttackEngine, slots: int, batch: Dict[str, torch.Tensor]):
    """The slots' static clip, label and seed tensors, shaped by one
    candidate's prepared batch, and whether the clips are packed."""
    video, packed, _ = engine.prepare_batch(batch)
    dev = engine.device
    return (torch.zeros((slots,) + tuple(video.shape[1:]), dtype=video.dtype, device=dev),
            torch.zeros(slots, dtype=torch.int64, device=dev),
            torch.zeros(slots, dtype=torch.int64, device=dev), packed)


def _place(engine: AttackEngine, inputs, i: int, batch: Dict[str, torch.Tensor], seed: int):
    """A candidate's prepared clip, label and seed into slot i."""
    videos, labels, seeds, packed = inputs
    video, p, lab = engine.prepare_batch(batch)
    if p != packed or tuple(video.shape[1:]) != tuple(videos.shape[1:]) or (
            video.dtype != videos.dtype):
        raise ValueError(f"every clip of a vectorized sweep has one shape and dtype: "
                         f"{tuple(video.shape[1:])} {video.dtype} against "
                         f"{tuple(videos.shape[1:])} {videos.dtype}")
    videos[i].copy_(video[0])
    labels[i].copy_(lab[0])
    seeds[i] = seed


def _global_index(mesh, j: int) -> int:
    """The place in the whole list of video j of this rank's share."""
    return j if mesh is None else mesh.rank + mesh.world * j


def _read_chunk(state: SlotState, ys: Dict[str, torch.Tensor]):
    """A chunk's outputs and the slots' done and fooled flags, on the host."""
    with record_function(READ_SPAN):
        host = {k: v.cpu().numpy() for k, v in ys.items()}
        done, fooled = state.done.cpu().numpy(), state.fooled.cpu().numpy()
    _counts["live_slot_iterations"] += int(host["active"].sum())
    return host, done, fooled


def _call(fn):
    """`fn`, a sweep, as one counted CALL_SPAN."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        _counts["calls"] += 1
        with record_function(CALL_SPAN):
            return fn(*args, **kwargs)
    return call


@_call
def vector_single_video_attacks(
    engine: AttackEngine,
    clips: List[np.ndarray],
    labels_true: List[int],
    flags: RuntimeFlags,
    *,
    slots: int = 4,
    chunk: int = 64,
    max_step: int = 2500,
    stop_rule: str = "reference",
    hard_cap: Optional[int] = None,
    target_label: Optional[int] = None,
    track_history: bool = True,
    mesh=None,
    seeds: Optional[List[int]] = None,
) -> List[Optional[Dict[str, Any]]]:
    """The TF world's single-video attacks, `slots` clips at once.

    Same semantics and result schema as ``loops.single_video_attack`` (the
    reference's res_dict), clip k with seed ``seeds[k]`` (default k, the
    sequential runner's; with a mesh, `clips` is this rank's share and the
    default its places in the whole list); one result a clip, None where the
    clean model misclassifies it."""
    dev = engine.device
    if seeds is None:
        seeds = [_global_index(mesh, k) for k in range(len(clips))]
    seeds = list(seeds)
    vse = VectorSweepEngine(engine, slots, n_iter=max_step, stop=stop_rule, hard_cap=hard_cap,
                            mesh=mesh, record_delta=track_history)
    chunk = vse.chunk_that_fits(chunk)
    out: List[Optional[Dict[str, Any]]] = [None] * len(clips)
    queue = deque(range(len(clips)))

    @record_function(CANDIDATE_SPAN)
    def next_candidate():
        while queue:
            k = queue.popleft()
            clip = np.asarray(clips[k])
            video = clip if clip.ndim == 5 else clip[None]
            attack = labels_true[k] if target_label is None else target_label
            batch = {"video": torch.as_tensor(video, device=dev),
                     "labels": torch.as_tensor(np.asarray([attack], np.int64), device=dev)}
            clean = engine.forward(None, batch, flags, adversarial=False,
                                   seed=seeds[k]).cpu().numpy()
            if int(clean.argmax()) == labels_true[k]:
                return k, video, batch, clean
        return None

    first = next_candidate()
    if first is None:
        return out
    state = vse.init_slots()
    inputs = _slot_inputs(engine, vse.slots, first[2])
    slot_meta: List[Optional[Dict[str, Any]]] = [None] * vse.slots

    @record_function(REFILL_SPAN)
    def fill(i, cand):
        if cand is None:
            vse.park_slot(state, i)
            return
        k, video, batch, clean = cand
        _place(engine, inputs, i, batch, seeds[k])
        hist = {key: [] for key in ("total_loss", "adv_loss", "reg_loss", "norm_reg",
                                    "diff_norm_reg", "thickness", "roughness", "perturbation",
                                    "softmax")}
        slot_meta[i] = {"k": k, "video": video, "batch": batch, "clean": clean, "hist": hist,
                        "t0": time.perf_counter(), "steps_run": 0}
        # max_norm is inert in the tanh world; the flags' value
        vse.refill_slot(state, i, seeds[k], float(flags.max_norm))

    fill(0, first)
    for i in range(1, vse.slots):
        fill(i, next_candidate())

    while any(m is not None for m in slot_meta):
        state, ys = vse.run_chunk(state, *inputs[:3], flags, chunk, packed=inputs[3])
        ys, done, fooled = _read_chunk(state, ys)
        with record_function(HISTORY_SPAN):
            for i, meta in enumerate(slot_meta):
                if meta is None:
                    continue
                ran = np.nonzero(ys["active"][:, i])[0]
                if track_history:
                    h = meta["hist"]
                    for t in ran:
                        for key in ("total_loss", "adv_loss", "reg_loss", "norm_reg",
                                    "diff_norm_reg"):
                            h[key].append(float(ys[key][t, i]))
                        # in percent of the [-1, 1] range
                        h["thickness"].append(float(ys["thickness"][t, i]) / 2.0 * 100)
                        h["roughness"].append(float(ys["roughness"][t, i]) / 2.0 * 100)
                        h["perturbation"].append(ys["delta_post"][t, i])
                        if "probs" in ys:
                            # [1, K], as a batch of one
                            h["softmax"].append(ys["probs"][t, i][None])
                meta["steps_run"] += len(ran)
        for i, meta in enumerate(slot_meta):
            if meta is None or not done[i]:
                continue
            with record_function(RESULT_SPAN):
                k, h = meta["k"], meta["hist"]
                delta = state.delta[i].cpu().numpy().copy()  # the state lives on: a copy
                dt = time.perf_counter() - meta["t0"]
                out[k] = {
                    "correct_cls_id": labels_true[k],
                    "correct_cls_prob": float(meta["clean"].max()),
                    "softmax_init": meta["clean"],
                    "rgb_sample": meta["video"],
                    "total_loss_l": h["total_loss"],
                    "adv_loss_l": h["adv_loss"],
                    "reg_loss_l": h["reg_loss"],
                    "norm_reg_loss_l": h["norm_reg"],
                    "diff_norm_reg_loss_l": h["diff_norm_reg"],
                    "perturbation": h["perturbation"],
                    "adv_video": engine.adversarial_video(
                        torch.as_tensor(delta), meta["batch"], flags).cpu().numpy(),
                    "softmax": h["softmax"],
                    # the sequential loop's `step` at its break: executed - 1
                    "total_steps": meta["steps_run"] - 1,
                    "beta_0": float(flags.beta0),
                    "beta_1": float(flags.beta1),
                    "beta_2": float(flags.beta2),
                    "beta_3": float(flags.beta3),
                    "fatness": h["thickness"],
                    "smoothness": h["roughness"],
                    "is_adversarial": bool(fooled[i]),
                    "final_delta": delta,
                    "steps_per_sec": meta["steps_run"] / dt if dt > 0 else 0.0,
                }
            _counts["results"] += 1
            slot_meta[i] = None
            fill(i, next_candidate())
    return out


@_call
def vector_fit_many_videos(
    engine: AttackEngine,
    batches: Iterable[Dict[str, np.ndarray]],
    flags: RuntimeFlags,
    *,
    model_dir: str,
    label_names,
    slots: int = 8,
    chunk: int = 64,
    n_iter: int = 3000,
    max_norm: float = 0.2,
    escalation: float = 1.3,
    max_chances: int = 4,
    init_scale: float = 0.005,
    save: bool = True,
    max_videos: Optional[int] = None,
    track_history: bool = True,
    mesh=None,
) -> Dict[str, Any]:
    """``sweep.fit_many_videos`` with `slots` videos in flight: the same
    ledger, skips, placeholder and result schema, video i with seed i (the
    sequential convention), so either sweep resumes the other.  With a mesh,
    `batches` is this rank's share, i its place in the whole stream, and
    `max_videos` counts the whole stream."""
    os.makedirs(model_dir, exist_ok=True)
    dev = engine.device
    vse = VectorSweepEngine(engine, slots, n_iter=n_iter, escalation=escalation,
                            max_chances=max_chances, init_scale=init_scale, mesh=mesh,
                            record_delta=track_history)
    chunk = vse.chunk_that_fits(chunk)
    stats = {"attacked": 0, "skipped_existing": 0, "skipped_misclassified": 0}
    results = []
    batch_iter = iter(batches)
    vid_counter = -1

    @record_function(CANDIDATE_SPAN)
    def next_candidate():
        """The next (seed, device batch, true labels, dest, clean probs) past
        the ledger and the clean check."""
        nonlocal vid_counter
        while True:
            if max_videos is not None and _global_index(mesh, vid_counter + 1) >= max_videos:
                return None
            batch = next(batch_iter, None)
            if batch is None:
                return None
            vid_counter += 1
            seed = _global_index(mesh, vid_counter)
            label = int(np.asarray(batch["labels"])[0])
            path = batch.get("paths", [f"video{seed}"])[0]
            dest = sweep_lib.result_path_for(model_dir, path, label_names[label])
            if sweep_lib.should_skip(dest):
                stats["skipped_existing"] += 1
                continue
            if save:
                np.save(dest, None)  # the in-progress placeholder, before the clean check
            attack_labels = np.asarray(batch["labels"])
            if engine.config.targeted and engine.config.target_class is not None:
                attack_labels = np.full_like(attack_labels, engine.config.target_class)
            device_batch = {
                "video": torch.as_tensor(np.asarray(batch["video"]), device=dev),
                "labels": torch.as_tensor(attack_labels, device=dev).long(),
            }
            clean = engine.forward(None, device_batch, flags, adversarial=False,
                                   seed=seed).cpu().numpy()
            if int(clean.argmax()) != label:
                stats["skipped_misclassified"] += 1
                continue
            return seed, device_batch, np.asarray(batch["labels"]), dest, clean

    first = next_candidate()
    if first is None:
        return {**stats, "results": results}
    state = vse.init_slots()
    inputs = _slot_inputs(engine, vse.slots, first[1])
    slot_meta: List[Optional[Dict[str, Any]]] = [None] * vse.slots

    @record_function(REFILL_SPAN)
    def fill(i, cand):
        if cand is None:
            vse.park_slot(state, i)
            return
        seed, device_batch, label, dest, clean = cand
        _place(engine, inputs, i, device_batch, seed)
        hist = {key: [] for key in sweep_lib.HISTORY + ("perturbation", "is_adversarial")}
        slot_meta[i] = {"dest": dest, "label": label, "clean": clean, "hist": hist,
                        "t0": time.perf_counter(), "steps_run": 0}
        vse.refill_slot(state, i, seed, max_norm)

    fill(0, first)
    for i in range(1, vse.slots):
        fill(i, next_candidate())

    # the history keys (sweep.HISTORY) and the slot metrics they read
    read = dict(zip(sweep_lib.HISTORY, ("total_loss", "adv_loss", "reg_loss", "thickness",
                                        "roughness")))
    while any(m is not None for m in slot_meta):
        state, ys = vse.run_chunk(state, *inputs[:3], flags, chunk, packed=inputs[3])
        ys, done, fooled = _read_chunk(state, ys)
        with record_function(HISTORY_SPAN):
            for i, meta in enumerate(slot_meta):
                if meta is None:
                    continue
                ran = np.nonzero(ys["active"][:, i])[0]
                if track_history:
                    h = meta["hist"]
                    for t in ran:
                        for key, src in read.items():
                            h[key].append(float(ys[src][t, i]))
                        mn = float(ys["max_norm"][t, i])
                        h["perturbation"].append(np.clip(ys["delta_post"][t, i], -mn, mn))
                        h["is_adversarial"].append(bool(ys["is_adversarial"][t, i]))
                meta["steps_run"] += len(ran)
        for i, meta in enumerate(slot_meta):
            if meta is None or not done[i]:
                continue
            with record_function(RESULT_SPAN):
                mn = float(state.max_norm[i])
                final_pert = np.clip(state.delta[i].cpu().numpy(), -mn, mn)
                dt = time.perf_counter() - meta["t0"]
                result = {
                    **meta["hist"],
                    "perturbation/inf_norm": float(np.abs(final_pert).max()),
                    "prob_clean_input": meta["clean"],
                    "label": meta["label"],
                    "final_max_norm": mn,
                    "escalations": int(state.chances[i]),
                    "steps_per_sec": meta["steps_run"] / dt if dt > 0 else 0.0,
                }
                if not track_history:
                    result["is_adversarial"] = [bool(fooled[i])]
                    result["perturbation"] = [final_pert]
                if save:
                    np.save(meta["dest"], result)
                # the ledger's verdict, as the sequential sweep's: any() over
                # the history (a clip fooled on the way counts)
                results.append((meta["dest"], bool(np.asarray(result["is_adversarial"]).any())))
            stats["attacked"] += 1
            _counts["results"] += 1
            slot_meta[i] = None
            fill(i, next_candidate())
    return {**stats, "results": results}
