"""The per-video mix: one whole call to the vectorized sweep the runners use.

``engine.vector_sweep.vector_single_video_attacks`` in the tanh world (the
single-video runner's path: ``stop_rule="reference"``, its ``hard_cap``) and
``engine.vector_sweep.vector_fit_many_videos`` in the mean/std world (the
``torch_per_video --slots`` path: escalation of max_norm, ``max_chances``),
each with ``track_history`` on, over one generation of ``slots`` distinct
seeded clips, so every slot is live from the first chunk.  Clips are made
on the card and handed over as the runners' readers give them: float32
[1,T,H,W,3] in [-1, 1] in the tanh world, uint8 [1,T,H,W,3] in the mean/std
world.  The labels are the victim's clean predictions, as a clip the clean
victim misclassifies is skipped.

The step budget is whole chunks: ``hard_cap = chunk*m - 2`` (each slot runs
hard_cap + 1 steps and the next iteration sees it done) or ``n_iter =
chunk/4*m - 2`` (four chances of n_iter + 1 steps, and the iteration that
ends the fourth), m = round(--seconds / ``chunk_seconds``), a data constant
measured on the H100 (so both sides of a comparison run the same work).
Set-up runs the same call once at one chunk: every shape, plan and kernel
the window uses is then warm.  The window is the second call, graph capture
and all; its clip-steps are the steps each slot ran while live.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import clips as clip_lib
from .. import program


@contextlib.contextmanager
def observed():
    """What the sweep does meanwhile, for want of a hook in the program:
    the SlotGraphs it captures (for their capture_s) and the host time at
    which each chunk starts."""
    from flickering_adversarial_video_tpu_torch.engine import vector_sweep

    seen = {"graphs": [], "chunk_starts": []}
    graph_cls, run_chunk = vector_sweep.SlotGraph, vector_sweep.VectorSweepEngine.run_chunk

    class Recorded(graph_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["graphs"].append(self)

    def timed(self, *a, **kw):
        seen["chunk_starts"].append(time.perf_counter())
        return run_chunk(self, *a, **kw)

    vector_sweep.SlotGraph, vector_sweep.VectorSweepEngine.run_chunk = Recorded, timed
    try:
        yield seen
    finally:
        vector_sweep.SlotGraph, vector_sweep.VectorSweepEngine.run_chunk = graph_cls, run_chunk


def _budget_iterations(world: str, chunk: int, m: int, chances: int = 1) -> Dict[str, int]:
    """The budget whose last iteration, the one that sees every slot done,
    ends chunk m."""
    if world == "tanh":
        return {"hard_cap": chunk * m - 2}
    return {"n_iter": (chunk * m - 1) // chances - 1}


class Sweep:
    """One configuration's sweep entry with its clips and labels."""

    def __init__(self, ctx, engine, flags, clips, labels):
        self.ctx, self.engine, self.flags = ctx, engine, flags
        self.clips, self.labels = clips, labels
        self.attack = ctx.traffic["attack"]
        self.world = ctx.cfg["world"]
        self.root = tempfile.mkdtemp(prefix="port_bench_sweep_")

    def call(self, m: int) -> List[Dict]:
        """One call with a budget of m chunks: each slot's result, in clip
        order, as {"loss": [...], "delta": [...], ...}."""
        from flickering_adversarial_video_tpu_torch.engine import vector_sweep

        traffic, attack = self.ctx.traffic, self.attack
        budget = _budget_iterations(self.world, traffic["chunk"], m, attack.get("max_chances", 1))
        if self.world == "tanh":
            res = vector_sweep.vector_single_video_attacks(
                self.engine, self.clips, self.labels, self.flags, slots=traffic["slots"],
                chunk=traffic["chunk"], max_step=attack["max_step"], stop_rule="reference",
                hard_cap=budget["hard_cap"], track_history=True)
            return [None if r is None else {
                "loss": r["total_loss_l"], "delta": r["perturbation"],
                "probs": [_label_and_other(p[0], lab) for p in r["softmax"][:traffic["checked_steps"]]],
                "step_probs": r["softmax"][:traffic["checked_steps"]],
                "steps": len(r["total_loss_l"]), "total_steps": r["total_steps"]}
                for r, lab in zip(res, self.labels)]
        out_dir = os.path.join(self.root, f"call{len(os.listdir(self.root))}")
        batches = [{"video": c, "labels": np.asarray([l], np.int64), "paths": [f"clip{k}"]}
                   for k, (c, l) in enumerate(zip(self.clips, self.labels))]
        got = vector_sweep.vector_fit_many_videos(
            self.engine, batches, self.flags, model_dir=out_dir,
            label_names=[str(i) for i in range(self.ctx.cfg["num_classes"])],
            slots=traffic["slots"], chunk=traffic["chunk"], n_iter=budget["n_iter"],
            max_norm=attack["max_norm"], escalation=attack["escalation"],
            max_chances=attack["max_chances"], init_scale=attack["init_scale"],
            track_history=True)
        by_path = {os.path.basename(p): p for p, _ in got["results"]}
        out = []
        for k, lab in enumerate(self.labels):
            path = by_path.get(f"clip{k}_@{lab}.npy")
            if path is None:
                out.append(None)
                continue
            r = np.load(path, allow_pickle=True).item()
            out.append({"loss": r["loss/total"], "delta": r["perturbation"],
                        "clean": np.asarray(r["prob_clean_input"]),
                        "steps": len(r["loss/total"]), "fooled": r["is_adversarial"],
                        "escalations": r["escalations"], "final_max_norm": r["final_max_norm"],
                        "n_iter": budget["n_iter"]})
        shutil.rmtree(out_dir, ignore_errors=True)
        return out

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)


def first_probs(r: Dict) -> torch.Tensor:
    """A slot's probabilities [1, K] at its first step, as the program gave
    them: its first step's in the tanh world, its clean check's (delta 0,
    within init_scale of the first step's) in the mean/std world, whose
    history keeps no probabilities."""
    p = r["step_probs"][0] if "step_probs" in r else r["clean"]
    return torch.as_tensor(np.asarray(p)).reshape(1, -1)


def _label_and_other(p: np.ndarray, label: int):
    """(p_label, p_max_other) of one clip's probabilities."""
    other = p.copy()
    other[label] -= 1.0
    return float(p[label]), float(other.max())


def escalate_replay(fooled: List[bool], n_iter: int, max_chances: int, escalation: float,
                    max_norm: float):
    """(steps, escalations, final max_norm) that the escalate rule gives a
    slot whose executed steps gave the verdicts `fooled`: before each step,
    exit when step >= n_iter and the last step fooled; past n_iter,
    escalate (max_norm times `escalation`, step 0), and end at the
    max_chances-th escalation."""
    step = chances = ran = 0
    last = False
    while True:
        if step >= n_iter and last:
            break
        if step > n_iter:
            chances += 1
            max_norm *= escalation
            step = 0
            if chances >= max_chances:
                break
        if ran >= len(fooled):
            return None  # the history ended before the rule did
        last = bool(fooled[ran])
        ran += 1
        step += 1
    return ran, chances, max_norm


def inputs(ctx, engine, flags):
    """The cell's inputs, as a run and the control both make them: (the
    slots' clips as the runners' readers hand them, numpy [1,T,H,W,3]; their
    labels, the victim's clean predictions; each slot's initial delta)."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    geo = cfg["clips"]["sweep"]
    n, t, s = traffic["slots"], geo["frames"], geo["size"]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    clips, labels, deltas = [], [], []
    for k in range(n):
        u8 = clip_lib.draw(gen, (1, t, s, s, 3), dev)
        clip = u8.float() / 128.0 - 1.0 if geo["dtype"] == "float32" else u8
        clean = engine.forward(None, {"video": clip, "labels": torch.zeros(1, device=dev)},
                               flags, adversarial=False, seed=k)
        labels.append(int(clean.argmax()))
        clips.append(clip.cpu().numpy())
        deltas.append(ctx.initial_delta((t, 1, 1, 3), traffic["attack"], slot=k))
    return clips, labels, deltas


def checked(ctx, made):
    """[(the checked steps' (video, labels) on the device, delta0)], a slot
    each: what the reference follows, from `made` = ``inputs(...)``."""
    clips, labels, deltas = made
    dev, k_steps = ctx.device, ctx.traffic["checked_steps"]
    return [([(torch.as_tensor(c, device=dev), torch.tensor([lab], device=dev))] * k_steps,
              d0.to(dev)) for c, lab, d0 in zip(clips, labels, deltas)]


def run(ctx) -> Dict:
    cfg, traffic, attack, dev = ctx.cfg, ctx.traffic, ctx.traffic["attack"], ctx.device
    geo = cfg["clips"]["sweep"]
    n, t, s = traffic["slots"], geo["frames"], geo["size"]
    model, sd = ctx.victim()
    engine = program.engine(cfg, attack, model, t)
    flags = program.flags(attack)
    made = inputs(ctx, engine, flags)
    clips, labels, _ = made
    ctx.phase("inputs")
    sweep = Sweep(ctx, engine, flags, clips, labels)
    sweep.call(1)  # warm-up: every shape of the window's call
    ctx.sync()

    out = {"attempted": n}
    if ctx.trace:
        m = traffic["trace_chunks"]
        with observed() as seen:
            res, rec = ctx.traced(lambda: sweep.call(m))
        steps = m * traffic["chunk"]
        rec.update(mix="sweep", steps=steps, chunks=m,
                   clip_steps=sum(r["steps"] for r in res if r),
                   capture_s=sum(g.capture_s for g in seen["graphs"]),
                   clip_step_flops=ctx.work.clip_step_flops(t, s, s, cfg["num_classes"]),
                   port_bound_s=ctx.port_bounds(n, t, s, "float" if geo["dtype"] == "float32"
                                                else "packed_u8", steps))
        out["record"] = rec
    else:
        m = max(1, round(ctx.seconds / traffic["chunk_seconds"]))
        ctx.mark_setup()
        t0 = time.perf_counter()
        with observed() as seen:
            res = sweep.call(m)
        ctx.sync()
        window_s = time.perf_counter() - t0
        starts = [t0] + seen["chunk_starts"] + [t0 + window_s]
        print(f"[window] {window_s:.3f} s: slot graph capture "
              f"{sum(g.capture_s for g in seen['graphs']):.3f} s; from the call's start to the "
              f"first chunk, between chunks, and after the last: "
              f"{[round(b - a, 3) for a, b in zip(starts, starts[1:])]}", file=sys.stderr)
        out["metrics"] = {"clip_steps_per_s": sum(r["steps"] for r in res if r) / window_s}
    out["failed"] = sum(r is None for r in res)
    out["peak_bytes"] = ctx.peak_bytes()
    sweep.close()
    del sweep, engine, model
    ctx.free()

    # the reference follows each slot's first steps; the stop rule is
    # replayed on each slot's own verdicts
    from ..check import joint_logit_gaps, slots_numbers, steps_numbers

    k_steps = traffic["checked_steps"]
    rows, bookkeeping, logits = [], 0, {"program": [], "reference": []}
    for k, (r, (batches, delta0)) in enumerate(zip(res, checked(ctx, made))):
        if r is None:
            continue
        ref = ctx.reference_steps(sd, batches, delta0, attack, block=1)
        (reg, (share,)), = ctx.reference_bases(sd, batches[:1], [delta0], [first_probs(r)],
                                               attack)
        rows.append(steps_numbers(r["loss"], torch.as_tensor(r["delta"][k_steps - 1]), delta0,
                                  ref, probs=r.get("probs"),
                                  delta_first=torch.as_tensor(r["delta"][0]),
                                  first_grad_ref=reg + share))
        logits["program"].append(r.get("step_probs"))
        logits["reference"].append(ref["logits"])
        if "clean" in r:
            video = batches[0][0]
            logits.setdefault("clean_program", []).append(r["clean"])
            logits.setdefault("clean_reference", []).append(
                ctx.reference_logits(sd, video, torch.zeros_like(delta0), attack))
        print(f"[check] slot {k}: {rows[-1]} losses {list(map(float, r['loss'][:k_steps]))} "
              f"reference {ref['loss']}", file=sys.stderr)
        if cfg["world"] == "tanh":
            want = _budget_iterations("tanh", traffic["chunk"], m)["hard_cap"]
            bookkeeping += int(r["total_steps"] != want or r["steps"] != want + 1)
        else:
            got = escalate_replay(r["fooled"], r["n_iter"], attack["max_chances"],
                                  attack["escalation"], attack["max_norm"])
            bookkeeping += int(got is None or got != (r["steps"], r["escalations"],
                                                      r["final_max_norm"]))
    missing = float(sum(r is None for r in res))
    out["numbers"] = {**(slots_numbers(rows) if rows else {}), **joint_logit_gaps(logits),
                      "bookkeeping": float(bookkeeping), "missing": missing}
    return out
