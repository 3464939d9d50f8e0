"""The batched mix: ``AttackEngine.train_step`` fed as
``engine.loops.batched_attack_loop`` feeds it.

A pool of ``pool_batches`` distinct seeded uint8 batches is made on the
card in set-up and kept in pinned host memory; a producer thread
(``PrefetchIterator``, ``prefetch_depth``) copies each batch to the card
without blocking (``loops._to_device``), epoch by epoch of
``epoch_batches``; every ``log_every`` steps the step's metrics are read to
the host.  No eval, checkpoint or writer.  The labels are the victim's
clean predictions, so that the hinge has work to do.

Set-up drives the engine through its first ``checked_steps`` steps on the
window's own feed (the first captures the step graph) and keeps their
losses, probabilities, the first moment after one step and delta after the
last; the window then takes the same engine and state.  The window issues
steps until ``--seconds`` have passed on the host and ends when the card has
run them all; ``step_ms_p95`` is taken over the times between consecutive
step ends, CUDA events recorded after each ``train_step``.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch

from .. import clips, program
from ..reference import attack as ref_attack

READ = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg", "laplacian_norm_reg",
        "thickness", "roughness", "prob_to_min", "prob_to_max")


class Feed:
    """The loop's feed: one PrefetchIterator an epoch over the pool."""

    def __init__(self, pool_video, pool_labels, epoch: int, depth: int, device):
        self.video, self.labels = pool_video, pool_labels
        self.epoch, self.depth, self.device = epoch, depth, device
        self.at, self.it = 0, None

    def _epoch(self, start: int):
        from flickering_adversarial_video_tpu_torch.engine.loops import _to_device

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        for i in range(start, start + self.epoch):
            k = i % len(self.video)
            yield _to_device({"video": self.video[k], "labels": self.labels[k]}, self.device)

    def next(self):
        from flickering_adversarial_video_tpu_torch.data.video_dataset import PrefetchIterator

        if self.it is None:
            self.it = PrefetchIterator(self._epoch(self.at), depth=self.depth)
        batch = next(self.it, None)
        if batch is None:
            self.close()
            return self.next()
        self.at += 1
        return batch

    def close(self):
        if self.it is not None:
            self.it.close()
            self.it = None


def inputs(ctx, engine, flags):
    """The cell's inputs, as a run and the control both make them: (the pool
    of uint8 batches [pool_batches, B, T, H, W, 3] on the host, pinned where
    a card serves, drawn on the device a batch at a time; each batch's
    labels, the victim's clean predictions; the initial delta)."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    geo = cfg["clips"]["universal"]
    b, t, s = traffic["batch"], geo["frames"], geo["size"]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    n_pool = traffic["pool_batches"]
    pool = torch.empty((n_pool, b, t, s, s, 3), dtype=torch.uint8, pin_memory=dev.type == "cuda")
    labels = []
    for i in range(n_pool):
        drawn = clips.draw(gen, pool.shape[1:], dev)
        pool[i].copy_(drawn)
        clean = engine.forward(None, {"video": drawn, "labels": torch.zeros(b, device=dev)},
                               flags, adversarial=False)
        labels.append(clean.argmax(-1).cpu())
    return pool, labels, ctx.initial_delta(engine.spec.shape, ctx.traffic["attack"])


def checked(ctx, made):
    """[(the checked steps' (video, labels) on the device, delta0)]: what the
    reference follows, from `made` = ``inputs(...)``."""
    pool, labels, delta0 = made
    dev = ctx.device
    return [([(pool[i % len(pool)].to(dev), labels[i % len(pool)].to(dev))
              for i in range(ctx.traffic["checked_steps"])], delta0.to(dev))]


def run(ctx) -> Dict:
    cfg, traffic, attack, dev = ctx.cfg, ctx.traffic, ctx.traffic["attack"], ctx.device
    geo = cfg["clips"]["universal"]
    b, t, s = traffic["batch"], geo["frames"], geo["size"]
    model, sd = ctx.victim()
    engine = program.engine(cfg, attack, model, t)
    flags = program.flags(attack)
    made = inputs(ctx, engine, flags)
    pool, labels, delta0 = made
    ctx.phase("inputs")

    from flickering_adversarial_video_tpu_torch.engine import AttackState

    state = AttackState(delta0.to(dev), torch.zeros_like(delta0, device=dev),
                        torch.zeros_like(delta0, device=dev), 0)
    feed = Feed(pool, labels, traffic["epoch_batches"], traffic["prefetch_depth"], dev)

    # the checked steps, on the window's own call and feed
    losses, probs, step_probs, deltas, moments = [], [], [], [], []
    for i in range(traffic["checked_steps"]):
        deltas.append(state.delta.clone())
        state, m = engine.train_step(state, feed.next(), flags)
        losses.append(m["total_loss"])
        probs.append((m["prob_to_min"], m["prob_to_max"]))
        step_probs.append(m["probs"])
        moments.append(state.mu.clone())
    delta_after = state.delta.clone()
    delta1 = deltas[1] if len(deltas) > 1 else delta_after
    ctx.sync()
    losses = [float(x) for x in losses]
    probs = [(float(a), float(b)) for a, b in probs]
    step_probs = [p.cpu() for p in step_probs]
    # each step's gradient as Adam got it: mu_k = b1 mu_(k-1) + (1 - b1) g_k
    grads = [(mu - ref_attack.ADAM_B1 * prev) / (1.0 - ref_attack.ADAM_B1)
             for mu, prev in zip(moments, [torch.zeros_like(moments[0])] + moments[:-1])]

    cuda = dev.type == "cuda"

    def steps(n_max=None, seconds=None):
        nonlocal state
        ends, n, t0 = [], 0, time.perf_counter()
        if cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        while True:
            state, m = engine.train_step(state, feed.next(), flags)
            n += 1
            if cuda:
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
            if n % traffic["log_every"] == 0:
                torch.stack([m[k].float() for k in READ]).tolist()
            if (n_max is not None and n >= n_max) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        ctx.sync()
        return n, time.perf_counter() - t0, ends

    out = {"failed": 0}
    if ctx.trace:
        (n, _, _), rec = ctx.traced(lambda: steps(n_max=traffic["trace_steps"]))
        rec.update(mix="universal", steps=n, chunks=0, clip_steps=b * n,
                   capture_s=sum(v["capture_s"] for v in engine.graph_stats().values()),
                   clip_step_flops=ctx.work.clip_step_flops(t, s, s, cfg["num_classes"]),
                   port_bound_s=ctx.port_bounds(b, t, s, "packed_u8" if cfg["world"] == "tanh"
                                                else "float", n))
        out["record"] = rec
    else:
        ctx.mark_setup()
        n, window_s, ends = steps(seconds=ctx.seconds)
        if cuda:
            gaps = sorted(a.elapsed_time(c) for a, c in zip(ends, ends[1:]))
        else:
            gaps = [window_s * 1e3 / n]
        out["metrics"] = {"clip_steps_per_s": b * n / window_s,
                          "step_ms_p95": ctx.percentile(gaps, 95)}
    out["attempted"] = n
    feed.close()
    out["peak_bytes"] = ctx.peak_bytes()
    del engine, model, state, m
    ctx.free()

    # the reference follows the checked steps on the same batches and
    # weights, and gives each clip's share of the gradient at the program's
    # delta of each step
    (batches, d0), = checked(ctx, made)
    ref = ctx.reference_steps(sd, batches, d0, attack, block=traffic["ref_block"])
    bases = ctx.reference_bases(sd, batches, deltas, step_probs, attack)
    from ..check import steps_numbers

    out["numbers"] = steps_numbers(losses, delta_after, delta0, ref, grads=grads, bases=bases,
                                   probs=probs, step_probs=step_probs, delta_first=delta1)
    print(f"[check] losses {losses} reference {ref['loss']}; probabilities {probs} reference "
          f"{list(zip(ref['p_label'], ref['p_other']))}", file=sys.stderr)
    return out
