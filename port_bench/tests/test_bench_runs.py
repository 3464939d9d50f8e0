"""Each cell at a tiny size through the whole harness on the CPU: the
result line as the contract has it, and ``correct`` false under each fault
that a cell can have, planted in the port underneath the timed path."""

from __future__ import annotations

import math

import pytest
import torch

from port_bench.tests import bench_tiny

CELLS = bench_tiny.cells()
KEYS = ("correct", "attempted", "failed", "metrics", "device", "check")


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_prints_the_result_line(cell):
    rc, line = bench_tiny.run(cell)
    assert rc == 0
    assert tuple(line) == KEYS  # ``check`` comes last
    assert set(line["metrics"]) >= {"clip_steps_per_s", "setup_s"}
    assert ("step_ms_p95" in line["metrics"]) == ("universal" in cell)
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1
    for name, r in line["check"].items():
        assert math.isfinite(r["value"]) and r["limit"] >= 0, name


def _state_unchanged(monkeypatch):
    from flickering_adversarial_video_tpu_torch.engine.attack_step import AttackEngine

    def adam(delta, mu, nu, step, grad, lr):
        return delta, mu, nu, step + 1

    monkeypatch.setattr(AttackEngine, "_adam", staticmethod(adam))
    return {"universal": "change_gap", "sweep": "change_gap"}


def _half_batch(monkeypatch):
    """A batched step's gradient comes from the first half of the batch
    alone, the mean taken over it (twice its share), while every clip's
    logits, loss and probabilities stay whole; a sweep's slot step leaves
    the second half of its slots out."""
    from flickering_adversarial_video_tpu_torch.engine.attack_step import AttackEngine

    logits, slot_step = AttackEngine._logits, AttackEngine._slot_step

    def half(self, *args, **kw):
        z = logits(self, *args, **kw)
        n = max(1, z.shape[0] // 2)
        return torch.cat([2.0 * z[:n] - z[:n].detach(), z[n:].detach()])

    def half_slots(self, delta, mu, nu, count, video, packed, labels, scalars, max_norm, seeds,
                   active):
        keep = torch.arange(active.shape[0], device=active.device) < max(1, active.shape[0] // 2)
        return slot_step(self, delta, mu, nu, count, video, packed, labels, scalars, max_norm,
                         seeds, active & keep)

    monkeypatch.setattr(AttackEngine, "_logits", half)
    monkeypatch.setattr(AttackEngine, "_slot_step", half_slots)
    return {"universal": "clip_weight_err", "sweep": "change_gap"}


def _answer_altered(monkeypatch):
    """The first clip's logits come out shifted by one class."""
    from flickering_adversarial_video_tpu_torch.engine.attack_step import AttackEngine

    logits = AttackEngine._logits

    def altered(self, *args, **kw):
        z = logits(self, *args, **kw)
        return torch.cat([z[:1].roll(1, dims=-1), z[1:]])

    monkeypatch.setattr(AttackEngine, "_logits", altered)
    return {"universal": "logit_gap", "sweep": "logit_gap"}


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_reads_incorrect(cell, fault, monkeypatch):
    number = FAULTS[fault](monkeypatch)["universal" if "universal" in cell else "sweep"]
    rc, line = bench_tiny.run(cell)
    assert rc == 0
    assert line["correct"] is False
    failing = [k for k, r in line["check"].items()
               if r["value"] is None or not r["value"] <= r["limit"]]
    assert any(k.startswith(number) or k.startswith("clean_" + number) for k in failing), failing
