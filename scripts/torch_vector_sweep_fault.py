"""Run chip_smoke.py's phase 17 (the vectorized sweep) with a planted fault,
to show that its limits catch a wrong per-slot gradient.

    python3 scripts/torch_vector_sweep_fault.py

The fault: the slot step hands Adam d(delta) summed over the slots, so that
every slot steps by the batch's gradient instead of its own (the sequential
step is left as it is).  Phase 16 runs first, for the sweep that phase 17's
path (c) reruns with slots.  Each failed check of phase 17 prints its FAIL
line, and the phase goes on to its end.  Exits 0 when the fault failed the
check of each slot against the sequential step, with the packed head (17b)
and with USE_PALLAS_FUSED (17f), and the check of the single-video runner
with SLOTS: 4 against SLOTS: 1 (17d), else 1.  Needs one CUDA card; builds
the port's kernels at first use.
"""

from __future__ import annotations

import os
import sys
import tempfile
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from flickering_adversarial_video_tpu_torch.engine.attack_step import AttackEngine  # noqa: E402

_ADAM = AttackEngine._adam


def summed_adam(delta, mu, nu, step, grad, lr):
    """Adam with the fault: a step with a count a slot takes d(delta) summed
    over the slots."""
    if step.dim():
        grad = grad.sum(0, keepdim=True).expand_as(grad)
    return _ADAM(delta, mu, nu, step, grad, lr)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", flush=True)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []

    def record(msg: str) -> None:
        print(f"FAIL (with the planted fault): {msg}", flush=True)
        failed.append(msg)

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        sweep_run = chip_smoke.torch_world_phase(tmp, dev)
        with mock.patch.object(AttackEngine, "_adam", staticmethod(summed_adam)), \
                mock.patch.object(chip_smoke, "fail", record), \
                mock.patch.object(chip_smoke, "VS_TIME_SLOTS", ()):
            chip_smoke.vector_sweep_phase(tmp, dev, sweep_run)
    fused = "the fused slot step: "
    caught = {"17b": any(m.startswith("a slot's trajectory") for m in failed),
              "17f": any(m.startswith(fused + "a slot's trajectory") for m in failed),
              "17d": any("single-video runner" in m for m in failed)}
    print(f"[fault] d(delta) summed over the slots: caught by {caught}", flush=True)
    return 0 if all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
