"""Run chip_smoke.py's phase 18b (two ranks over gloo against one process)
with planted reduction faults, to show that its limits catch each.

    python3 scripts/torch_parallel_fault.py

The faults, planted in each rank (the one process is left as it is):

* ``unreduced``: each rank hands Adam its own d(delta), not the sum over the
  ranks;
* ``reg_twice``: every rank's backward takes the regularizers, so that
  d(delta) counts them W times;
* ``hinge_averaged``: each rank's hinge is divided by W, the hinge taken as
  a mean over the global batch where the reference sums it.

Each failed check of the phase prints its FAIL line, and the phase goes on.
Prints each run's readings (bf16 and f32) beside the sound run's and exits
0 when the sound run passed and every fault failed the phase's limits, else
1.  Needs one CUDA card; builds the
port's kernels first.
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

_REDUCE, _RANK_LOSS = AttackEngine._reduce, AttackEngine._rank_loss


def _unreduced(self, grad, terms, probs, fooled):
    _, total, probs, fooled = _REDUCE(self, grad.clone(), terms, probs, fooled)
    return grad, total, probs, fooled


def _reg_every_rank(self, terms):
    loss = _RANK_LOSS(self, terms)
    return loss if self.mesh.rank == 0 else loss + terms["weighted_reg"]


def _hinge_averaged(self, terms):
    terms["adv_loss"] = terms["adv_loss"] / self.mesh.world
    return _RANK_LOSS(self, terms)


def plant_unreduced():
    mock.patch.object(AttackEngine, "_reduce", _unreduced).start()


def plant_reg_twice():
    mock.patch.object(AttackEngine, "_rank_loss", _reg_every_rank).start()


def plant_hinge_averaged():
    mock.patch.object(AttackEngine, "_rank_loss", _hinge_averaged).start()


FAULTS = {"unreduced": plant_unreduced, "reg_twice": plant_reg_twice,
          "hinge_averaged": plant_hinge_averaged}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", flush=True)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from flickering_adversarial_video_tpu_torch.ops import kernels

    kernels.build()
    dev = torch.device("cuda")
    caught = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, plant in (("sound", None), *FAULTS.items()):
            failed = []
            with mock.patch.object(chip_smoke, "fail", failed.append):
                d = os.path.join(tmp, name)
                os.makedirs(d)
                runs[name] = chip_smoke.dp_gloo_phase(d, dev, plant=plant)
            caught[name] = [m.split(":")[0] for m in failed]
        for name, readings in runs.items():
            for key, r in readings.items():
                print(f"[fault] {name} {key}: share {r['share']:.4%}, losses {r['loss_rel']:.3g}, "
                      f"ranks equal {r['equal']}, max |d delta| {r['max_abs']:.3g}", flush=True)
    print(f"[fault] failed checks by run: {caught}", flush=True)
    return 0 if not caught["sound"] and all(caught[name] for name in FAULTS) else 1


if __name__ == "__main__":
    sys.exit(main())
