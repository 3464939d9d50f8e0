"""TensorBoard scalars with the reference's tag names.

Port of the JAX package's ``viz/tensorboard.py``.  Tags: Loss/{total,
adversarial_loss, regularizer_loss, regularizer_loss_weighted, thickness,
L12, first_order_temporal_diff, second_order_temporal_diff},
Perturbation/{thickness_%, roughness_%, max, min},
Probability/{prob_to_min, prob_to_max}.

Uses tensorboardX when present, else torch's SummaryWriter, else a JSONL
file (``scalars.jsonl``) so headless environments still record scalars.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._impl = None
        self._jsonl = None
        try:
            from tensorboardX import SummaryWriter

            self._impl = SummaryWriter(log_dir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._impl = SummaryWriter(log_dir)
            except ImportError:
                self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._impl is not None:
            self._impl.add_scalar(tag, value, step)
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
                + "\n"
            )
            self._jsonl.flush()

    def attack_step_scalars(self, metrics: Dict[str, float], step: int) -> None:
        m = metrics
        self.scalar("Loss/total", m["total_loss"], step)
        self.scalar("Loss/adversarial_loss", m["adv_loss"], step)
        self.scalar("Loss/regularizer_loss", m["reg_loss"], step)
        if "weighted_reg" in m:
            self.scalar("Loss/regularizer_loss_weighted", m["weighted_reg"], step)
        self.scalar("Loss/thickness", m["norm_reg"], step)
        if "l12" in m:
            self.scalar("Loss/L12", m["l12"], step)
        self.scalar("Loss/first_order_temporal_diff", m["diff_norm_reg"], step)
        self.scalar("Loss/second_order_temporal_diff", m["laplacian_norm_reg"], step)
        self.scalar("Perturbation/thickness_%", m["thickness"] / 2.0 * 100, step)
        self.scalar("Perturbation/roughness_%", m["roughness"] / 2.0 * 100, step)
        if "delta_max" in m:
            self.scalar("Perturbation/max", m["delta_max"], step)
            self.scalar("Perturbation/min", m["delta_min"], step)
        if "prob_to_min" in m:
            self.scalar("Probability/prob_to_min", m["prob_to_min"], step)
            self.scalar("Probability/prob_to_max", m["prob_to_max"], step)

    def close(self):
        if self._impl is not None:
            self._impl.close()
        if self._jsonl is not None:
            self._jsonl.close()
