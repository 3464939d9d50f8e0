"""The universal flickering-attack step on I3D, in PyTorch.

Port of the JAX package's ``engine/attack_step.py`` (``AttackEngine``,
``_train_step_impl`` :500, ``_loss_terms`` :426-496, ``train_steps`` :676)
for the tanh world and the flickering delta.  One ``train_step``:

* the uint8 batch (``"video"`` [B,T,H,W,3], packed on the device, or the
  host-packed ``"video_packed"`` [B,T/2,H/2,W/2,24]) enters the input head
  (``ops/packed_apply.flicker_stem``): x/128-1 + flag*clip(delta), clipped to
  [-1, 1], and the stem conv (kernel B1);
* the frozen I3D trunk gives logits; the adversarial loss, the four
  regularizers and their weighted sum give the total;
* the backward runs over delta only; Adam with the step's learning rate
  updates delta (written out to match ``optax.adam``: b1 0.9, b2 0.999,
  eps 1e-8, bias-corrected, m_hat / (sqrt(v_hat) + eps));
* metrics are taken on the PRE-update delta, as the reference fetches them.

Runtime flags are plain Python scalars per call.  Nothing synchronises with
the device inside a step: metrics stay tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..attack import losses as losses_lib
from ..attack import metrics as metrics_lib
from ..attack import perturbation as pert_lib
from ..attack import regularizers as reg_lib
from ..models.i3d import InceptionI3D
from ..ops.packed_apply import flicker_stem
from ..ops.space_to_depth import pack_input

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Static attack configuration (tanh world, flickering delta)."""

    improve_loss: bool = True          # IMPROVE_ADV_LOSS
    margin: float = 0.05               # PROB_MARGIN
    targeted: bool = False             # TARGETED_ATTACK
    use_logits: bool = False           # USE_LOGITS
    reg_weighting: str = "tf"          # 'tf' (b1,b2,b3) | 'torch' (b1,1-b1)
    exclude_misclassify: bool = True
    target_class: Optional[int] = None
    # attacked frame window [start, end], inclusive; None = every frame
    frame_window: Optional[Tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """Per-step scalars (the reference's placeholder_with_default values)."""

    adv_flag: float = 1.0
    beta0: float = 1.0     # LAMBDA
    beta1: float = 0.5
    beta2: float = 0.5
    beta3: float = 0.5
    learning_rate: float = 1e-3


@dataclasses.dataclass
class AttackState:
    delta: torch.Tensor    # [T,1,1,C] f32
    mu: torch.Tensor       # Adam first moment
    nu: torch.Tensor       # Adam second moment
    step: int = 0


class AttackEngine:
    """Attack/eval steps for one (victim, spec, config) triple on the
    model's device.  ``model`` is the frozen :class:`InceptionI3D`."""

    def __init__(
        self, model: InceptionI3D, spec: pert_lib.FlickerSpec,
        config: AttackConfig = AttackConfig(), track_probs: bool = True,
    ):
        if config.reg_weighting not in ("tf", "torch"):
            raise ValueError(f"reg_weighting {config.reg_weighting!r}")
        self.model = model
        self.spec = spec
        self.config = config
        self.track_probs = track_probs
        self.device = model.device
        self._mask = None
        if config.frame_window is not None:
            start, end = config.frame_window
            self._mask = pert_lib.frame_mask(spec.frames, start, end, device=self.device)

    # ---------- state and batches ----------

    def init_state(self) -> AttackState:
        delta = pert_lib.init_delta(self.spec, device=self.device)
        return AttackState(delta, torch.zeros_like(delta), torch.zeros_like(delta), 0)

    def prepare_batch(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(packed uint8 clip [B,T/2,H/2,W/2,24] on the device, labels int64)."""
        if "video_packed" in batch:
            packed = torch.as_tensor(batch["video_packed"], device=self.device)
        else:
            video = torch.as_tensor(batch["video"], device=self.device)
            if video.dtype != torch.uint8:
                raise TypeError("the attack step takes uint8 clips")
            packed = pack_input(video).contiguous()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        return packed, labels

    # ---------- forward pieces ----------

    def _logits(self, delta: Optional[torch.Tensor], packed, flags: RuntimeFlags):
        """clip/mask delta -> input head -> trunk.  delta=None is the clean
        forward through the same head (flag 0, delta 0)."""
        if delta is None:
            clipped = torch.zeros(self.spec.shape, device=self.device)
            flag = 0.0
        else:
            clipped = pert_lib.clip_delta(self.spec, delta)
            if self._mask is not None:
                clipped = clipped * self._mask
            flag = flags.adv_flag
        pk, mean, var, bias = self.model.stem_params()
        y = flicker_stem(
            packed, clipped, torch.full((), flag, device=self.device),
            pk, mean, var, bias, self.spec.input_min, self.spec.input_max,
            self.model.compute_dtype,
        )
        return self.model.trunk(y)

    def _loss_terms(self, delta, packed, labels, flags: RuntimeFlags):
        cfg = self.config
        logits = self._logits(delta, packed, flags)
        adv_total, aux = losses_lib.adversarial_loss(
            logits, labels, improve_loss=cfg.improve_loss, margin=cfg.margin,
            targeted=cfg.targeted, use_logits=cfg.use_logits,
        )
        norm_r = reg_lib.thinness_reg(delta)
        diff_r = reg_lib.first_order_diff_reg(delta)
        lap_r = reg_lib.second_order_diff_reg(delta)
        l12_r = reg_lib.l12_regularizer(delta)
        if cfg.reg_weighting == "torch":
            reg = flags.beta1 * norm_r + (1.0 - flags.beta1) * (diff_r + lap_r)
        else:
            reg = flags.beta1 * norm_r + flags.beta2 * diff_r + flags.beta3 * lap_r
        total = adv_total + flags.beta0 * reg
        terms = {
            "adv_loss": adv_total,
            "reg_loss": reg,
            "weighted_reg": flags.beta0 * reg,
            "l12": l12_r,
            "norm_reg": norm_r,
            "diff_norm_reg": diff_r,
            "laplacian_norm_reg": lap_r,
            "prob_to_min": aux["prob_to_min"].mean(),
            "prob_to_max": aux["prob_to_max"].mean(),
            "probs": aux["probs"],
        }
        return total, terms

    # ---------- steps ----------

    def _adam(self, state: AttackState, grad: torch.Tensor, lr: float) -> AttackState:
        step = state.step + 1
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * state.nu
        mu_hat = mu / (1 - ADAM_B1**step)
        nu_hat = nu / (1 - ADAM_B2**step)
        update = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return AttackState(state.delta + update, mu, nu, step)

    def _train_step(self, state: AttackState, packed, labels, flags: RuntimeFlags):
        delta = state.delta.detach().requires_grad_(True)
        total, terms = self._loss_terms(delta, packed, labels, flags)
        (grad,) = torch.autograd.grad(total, delta)
        with torch.no_grad():
            new_state = self._adam(state, grad, flags.learning_rate)
            pre = state.delta
            probs = terms.pop("probs").detach()
            metrics = {
                "total_loss": total.detach(),
                "thickness": metrics_lib.thickness(pre),
                "roughness": metrics_lib.roughness(pre),
                "delta_max": pre.max(),
                "delta_min": pre.min(),
                "is_adversarial": metrics_lib.is_adversarial(
                    probs, labels, targeted=self.config.targeted,
                    target_class=self.config.target_class,
                ),
                "step": state.step,
                **{k: v.detach() for k, v in terms.items()},
            }
            if self.track_probs:
                metrics["probs"] = probs
        return new_state, metrics

    def train_step(
        self, state: AttackState, batch: Dict, flags: RuntimeFlags = RuntimeFlags()
    ) -> Tuple[AttackState, Dict[str, torch.Tensor]]:
        packed, labels = self.prepare_batch(batch)
        return self._train_step(state, packed, labels, flags)

    def train_steps(
        self, state: AttackState, batch: Dict, flags: RuntimeFlags = RuntimeFlags(), n: int = 1
    ) -> AttackState:
        """n optimizer steps on one batch (the batch is moved once)."""
        packed, labels = self.prepare_batch(batch)
        for _ in range(n):
            state, _ = self._train_step(state, packed, labels, flags)
        return state

    @torch.no_grad()
    def eval_step(
        self, delta: torch.Tensor, batch: Dict, flags: RuntimeFlags = RuntimeFlags()
    ) -> Dict[str, torch.Tensor]:
        packed, labels = self.prepare_batch(batch)
        delta = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        adv_probs = torch.softmax(self._logits(delta, packed, flags), dim=-1)
        clean_probs = torch.softmax(self._logits(None, packed, flags), dim=-1)
        miss, valid = metrics_lib.fooling_counts(
            adv_probs, clean_probs, labels, targeted=self.config.targeted,
            target_class=self.config.target_class,
            exclude_misclassify=self.config.exclude_misclassify,
        )
        return {"miss": miss, "valid": valid, "adv_probs": adv_probs, "clean_probs": clean_probs}

    @torch.no_grad()
    def forward(
        self, delta: torch.Tensor, batch: Dict, flags: RuntimeFlags = RuntimeFlags(),
        adversarial: bool = True,
    ) -> torch.Tensor:
        packed, _ = self.prepare_batch(batch)
        if adversarial:
            delta = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        logits = self._logits(delta if adversarial else None, packed, flags)
        return torch.softmax(logits, dim=-1)
