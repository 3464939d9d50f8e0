"""The attack step, in PyTorch.

Port of the JAX package's ``engine/attack_step.py`` (``AttackEngine``,
``_train_step_impl`` :500, ``_train_eval_step_impl`` :553, ``_loss_terms``
:426-496, ``train_steps`` :676) in both input worlds.  The tanh world (I3D):
the flickering delta [T,1,1,C], or with
``AttackConfig.attack_kind='sparse'`` the L1,2 attack's full delta [T,H,W,C]
(``SparseSpec``), whose regularizer is beta1 * L1,2 (the JAX package's
:477-482); ``l12`` is logged in both kinds.  One ``train_step``:

* the uint8 batch (``"video"`` [B,T,H,W,3], packed on the device, or the
  host-packed ``"video_packed"`` [B,T/2,H/2,W/2,24]) enters the input head
  (``ops/packed_apply.flicker_stem``): x/128-1 + flag*clip(delta), clipped to
  [-1, 1] (kernel B7), and the stem conv (kernel B1);
* with ``AttackConfig.use_pallas_fused`` the unpacked uint8 ``"video"`` goes
  through ``ops/fused_apply.fused_normalize_perturb`` (kernel B8) to an f32
  clip and the victim's own forward, and B8's backward reduces d(adv) to
  d(delta), at an exact bound by the rule of the JAX call on the global
  batch (``_fused_strict``: the Pallas kernel's strict mask where the JAX
  call takes it, ``jnp.clip``'s half elsewhere); eval and ``forward`` then
  take the generic path (normalize, ``apply_perturbation``, the victim's
  forward), as the JAX engine's do.  A
  victim without a packed stem (no ``stem_params``), a sparse delta, a
  cyclic engine or an odd T, H or W runs the generic path throughout, as the
  JAX engine's ``_packed_supported`` / ``packable`` gates have it;
* with ``AttackConfig.enable_cyclic`` (the YAML's ``CYCLIC_ATTACK`` or
  ``CYCLIC_PERTURBATION_ATTACK``) the generic path rolls the input and delta
  in time (``attack/perturbation.apply_perturbation``), blended by the
  runtime flags ``cyclic_flag`` / ``cyclic_pert_flag``; without it the rolls
  are not compiled in and the flags are inert, as in the JAX engine.  The
  shifts are drawn on the device from the call's ``seed`` and a counter
  (``perturbation.roll_shifts``): the step count + 1 in a train step, so each
  replay of a graph draws its own, and 0 in the eval step and ``forward``
  (the JAX loops' ``fold_in(key, step)`` and ``key``);
* the frozen I3D trunk gives logits; the adversarial loss, the four
  regularizers and their weighted sum give the total;
* the backward runs over delta only; Adam with the step's learning rate
  updates delta (written out to match ``optax.adam``: b1 0.9, b2 0.999,
  eps 1e-8, m_hat / (sqrt(v_hat) + eps), the bias corrections computed on
  the device in f32 from a device int32 step count, as optax computes them);
* metrics are taken on the PRE-update delta, as the reference fetches them.

The vectorized sweep's slot step (``_slot_step``, the JAX sweep's vmapped
``_per_clip_step``, ``engine/vector_sweep.py:186-229``): N clips, each a
batch of one with its own delta [N, *spec.shape], Adam moments and int32
count [N], are one batch of N through one forward (the victim's BN is frozen,
so the clips do not meet); every loss term is per slot ([N]), the backward
runs on their sum (delta i reaches only clip i, so each slot gets its own
gradient), Adam's bias corrections are per slot, and inactive slots keep
their delta, moments and count.  A slot's max_norm (the mean/std world's
bound, [N]) and its rolls' seed [N] come with it; the packed head takes B7's
per-clip form.  The loss terms and metrics are the un-slotted functions
``torch.func.vmap``-ed over the slots.  With ``use_pallas_fused`` the uint8
clips take B8's per-clip form, B8c (``ops/fused_apply``: delta [N,T,1,1,C],
d(delta) a clip; the JAX sweep vmaps ``fused_normalize_perturb`` over the
slots, so a slot takes the clip rule of one clip's geometry); float clips
keep the generic path, as without slots.

The mean/std world (``AttackConfig.norm_world='meanstd'``, the video
ResNets; ``TorchStyleFlickerSpec``): uint8 clips become (x/255 - mean)/std
in f32, the delta enters through ``apply_perturbation_torch_style`` (clamped
to the runtime ``max_norm``, over std, clamped to the spec's scalar range) on
the generic path, whose autograd gives d(delta) (the JAX engine's packed
torch head is a TPU layout of the same function), and the regularizers and
the thickness/roughness metrics act on delta clipped to +-max_norm
(``regularize_clipped``).  The clean forward normalizes without clamping.
``train_eval_step`` is the train step and the fooling counters of the same
batch in one program (one graph on CUDA), as the epoch fit uses it.

Data parallel over ranks (``mesh=``, a ``parallel.mesh.Mesh`` with a
group; the JAX engine's ``mesh=`` with its batch sharded and its state
replicated): each rank steps on its own slice of the global batch (``shard``
cuts one), with delta, the moments and the victim whole.  After the backward
one collective sums, over the ranks, d(delta) and the batch's statistics
(``_reduce``): the adversarial term's share of each rank (the hinge's sum
over its clips; CE's mean over them over W, since CE is a mean over the
global batch), the prob_to_* means over W, the clips not fooled and each
rank's probabilities in its own rows.  The regularizers act on the one
replicated delta, so only rank 0's backward takes them: d(delta) counts them
once.  Adam then runs on every rank alike, so delta stays equal on every
rank, and the metrics are the global batch's (``is_adversarial`` an AND over
the ranks).  The eval step and ``forward`` stay on the rank's own clips
(``loops.evaluate_fooling`` sums the counts once, at the end), and the slot
step has no collective (the sweeps split the slots over ranks instead).  On
CUDA the collective is captured in the step's graph, which needs NCCL: a
gloo group on the card runs the eager step when the caller asks for it
(``eager=True``), and is refused otherwise.

The runtime flags (``RuntimeFlags``, Python scalars per call) enter the
train, eval and forward steps through one static f32 device buffer, written
only when they change, so a step reads no host value.  On CUDA
``train_step`` and ``train_steps`` replay the step as a CUDA graph
(``engine/step_graph.py``, the counterpart of the JAX engine's jitted step
and ``lax.scan``), and the state handed to them is donated: the returned
state holds the graph's static tensors, which the next step overwrites.  On the CPU the same step runs eagerly (``_train_step``,
also the reference the graph is held to on the card).  Nothing synchronises
with the device inside a step: metrics stay tensors.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import torch

from ..attack import losses as losses_lib
from ..attack import metrics as metrics_lib
from ..attack import perturbation as pert_lib
from ..attack import regularizers as reg_lib
from ..ops.fused_apply import fused_normalize_perturb, strict_rule
from ..ops.packed_apply import flicker_stem
from ..ops.space_to_depth import pack_input
from ..parallel import mesh as mesh_lib
from .step_graph import StepGraphs

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the order of the runtime flags in the engine's static scalar buffer
SCALARS = ("adv_flag", "beta0", "beta1", "beta2", "beta3", "learning_rate", "cyclic_flag",
           "cyclic_pert_flag", "max_norm")
ATTACK_KINDS = ("flickering", "sparse")
NORM_WORLDS = ("tanh", "meanstd")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Static attack configuration."""

    improve_loss: bool = True          # IMPROVE_ADV_LOSS
    margin: float = 0.05               # PROB_MARGIN
    targeted: bool = False             # TARGETED_ATTACK
    use_logits: bool = False           # USE_LOGITS
    attack_kind: str = "flickering"    # 'flickering' | 'sparse' (L1,2; FLICKERING_ATTACK false)
    norm_world: str = "tanh"           # 'tanh' (x/128-1, I3D) | 'meanstd' (the video ResNets)
    reg_weighting: str = "tf"          # 'tf' (b1,b2,b3) | 'torch' (b1,1-b1)
    exclude_misclassify: bool = True
    target_class: Optional[int] = None
    # route preprocess + apply through the fused kernel B8
    # (ops/fused_apply.py; the YAML key USE_PALLAS_FUSED): unpacked uint8
    # input, input bounds exactly [-1, 1]
    use_pallas_fused: bool = False
    # attacked frame window [start, end], inclusive; None = every frame
    frame_window: Optional[Tuple[int, int]] = None
    # compile the cyclic rolls into the generic path (CYCLIC_ATTACK /
    # CYCLIC_PERTURBATION_ATTACK); off, the cyclic flags are inert
    enable_cyclic: bool = False

    @property
    def regularize_clipped(self) -> bool:
        """Regularizers and metrics see delta clipped to +-max_norm (the
        torch world), else the raw delta (the tanh world)."""
        return self.norm_world == "meanstd"


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """Per-step scalars (the reference's placeholder_with_default values)."""

    adv_flag: float = 1.0
    beta0: float = 1.0     # LAMBDA
    beta1: float = 0.5
    beta2: float = 0.5
    beta3: float = 0.5
    learning_rate: float = 1e-3
    cyclic_flag: float = 0.0       # blend of the time-rolled input (CYCLIC_ATTACK)
    cyclic_pert_flag: float = 0.0  # blend of the time-rolled delta (CYCLIC_PERTURBATION_ATTACK)
    max_norm: float = 1.0          # the torch world's delta bound (the sweep escalates it)


@dataclasses.dataclass
class AttackState:
    delta: torch.Tensor    # the spec's shape ([T,1,1,C] or [T,H,W,C]), f32
    mu: torch.Tensor       # Adam first moment
    nu: torch.Tensor       # Adam second moment
    step: int = 0          # steps taken; the step itself counts on the device

    def state_dict(self) -> Dict:
        """Plain dict of CPU tensors and the step (what a checkpoint holds)."""
        return {"delta": self.delta.detach().cpu(), "mu": self.mu.detach().cpu(),
                "nu": self.nu.detach().cpu(), "step": int(self.step)}

    def load_state_dict(self, sd: Dict) -> "AttackState":
        """A new state with `sd`'s values on this state's device."""
        for k in ("delta", "mu", "nu"):
            if tuple(sd[k].shape) != tuple(self.delta.shape):
                raise ValueError(f"checkpoint {k} {tuple(sd[k].shape)} does not match "
                                 f"the attack's delta {tuple(self.delta.shape)}")
        dev, dt = self.delta.device, self.delta.dtype
        return AttackState(*(torch.as_tensor(sd[k]).to(dev, dt) for k in ("delta", "mu", "nu")),
                           int(sd["step"]))


class AttackEngine:
    """Attack/eval steps for one (victim, spec, config) triple on the
    model's device.  ``model`` is the frozen victim: an :class:`InceptionI3D`
    (whose ``stem_params``/``trunk`` open the packed input head), a
    ``VideoResNet`` (mean/std world), or any module mapping a normalized clip
    [B,T,H,W,C] to logits (generic path).  On CUDA the train step is a CUDA
    graph, unless `eager`.  `mesh` (a ``parallel.mesh.Mesh`` with a group)
    makes the engine one rank of a data-parallel run; without a group it is
    ignored (world 1 is today's path)."""

    def __init__(
        self, model: torch.nn.Module, spec, config: AttackConfig = AttackConfig(),
        track_probs: bool = True, mesh: Optional[mesh_lib.Mesh] = None, eager: bool = False,
    ):
        if config.reg_weighting not in ("tf", "torch"):
            raise ValueError(f"reg_weighting {config.reg_weighting!r}")
        if config.norm_world not in NORM_WORLDS:
            raise ValueError(f"norm_world {config.norm_world!r}: choose from {NORM_WORLDS}")
        if config.frame_window is not None and config.norm_world != "tanh":
            raise ValueError("frame_window is a TF/I3D-world graph feature; the torch "
                             "Perturbation module has no frame mask")
        if config.attack_kind not in ATTACK_KINDS:
            raise ValueError(f"attack_kind {config.attack_kind!r}: choose from {ATTACK_KINDS}")
        if config.use_pallas_fused and (spec.input_min, spec.input_max) != (-1.0, 1.0):
            raise ValueError(
                "use_pallas_fused clips to the fixed bounds [-1, 1]; the spec's are "
                f"[{spec.input_min}, {spec.input_max}]"
            )
        if config.use_pallas_fused and not isinstance(spec, pert_lib.FlickerSpec):
            raise ValueError("use_pallas_fused (kernel B8) takes the flickering delta "
                             "[T,1,1,C] only, as the JAX package's fused_normalize_perturb")
        self.model = model
        self.spec = spec
        self.config = config
        self.track_probs = track_probs
        self.device = next(iter(model.state_dict().values())).device
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        if self.mesh is not None and self.device.type == "cuda" and not eager and (
                self.mesh.backend != "nccl"):
            raise ValueError(
                f"a {self.mesh.backend} group cannot be captured in the step's CUDA graph: use "
                "NCCL (one card a rank), or pass eager=True for eager steps")
        self._mask = None
        if config.frame_window is not None:
            start, end = config.frame_window
            self._mask = pert_lib.frame_mask(spec.frames, start, end, device=self.device)
        # made once: the packed clean forward's zero delta and zero flag
        self._zero_delta = (torch.zeros(spec.shape, device=self.device)
                            if self._packed_supported() else None)
        self._zero_flag = torch.zeros((), device=self.device)
        if config.norm_world == "meanstd":
            self._mean = torch.tensor(spec.mean, device=self.device)
            self._std = torch.tensor(spec.std, device=self.device)
        # the runtime flags (SCALARS) of every step, and their host values
        self._scalars = torch.zeros(len(SCALARS), device=self.device)
        self._scalar_values: Optional[Tuple[float, ...]] = None
        # the cyclic rolls' seed (static, as the flags) and the eval's counter
        self._seed = torch.zeros((), dtype=torch.int64, device=self.device)
        self._seed_value: Optional[int] = None
        self._eval_counter = torch.zeros((), dtype=torch.int32, device=self.device)
        self._graphs = (StepGraphs(spec.shape, self.device)
                        if self.device.type == "cuda" and not eager else None)

    # ---------- state and batches ----------

    @property
    def graphed(self) -> bool:
        """Does the train step replay CUDA graphs?"""
        return self._graphs is not None

    def init_state(self, generator: Optional[torch.Generator] = None) -> AttackState:
        """A fresh state; a mean/std spec draws its initial delta from
        `generator` (seeded 0 when None).  With a mesh, rank 0's delta on
        every rank (a collective: every rank calls it)."""
        delta = pert_lib.init_delta(self.spec, device=self.device, generator=generator)
        delta = mesh_lib.put_replicated(self.mesh, delta)
        return AttackState(delta, torch.zeros_like(delta), torch.zeros_like(delta), 0)

    def shard(self, batch: Dict) -> Dict:
        """This rank's slice of a global batch (the batch itself without a
        mesh), as the JAX engine's ``shard`` places it."""
        return mesh_lib.shard_batch(self.mesh, batch)

    def reset_delta(self, state: AttackState,
                    generator: Optional[torch.Generator] = None) -> AttackState:
        """Delta and the Adam moments drawn again, the step count 0 (the
        per-video sweep's re-init)."""
        return self.init_state(generator)

    def _packed_supported(self) -> bool:
        """Can batches take the packed input head?  (The JAX engine's
        ``_packed_supported``: a packed forward exists, the delta is the
        flickering one, and the cyclic and fused-kernel modes are off.)"""
        return (hasattr(self.model, "stem_params") and isinstance(self.spec, pert_lib.FlickerSpec)
                and self.config.norm_world == "tanh"
                and not self.config.use_pallas_fused and not self.config.enable_cyclic)

    def prepare_batch(self, batch: Dict) -> Tuple[torch.Tensor, bool, torch.Tensor]:
        """(clip on the device, packed?, labels int64).  packed: the uint8
        space-to-depth clip [B,T/2,H/2,W/2,24] of the input head, host-packed
        (``"video_packed"``) or packed here from a uint8 ``"video"``; else the
        ``"video"`` as it came, for the fused-kernel and generic paths."""
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        if "video_packed" in batch:
            if not self._packed_supported():
                raise ValueError(
                    "batch carries 'video_packed' but the engine cannot take the packed "
                    "path (needs a victim with a packed stem, a flickering delta, and the "
                    "cyclic and use_pallas_fused modes off)"
                )
            return torch.as_tensor(batch["video_packed"], device=self.device), True, labels
        video = torch.as_tensor(batch["video"], device=self.device)
        even = all(s % 2 == 0 for s in video.shape[1:4])
        if self._packed_supported() and video.dtype == torch.uint8 and even:
            return pack_input(video).contiguous(), True, labels
        return video, False, labels

    # ---------- forward pieces ----------

    def _write(self, buffer: torch.Tensor, values) -> None:
        """Host values into a static device buffer: through pinned memory and
        a copy on the current stream on CUDA, ordered after the steps before."""
        host = torch.tensor(values, dtype=buffer.dtype)
        if self.device.type == "cuda":
            host = host.pin_memory()
        buffer.copy_(host, non_blocking=True)

    def _step_scalars(self, flags: RuntimeFlags, seed: Optional[int] = 0) -> torch.Tensor:
        """The static device buffer of the runtime flags (SCALARS), and the
        rolls' seed beside it (kept when None), each rewritten only when a
        value changes."""
        values = tuple(float(getattr(flags, k)) for k in SCALARS)
        if values != self._scalar_values:
            self._write(self._scalars, values)
            self._scalar_values = values
        if seed is not None and int(seed) != self._seed_value:
            self._write(self._seed, int(seed))
            self._seed_value = int(seed)
        return self._scalars

    def _shifts(self, video: torch.Tensor, counter: torch.Tensor,
                seed: Optional[torch.Tensor] = None):
        """The cyclic rolls' (input, delta) shifts for this counter (and
        `seed`, the engine's when None; per slot [N] with a counter [N]), or
        None when the rolls are not compiled in."""
        if not self.config.enable_cyclic:
            return None
        seed = self._seed if seed is None else seed
        return pert_lib.roll_shifts(seed, counter, video.shape[1], self.spec.frames)

    def _applied_delta(self, delta: torch.Tensor) -> torch.Tensor:
        clipped = pert_lib.clip_delta(self.spec, delta)
        return clipped if self._mask is None else clipped * self._mask

    def _apply_model(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x)
        return out[0] if isinstance(out, tuple) else out  # I3D: (logits, endpoints)

    def _normalize(self, video: torch.Tensor) -> torch.Tensor:
        """uint8 -> x/128 - 1 (tanh) or (x/255 - mean)/std (mean/std), f32;
        a float clip is taken as [-1, 1] (tanh) or [0, 1] pixels (mean/std)."""
        if self.config.norm_world == "tanh":
            if video.dtype == torch.uint8:
                return video.float() / 128.0 - 1.0
            return video.float()
        x = video.float()
        if video.dtype == torch.uint8:
            x = x / 255.0
        return (x - self._mean) / self._std

    def _perturb(self, x: torch.Tensor, delta: torch.Tensor, scalars: torch.Tensor, shifts,
                 max_norm: Optional[torch.Tensor] = None):
        """The generic path's adversarial input from the normalized clip;
        `max_norm` (per slot) replaces the flags' in the mean/std world."""
        adv_flag = scalars[SCALARS.index("adv_flag")]
        cyclic_pert_flag = scalars[SCALARS.index("cyclic_pert_flag")]
        if self.config.norm_world == "meanstd":
            return pert_lib.apply_perturbation_torch_style(
                x, delta, self.spec, adv_flag=adv_flag,
                max_norm=scalars[SCALARS.index("max_norm")] if max_norm is None else max_norm,
                cyclic_pert_flag=cyclic_pert_flag,
                shift=None if shifts is None else shifts[1], std=self._std,
            )
        return pert_lib.apply_perturbation(
            x, delta, self.spec, adv_flag=adv_flag, mask=self._mask,
            cyclic_flag=scalars[SCALARS.index("cyclic_flag")],
            cyclic_pert_flag=cyclic_pert_flag, shifts=shifts,
        )

    def _reg_delta(self, delta: torch.Tensor, scalars: torch.Tensor,
                   max_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The delta the regularizers and metrics see: clipped to +-max_norm
        in the mean/std world (``regularize_clipped``), else raw.  A
        `max_norm` [N] clips slotted deltas [N, ...] each to its own."""
        if not self.config.regularize_clipped:
            return delta
        if max_norm is None:
            m = scalars[SCALARS.index("max_norm")]
        else:
            m = max_norm.reshape(max_norm.shape + (1,) * (delta.dim() - 1))
        return pert_lib.clip(delta, -m, m)

    def reg_delta(self, delta: torch.Tensor, flags: RuntimeFlags = RuntimeFlags()) -> torch.Tensor:
        """:meth:`_reg_delta` under `flags` (the epoch fit's perturbation)."""
        return self._reg_delta(delta, self._step_scalars(flags, None))

    def _logits(self, delta: Optional[torch.Tensor], video, packed: bool,
                scalars: torch.Tensor, counter: torch.Tensor, train: bool = False,
                max_norm: Optional[torch.Tensor] = None, seed: Optional[torch.Tensor] = None):
        """Logits of the (adversarial) clip.  delta=None is the clean forward.
        packed: clip/mask delta -> input head -> trunk (the clean forward
        goes through the same head with flag 0, delta 0).  Else the generic
        path (with the cyclic rolls of `counter` when they are compiled in);
        `train` with use_pallas_fused takes kernel B8 on uint8 (B8c with a
        slotted delta).  `scalars` is the static flag buffer (SCALARS'
        order).  A slotted delta [N, *spec.shape] perturbs clip i of the
        batch by delta[i], with per-slot `max_norm`, `seed` and `counter`
        [N]."""
        adv_flag = scalars[SCALARS.index("adv_flag")]
        if packed:
            if delta is None:
                clipped, flag = self._zero_delta, self._zero_flag
            else:
                clipped, flag = self._applied_delta(delta), adv_flag
            pk, mean, var, bias = self.model.stem_params()
            y = flicker_stem(
                video, clipped, flag, pk, mean, var, bias,
                self.spec.input_min, self.spec.input_max, self.model.compute_dtype,
            )
            return self.model.trunk(y)
        cfg = self.config
        if (train and cfg.use_pallas_fused and not cfg.enable_cyclic
                and video.dtype == torch.uint8):
            # B8; a slotted delta [N, T,1,1,C] takes its per-clip form B8c
            adv = fused_normalize_perturb(video, self._applied_delta(delta), adv_flag,
                                          self._fused_strict(video, delta))
            return self._apply_model(adv)
        x = self._normalize(video)
        if delta is not None:
            x = self._perturb(x, delta, scalars, self._shifts(video, counter, seed), max_norm)
        return self._apply_model(x)

    def _fused_strict(self, video: torch.Tensor, delta: torch.Tensor) -> bool:
        """B8's clip rule for this batch: the strict mask where the JAX call
        on the same data takes its Pallas kernel, ``jnp.clip``'s elsewhere
        (``ops/fused_apply.strict_rule``).  The JAX step sees the global
        batch (jitted over the mesh's shardings), so a rank's B times the
        world; the JAX sweep's vmapped call one clip, whatever the slots.
        Taken from shapes alone, so a graph captures one rule."""
        if delta.dim() == video.dim():  # a delta a slot
            b = 1
        else:
            b = video.shape[0] * (1 if self.mesh is None else self.mesh.world)
        return strict_rule((b,) + tuple(video.shape[1:]))

    def _loss_terms(self, delta, video, packed, labels, scalars: torch.Tensor,
                    step: torch.Tensor, slots=None):
        """(total, terms) of the train step; the flags are the device
        scalars `scalars` (SCALARS' order), never host values, and `step`
        the device count of the steps taken.  `slots` = (max_norm [N] f32,
        seeds [N]) makes them the slot step's: delta [N, *spec.shape], clip i
        of the batch a slot's, `step` [N], and every term [N]."""
        max_norm, seed = (None, None) if slots is None else slots
        logits = self._logits(delta, video, packed, scalars, step + 1, train=True,
                              max_norm=max_norm, seed=seed)
        reg_delta = self._reg_delta(delta, scalars, max_norm)
        if slots is None:
            return self._terms(logits, labels, reg_delta, scalars)
        return self._slot_terms(logits, labels, reg_delta, scalars)

    def _terms(self, logits, labels, reg_delta, scalars: torch.Tensor):
        """(total, terms) of a batch's logits and the delta the regularizers
        see."""
        cfg = self.config
        _, beta0, beta1, beta2, beta3 = scalars.unbind()[:5]
        adv_total, aux = losses_lib.adversarial_loss(
            logits, labels, improve_loss=cfg.improve_loss, margin=cfg.margin,
            targeted=cfg.targeted, use_logits=cfg.use_logits,
        )
        norm_r = reg_lib.thinness_reg(reg_delta)
        diff_r = reg_lib.first_order_diff_reg(reg_delta)
        lap_r = reg_lib.second_order_diff_reg(reg_delta)
        l12_r = reg_lib.l12_regularizer(reg_delta)
        if cfg.attack_kind == "sparse":
            reg = beta1 * l12_r
        elif cfg.reg_weighting == "torch":
            reg = beta1 * norm_r + (1.0 - beta1) * (diff_r + lap_r)
        else:
            reg = beta1 * norm_r + beta2 * diff_r + beta3 * lap_r
        weighted = beta0 * reg
        total = adv_total + weighted
        terms = {
            "adv_loss": adv_total,
            "reg_loss": reg,
            "weighted_reg": weighted,
            "l12": l12_r,
            "norm_reg": norm_r,
            "diff_norm_reg": diff_r,
            "laplacian_norm_reg": lap_r,
            "prob_to_min": aux["prob_to_min"].mean(),
            "prob_to_max": aux["prob_to_max"].mean(),
            "probs": aux["probs"],
        }
        return total, terms

    def _slot_terms(self, logits, labels, reg_delta, scalars: torch.Tensor):
        """:meth:`_terms` of each slot, vmapped as the JAX sweep vmaps its
        per-clip step: slot i's clip a batch of one (logits[i], labels[i])
        and its own delta reg_delta[i]; every term [N], probs [N, K]."""
        total, terms = torch.func.vmap(self._terms, in_dims=(0, 0, 0, None))(
            logits[:, None], labels[:, None], reg_delta, scalars)
        terms["probs"] = terms["probs"][:, 0]
        return total, terms

    # ---------- steps ----------

    @staticmethod
    def _adam(delta, mu, nu, step, grad, lr):
        """optax.adam on device tensors: `step` (int32, 0-d; or [N], a count
        a slot of deltas [N, ...]) counts the steps taken; its increment gives
        the bias corrections 1 - b**count in f32."""
        count = step + 1
        t = count.float()
        if count.dim():  # a count a slot, broadcast over the slot's delta
            t = t.reshape(count.shape + (1,) * (delta.dim() - 1))
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * nu
        mu_hat = mu / (1 - torch.pow(ADAM_B1, t))
        nu_hat = nu / (1 - torch.pow(ADAM_B2, t))
        update = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return delta + update, mu, nu, count

    def _step(self, delta, mu, nu, step, video, packed, labels, scalars):
        """One optimizer step on device tensors, the body the eager step runs
        and the CUDA graph captures: ((delta, mu, nu, step) after it, the
        metrics, all tensors)."""
        d = delta.detach().requires_grad_(True)
        total, terms = self._loss_terms(d, video, packed, labels, scalars, step)
        if self.mesh is not None:
            total = self._rank_loss(terms)
        (grad,) = torch.autograd.grad(total, d)
        with torch.no_grad():
            probs = terms.pop("probs").detach()
            fooled = metrics_lib.is_adversarial(
                probs, labels, targeted=self.config.targeted,
                target_class=self.config.target_class,
            )
            if self.mesh is not None:
                grad, total, probs, fooled = self._reduce(grad, terms, probs, fooled)
            new = self._adam(delta, mu, nu, step, grad, scalars[SCALARS.index("learning_rate")])
            metric_delta = self._reg_delta(delta, scalars)
            metrics = {
                "total_loss": total.detach(),
                "thickness": metrics_lib.thickness(metric_delta),
                "roughness": metrics_lib.roughness(metric_delta),
                "delta_max": delta.max(),
                "delta_min": delta.min(),
                "is_adversarial": fooled,
                **{k: v.detach() for k, v in terms.items()},
            }
            if self.track_probs:
                metrics["probs"] = probs
        return new, metrics

    def _rank_loss(self, terms) -> torch.Tensor:
        """What this rank's backward runs on: its share of the global
        batch's adversarial term (the hinge's sum over its clips; CE's mean
        over them over W), and on rank 0 alone the weighted regularizers of
        the replicated delta.  Sets ``terms["adv_loss"]`` to the share."""
        adv = terms["adv_loss"]
        if losses_lib.batch_reduction(self.config.improve_loss) == "mean":
            adv = adv / self.mesh.world
        terms["adv_loss"] = adv
        return adv + terms["weighted_reg"] if self.mesh.rank == 0 else adv

    def _reduce(self, grad, terms, probs, fooled):
        """Sum over the ranks, in one collective, d(delta), the adversarial
        term's shares, the prob_to_* means over W, the clips not fooled, and
        each rank's probabilities in its own rows of [W*b, K]: (d(delta), the
        global total loss, the global probabilities, fooled on every rank);
        ``terms`` takes the global adv_loss and prob_to_* means."""
        w, r = self.mesh.world, self.mesh.rank
        n = grad.numel()
        rows = probs.new_zeros((w,) + tuple(probs.shape))
        rows[r] = probs
        stats = torch.stack([terms["adv_loss"].detach(), terms["prob_to_min"] / w,
                             terms["prob_to_max"] / w, (~fooled).float()])
        buf = mesh_lib.all_reduce(self.mesh, torch.cat(
            [grad.reshape(-1), stats, rows.reshape(-1)]))
        adv, to_min, to_max, not_fooled = buf[n:n + 4].unbind()
        terms.update(adv_loss=adv, prob_to_min=to_min, prob_to_max=to_max)
        return (buf[:n].view_as(grad), adv + terms["weighted_reg"],
                buf[n + 4:].view(w * probs.shape[0], probs.shape[1]), not_fooled == 0)

    def _slot_step(self, delta, mu, nu, count, video, packed, labels, scalars, max_norm, seeds,
                   active):
        """One step of N slots (the vectorized sweep's; the JAX sweep's
        vmapped ``_per_clip_step``): delta, mu, nu [N, *spec.shape], `count`
        [N] int32 (Adam's, never reset), clips `video` [N, ...] (packed or
        not) and `labels` [N], `max_norm` [N] f32, `seeds` [N] int64 (the
        rolls'), `active` [N] bool.  Returns ((delta, mu, nu, count) after
        it, an inactive slot's unchanged, and the per-slot metrics [N] of
        the pre-update delta), all tensors."""
        d = delta.detach().requires_grad_(True)
        total, terms = self._loss_terms(d, video, packed, labels, scalars, count,
                                        slots=(max_norm, seeds))
        (grad,) = torch.autograd.grad(total.sum(), d)
        with torch.no_grad():
            new = self._adam(delta, mu, nu, count, grad, scalars[SCALARS.index("learning_rate")])
            keep = active.reshape(active.shape + (1,) * (delta.dim() - 1))
            new = tuple(torch.where(keep if n.dim() > 1 else active, n, old)
                        for n, old in zip(new, (delta, mu, nu, count)))
            probs = terms.pop("probs").detach()
            metric_delta = self._reg_delta(delta, scalars, max_norm)
            metrics = {
                "total_loss": total.detach(),
                "thickness": torch.func.vmap(metrics_lib.thickness)(metric_delta),
                "roughness": torch.func.vmap(metrics_lib.roughness)(metric_delta),
                "is_adversarial": torch.func.vmap(partial(
                    metrics_lib.is_adversarial, targeted=self.config.targeted,
                    target_class=self.config.target_class,
                ))(probs[:, None], labels[:, None]),
                **{k: v.detach() for k, v in terms.items()},
            }
            if self.track_probs:
                metrics["probs"] = probs
        return new, metrics

    def _train_eval(self, delta, mu, nu, step, video, packed, labels, scalars):
        """The step body of ``train_eval_step``: :meth:`_step`, then the clean
        forward of the same batch and the fooling counters (miss, valid) of
        the step's adversarial probabilities against it."""
        if not self.track_probs:
            raise ValueError("train_eval_step requires track_probs=True")
        new, metrics = self._step(delta, mu, nu, step, video, packed, labels, scalars)
        with torch.no_grad():
            clean = torch.softmax(
                self._logits(None, video, packed, scalars, self._eval_counter), dim=-1)
            adv = metrics["probs"]
            if self.mesh is not None:  # this rank's rows of the global probabilities
                b = labels.shape[0]
                adv = adv[self.mesh.rank * b:(self.mesh.rank + 1) * b]
            counts = metrics_lib.fooling_counts(
                adv, clean, labels, targeted=self.config.targeted,
                target_class=self.config.target_class,
                exclude_misclassify=self.config.exclude_misclassify,
            )
            if self.mesh is not None:
                counts = mesh_lib.all_reduce(self.mesh, torch.stack(counts)).unbind()
            metrics["miss"], metrics["valid"] = counts
        return new, metrics

    def _eager(self, body, state: AttackState, video, packed, labels, flags: RuntimeFlags,
               seed: int = 0):
        scalars = self._step_scalars(flags, seed)
        step = torch.full((), state.step, dtype=torch.int32, device=self.device)
        (delta, mu, nu, _), metrics = body(
            state.delta, state.mu, state.nu, step, video, packed, labels, scalars)
        metrics["step"] = state.step
        return AttackState(delta, mu, nu, state.step + 1), metrics

    def _train_step(self, state: AttackState, video, packed, labels, flags: RuntimeFlags,
                    seed: int = 0):
        """One eager step: the CPU's, and the reference a graphed step is
        held to on the card."""
        return self._eager(self._step, state, video, packed, labels, flags, seed)

    def _train_eval_step(self, state: AttackState, video, packed, labels, flags: RuntimeFlags,
                         seed: int = 0):
        """One eager ``train_eval_step`` (the graphed one's reference)."""
        return self._eager(self._train_eval, state, video, packed, labels, flags, seed)

    def _steps(self, state, batch, flags, n, with_metrics, seed, kind="train"):
        body = self._train_eval if kind == "train_eval" else self._step
        video, packed, labels = self.prepare_batch(batch)
        if self._graphs is not None:
            self._step_scalars(flags, seed)
            return self._graphs.run(
                lambda *args: body(*args, self._scalars), state, video, packed, labels,
                n, with_metrics, kind)
        metrics = None
        for _ in range(n):
            state, metrics = self._eager(body, state, video, packed, labels, flags, seed)
        return state, metrics

    def train_step(
        self, state: AttackState, batch: Dict, flags: RuntimeFlags = RuntimeFlags(),
        seed: int = 0,
    ) -> Tuple[AttackState, Dict[str, torch.Tensor]]:
        """One optimizer step (a graph replay on CUDA, which donates `state`).
        `seed` and the state's step draw the cyclic rolls' shifts."""
        return self._steps(state, batch, flags, 1, True, seed)

    def train_steps(
        self, state: AttackState, batch: Dict, flags: RuntimeFlags = RuntimeFlags(), n: int = 1,
        seed: int = 0,
    ) -> AttackState:
        """n optimizer steps on one batch (the batch is moved once; on CUDA n
        replays of one graph, the counterpart of the JAX engine's lax.scan),
        equal to n ``train_step`` calls (each step draws its rolls from its
        own count; the JAX scan reuses one key)."""
        return self._steps(state, batch, flags, n, False, seed)[0]

    def train_eval_step(
        self, state: AttackState, batch: Dict, flags: RuntimeFlags = RuntimeFlags(),
        seed: int = 0,
    ) -> Tuple[AttackState, Dict[str, torch.Tensor]]:
        """One optimizer step and the batch's fooling counters (``miss``,
        ``valid``: the step's adversarial probabilities, on the pre-update
        delta, against the clean forward) in one program: a graph of its own
        on CUDA (donating `state`).  Needs ``track_probs``."""
        return self._steps(state, batch, flags, 1, True, seed, "train_eval")

    def graph_stats(self) -> Dict[tuple, Dict[str, float]]:
        """Each step graph's pool bytes and capture seconds, by (clip shape,
        clip dtype, packed?, labels shape, 'train' | 'train_eval'); empty
        without graphs."""
        return {} if self._graphs is None else self._graphs.stats()

    @torch.no_grad()
    def eval_step(
        self, delta: torch.Tensor, batch: Dict, flags: RuntimeFlags = RuntimeFlags(),
        seed: int = 0,
    ) -> Dict[str, torch.Tensor]:
        video, packed, labels = self.prepare_batch(batch)
        delta = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        scalars, counter = self._step_scalars(flags, seed), self._eval_counter
        adv_probs = torch.softmax(self._logits(delta, video, packed, scalars, counter), dim=-1)
        clean_probs = torch.softmax(self._logits(None, video, packed, scalars, counter), dim=-1)
        miss, valid = metrics_lib.fooling_counts(
            adv_probs, clean_probs, labels, targeted=self.config.targeted,
            target_class=self.config.target_class,
            exclude_misclassify=self.config.exclude_misclassify,
        )
        return {"miss": miss, "valid": valid, "adv_probs": adv_probs, "clean_probs": clean_probs}

    @torch.no_grad()
    def forward(
        self, delta: torch.Tensor, batch: Dict, flags: RuntimeFlags = RuntimeFlags(),
        adversarial: bool = True, seed: int = 0,
    ) -> torch.Tensor:
        video, packed, _ = self.prepare_batch(batch)
        if adversarial:
            delta = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        logits = self._logits(delta if adversarial else None, video, packed,
                              self._step_scalars(flags, seed), self._eval_counter)
        return torch.softmax(logits, dim=-1)

    @torch.no_grad()
    def adversarial_video(
        self, delta: torch.Tensor, batch: Dict, flags: RuntimeFlags = RuntimeFlags()
    ) -> torch.Tensor:
        """The adversarial clip itself (the result dict's ``adv_video``): the
        normalized ``"video"`` plus the clipped (and frame-masked) delta,
        clipped to the input range (mean/std: to +-max_norm, over std, to
        the scalar range); no rolls (the JAX engine's call gives no key)."""
        x = self._normalize(torch.as_tensor(batch["video"], device=self.device))
        delta = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        return self._perturb(x, delta, self._step_scalars(flags, None), None)
