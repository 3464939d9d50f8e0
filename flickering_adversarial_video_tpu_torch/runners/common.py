"""Shared runner plumbing: victim construction + engine wiring from config.

Port of the JAX package's ``runners/common.py`` for the I3D victim on one
device.  A checkpoint is a DeepMind TF checkpoint (its prefix; converted on
load by the port's own bundle reader, no TensorFlow) or a ``.pt`` state dict
that ``convert.cli`` wrote; a missing one gives seeded random weights with a
loud warning (the attack machinery is weight-agnostic).
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from ..attack import FlickerSpec
from ..convert import EVAL_TYPES, init_i3d_state, load_weights
from ..engine import AttackConfig, AttackEngine
from ..models.registry import MODEL_REGISTRY, create_model
from ..utils.labels import load_label_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pair_pools_from_env(environ: Optional[Mapping[str, str]] = None) -> Tuple[str, ...]:
    """The I3D pools routed through the index pair (kernel B9), from the JAX
    package's own switches (its ``ops/maxpool.py``): ``FLICKER_POOL_PALLAS_2A=2``
    selects the pair for MaxPool3d_2a (C=64), and ``FLICKER_POOL_PALLAS_3A``
    other than 0 extends it to MaxPool3d_3a.  Read here, once per engine, and
    nowhere deeper."""
    environ = os.environ if environ is None else environ
    if environ.get("FLICKER_POOL_PALLAS_2A", "1") != "2":
        return ()
    if environ.get("FLICKER_POOL_PALLAS_3A", "0") == "0":
        return ("MaxPool3d_2a_3x3",)
    return ("MaxPool3d_2a_3x3", "MaxPool3d_3a_3x3")


def infer_num_classes(state: Optional[Mapping[str, Any]], model_name: str,
                      default: Optional[int] = None) -> int:
    """The head width present in a state dict (checkpoint truth), else
    `default`, else the registry's."""
    bias = (state or {}).get("Logits.Conv3d_0c_1x1.conv_3d.bias")
    if bias is not None:
        return int(bias.shape[0])
    return default or MODEL_REGISTRY[model_name].num_classes


def build_victim(
    model_name: str,
    ckpt_path: Optional[str],
    compute_dtype,
    frames: int,
    size: int,
    num_classes: Optional[int] = None,
    eval_type: str = "rgb",
    device=None,
    pair_pools: Sequence[str] = (),
) -> torch.nn.Module:
    """The frozen victim on `device` (CUDA unless told otherwise).

    `ckpt_path` is a DeepMind TF checkpoint prefix (converted on load,
    convert/tf_i3d.py) or a ``.pt`` state dict (convert.cli); a ``.msgpack``
    raises.  eval_type='rgb600' selects the Kinetics-600 world: prefix-less
    checkpoint names and a 600-way head.  The head is as wide as
    `num_classes`, else as the checkpoint's.  Only when no file exists at
    `ckpt_path` do the weights come from seed 0, with a loud warning.
    `pair_pools`: see :func:`pair_pools_from_env`."""
    if eval_type not in EVAL_TYPES:
        raise ValueError(f"EVAL_TYPE {eval_type!r}: choose from {EVAL_TYPES}")
    state = None
    if ckpt_path and (os.path.exists(ckpt_path) or os.path.exists(ckpt_path + ".index")):
        state = load_weights(ckpt_path, eval_type=eval_type)
    num_classes = num_classes or infer_num_classes(
        state, model_name, 600 if eval_type == "rgb600" else None)
    model, _ = create_model(
        model_name, num_classes=num_classes, compute_dtype=compute_dtype, device=device,
        pair_pools=pair_pools,
    )
    if state is None:
        print(
            f"[warn] no checkpoint for {model_name} at {ckpt_path!r}; "
            "using random init (attack mechanics only, no meaningful victims)"
        )
        state = init_i3d_state(0, num_classes)
    model.load_state_dict(state)
    return model


def build_engine(
    attack_cfg,
    model_cfg,
    *,
    frames: Optional[int] = None,
    size: Optional[int] = None,
    attack_kind: str = "flickering",
    track_probs: bool = True,
    device=None,
) -> Tuple[AttackEngine, List[str]]:
    """AttackEngine + label list from run_config.yml sections."""
    if attack_kind != "flickering":
        raise NotImplementedError(
            f"attack_kind {attack_kind!r}: the L1,2 sparse attack is ROADMAP.md queue A item 9"
        )
    if attack_cfg.get("CYCLIC_ATTACK", False) or attack_cfg.get("CYCLIC_PERTURBATION_ATTACK", False):
        raise NotImplementedError("the cyclic attack modes are ROADMAP.md queue A item 5")
    model_name = attack_cfg.get("MODEL_NAME", "i3d")
    if model_name not in MODEL_REGISTRY:
        raise NotImplementedError(f"MODEL_NAME {model_name!r}: only 'i3d' is ported")
    reg = MODEL_REGISTRY[model_name]
    frames = frames or reg.default_frames
    size = size or reg.default_size
    compute_dtype = _DTYPES[attack_cfg.get("COMPUTE_DTYPE", "bfloat16")]
    num_classes = model_cfg.get("NUM_CLASSES")

    model = build_victim(
        model_name,
        model_cfg.get("CKPT_PATH"),
        compute_dtype,
        frames,
        size,
        num_classes=num_classes,
        eval_type=model_cfg.get("EVAL_TYPE", "rgb"),
        device=device,
        pair_pools=pair_pools_from_env(),
    )

    labels = load_label_map(
        model_cfg.get("LABEL_MAP_PATH"),
        num_classes=getattr(model, "num_classes", None) or num_classes or reg.num_classes,
    )
    targeted = bool(attack_cfg.get("TARGETED_ATTACK", False))
    target_class = labels.index(attack_cfg.get("TARGETED_CLASS")) if targeted else None

    frame_window = attack_cfg.get("ATTACK_FRAME_WINDOW")
    if frame_window is not None:
        frame_window = (int(frame_window[0]), int(frame_window[1]))

    cfg = AttackConfig(
        improve_loss=bool(attack_cfg.get("IMPROVE_ADV_LOSS", True)),
        margin=float(attack_cfg.get("PROB_MARGIN", 0.05)),
        targeted=targeted,
        use_logits=bool(attack_cfg.get("USE_LOGITS", False)),
        reg_weighting="tf",
        target_class=target_class,
        use_pallas_fused=bool(attack_cfg.get("USE_PALLAS_FUSED", False)),
        frame_window=frame_window,
    )
    engine = AttackEngine(model, FlickerSpec(frames=frames), cfg, track_probs=track_probs)
    return engine, labels


def make_shard_batches(
    attack_cfg,
    engine: AttackEngine,
    tfrecord_batches_fn,
    *,
    frames: int,
    size: Optional[int],
    batch_size: int,
):
    """(batches_fn, prepack): the tfrecord-pipeline factory of the
    universal/class-gen runners.

    Host-prepacked input defaults on (PREPACK_INPUT) whenever the engine's
    packed path exists and the geometry is even; with USE_PALLAS_FUSED the
    packed path is off and the pipeline delivers unpacked uint8 clips.  The
    shards are read by the native reader (the pipeline's default), into
    pinned buffers when the engine is on CUDA.

    `tfrecord_batches_fn` is passed in (the runner's module-level symbol) so
    tests can monkeypatch it per runner."""
    size_eff = size or 224
    prepack = (
        bool(attack_cfg.get("PREPACK_INPUT", True))
        and engine._packed_supported()
        and frames % 2 == 0
        and size_eff % 2 == 0
    )
    if prepack:
        print("input pipeline: host-prepacked space-to-depth uint8")

    def batches(shards):
        return tfrecord_batches_fn(
            shards, batch_size, frames=frames, height=size_eff,
            width=size_eff, prepack=prepack, pin_memory=engine.device.type == "cuda",
        )

    return batches, prepack
