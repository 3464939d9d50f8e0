"""Shared runner plumbing: victim construction + engine wiring from config.

Port of the JAX package's ``runners/common.py`` on one device, for I3D (the
tanh world) and the four video ResNets (the mean/std world: r3d_18, mc3_18,
r2plus1d_18, r2plus1d_34).  An I3D checkpoint is a DeepMind TF checkpoint
(its prefix; converted on load by the port's own bundle reader, no
TensorFlow), a ``.msgpack`` of the JAX I3D's Flax variables (the JAX
package's weight file; read by the port's own codec) or a ``.pt`` state
dict that ``convert.cli`` wrote; a video ResNet's is a torchvision state
dict (``.pt``/``.pth``) or a ``.msgpack`` of the JAX VideoResNet's
variables.  A missing one gives seeded random weights with a loud warning
(the attack machinery is weight-agnostic).
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch

from ..attack import FlickerSpec, SparseSpec, TorchStyleFlickerSpec
from ..convert import EVAL_TYPES, init_i3d_state, load_weights, video_resnet_state_dict
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
    """The head width present in a state dict (checkpoint truth: I3D's
    logits bias, a video ResNet's ``fc.weight``, as the ig65m r2plus1d_34
    heads of 359/487 classes), else `default`, else the registry's."""
    state = state or {}
    head = (state.get("fc.weight") if model_name != "i3d"
            else state.get("Logits.Conv3d_0c_1x1.conv_3d.bias"))
    if head is not None:
        return int(head.shape[0])
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

    `ckpt_path`, for I3D, is a DeepMind TF checkpoint prefix (converted on
    load, convert/tf_i3d.py), a ``.msgpack`` of Flax variables
    (convert/flax_i3d.py) or a ``.pt`` state dict (convert.cli);
    eval_type='rgb600' selects the Kinetics-600 world: prefix-less
    checkpoint names and a 600-way head.  For a video ResNet it is a
    torchvision ``.pt``/``.pth`` (convert/torch_video_resnet.py) or a
    ``.msgpack`` (convert/flax_video_resnet.py).  The head is as wide as
    `num_classes`, else as the checkpoint's.  Only when no file exists at
    `ckpt_path` do the weights come from seed 0, with a loud warning.
    `pair_pools` (I3D only): see :func:`pair_pools_from_env`."""
    if eval_type not in EVAL_TYPES:
        raise ValueError(f"EVAL_TYPE {eval_type!r}: choose from {EVAL_TYPES}")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"MODEL_NAME {model_name!r}: choose from {sorted(MODEL_REGISTRY)}")
    state = None
    if ckpt_path and (os.path.exists(ckpt_path) or os.path.exists(ckpt_path + ".index")):
        state = load_weights(ckpt_path, eval_type=eval_type, model_name=model_name)
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
        if model_name == "i3d":
            state = init_i3d_state(0, num_classes)
        else:
            state = {k: torch.from_numpy(v)
                     for k, v in video_resnet_state_dict(model_name, num_classes, 0).items()}
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
    """AttackEngine + label list from run_config.yml sections.  attack_kind
    'sparse' gives the L1,2 attack's full delta (``SparseSpec`` of the clip's
    frames x size x size; for a video ResNet a full ``TorchStyleFlickerSpec``);
    either cyclic key compiles the rolls in.  A video ResNet
    (``MODEL_NAME`` r3d_18, mc3_18, r2plus1d_18, r2plus1d_34) attacks in the
    mean/std world: ``TorchStyleFlickerSpec(max_norm=L_INF_NORM)``, the
    torch weighting of the regularizers, and no frame window (the engine
    refuses ``ATTACK_FRAME_WINDOW``, as the JAX engine)."""
    model_name = attack_cfg.get("MODEL_NAME", "i3d")
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"MODEL_NAME {model_name!r}: choose from {sorted(MODEL_REGISTRY)}")
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
        pair_pools=pair_pools_from_env() if model_name == "i3d" else (),
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
        attack_kind=attack_kind,
        norm_world=reg.norm_world,
        reg_weighting="tf" if reg.norm_world == "tanh" else "torch",
        target_class=target_class,
        use_pallas_fused=bool(attack_cfg.get("USE_PALLAS_FUSED", False)),
        frame_window=frame_window,
        enable_cyclic=bool(attack_cfg.get("CYCLIC_ATTACK", False)
                           or attack_cfg.get("CYCLIC_PERTURBATION_ATTACK", False)),
    )
    if reg.norm_world == "meanstd":
        hw = size if attack_kind == "sparse" else 1
        spec = TorchStyleFlickerSpec(frames=frames, height=hw, width=hw,
                                     max_norm=float(attack_cfg.get("L_INF_NORM", 1.0)))
    elif attack_kind == "sparse":
        spec = SparseSpec(frames=frames, height=size, width=size)
    else:
        spec = FlickerSpec(frames=frames)
    engine = AttackEngine(model, spec, cfg, track_probs=track_probs)
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
    packed path exists and the geometry is even; with USE_PALLAS_FUSED, the
    sparse attack or the cyclic modes the packed path is off and the
    pipeline delivers unpacked uint8 clips, as at an odd frame count or size
    or in the mean/std world (a video ResNet has no packed input head).  The
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
