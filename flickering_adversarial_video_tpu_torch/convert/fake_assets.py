"""Synthetic stand-ins for the reference's victim assets (the rehearsal set).

The port's own copy of the JAX package's ``convert/fake_assets.py``: files
in the real assets' formats, so that a script chain can be rehearsed end to
end before it meets the true DeepMind I3D checkpoint (reference
download_ckpt_and_data.sh:1-11, restore at kinetics_i3d_utils.py:41-62) and
the torchvision/ig65m .pth files (utils_cv/action_recognition/model.py:402-441):

  * ``i3d_var_map`` / ``write_i3d_saver_checkpoint``: a state dict of the
    port's InceptionI3D under the DeepMind checkpoint's variable names and
    layouts (the inverse of ``convert/tf_i3d.convert_i3d_var_map``), and a
    TF1 Saver checkpoint of it (TensorFlow, imported when called: a host
    tool);
  * ``video_resnet_state_dict`` / ``write_torchvision_pth``: a seeded
    torchvision ``video_resnet`` state dict, and a ``.pth`` of it;
  * ``write_npy_clips``: ``rgb_<vid>@<class>.npy`` clips for the
    single-video driver, named with the victim's own clean prediction when a
    ``predict_fn`` is given; ``write_tfrecord_shards``: uint8-schema shards
    for the universal driver (numpy only: the same bytes as the JAX
    package's for the same seed and ``predict_fn``);
  * ``fabricate`` / ``main``: the whole set under one directory, the clips
    labelled by the port's own InceptionI3D in f32 on the given device.

``python -m flickering_adversarial_video_tpu_torch.convert.fake_assets DATA_DIR
[--frames 8] [--size 32] [--device cpu]``.  chip_smoke.py makes its
real-victim weights with the state-dict functions (no TensorFlow there).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

_SONNET_STAT_LAYOUT = (1, 1, 1, 1)  # moving stats are [1,1,1,1,C] in the ckpt
_LEAF = {"weight": "w", "running_mean": "moving_mean", "running_var": "moving_variance"}


def i3d_var_map(state: Mapping[str, torch.Tensor], bare_names: bool = False) -> Dict[str, np.ndarray]:
    """The reference checkpoint's names (``RGB/inception_i3d/<module>/{w,b,
    beta,moving_*}``) holding the state dict's values, so that the converted
    state round-trips exactly: OIDHW kernels as DHWIO, BN statistics as
    [1,1,1,1,C].

    bare_names=True gives the Kinetics-600 checkpoints' prefix-less names."""
    prefix = "" if bare_names else "RGB/inception_i3d/"
    var_map: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, op, leaf = key.split(".")
        value = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            value = value.transpose(2, 3, 4, 1, 0)
        elif leaf in ("running_mean", "running_var"):
            value = value.reshape(_SONNET_STAT_LAYOUT + value.shape)
        name = _LEAF.get(leaf, "beta" if op == "batch_norm" else "b")
        var_map[f"{prefix}{'/'.join(modules)}/{op}/{name}"] = np.ascontiguousarray(value)
    return var_map


def video_resnet_state_dict(variant: str, num_classes: int = 400, seed: int = 0) -> Dict[str, np.ndarray]:
    """A torchvision-layout state dict (numpy) of `variant` from a numpy
    seed: conv kernels He-normal (std sqrt(2 / fan_in)), BN scale and
    variance in [0.5, 1.5), BN bias and mean N(0, 0.1), ``fc`` N(0, 0.001)
    with a zero bias (the features grow to ~20-30 by layer4 without trained
    statistics; this keeps the logits near unit scale, so the softmax does
    not saturate and an attack has a gradient); ``num_batches_tracked`` 0.  The JAX package's
    counterpart inverts its converter over a Flax init; the port draws its
    own (the card has no JAX)."""
    from ..models.video_resnet import state_shapes

    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for key, shape in state_shapes(variant, num_classes).items():
        leaf = key.rsplit(".", 1)[1]
        if key.startswith("fc."):
            v = rng.normal(0, 0.001, shape) if leaf == "weight" else np.zeros(shape)
        elif leaf == "num_batches_tracked":
            sd[key] = np.asarray(0, np.int64)
            continue
        elif len(shape) == 5:
            v = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif leaf in ("weight", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        sd[key] = v.astype(np.float32)
    return sd


def write_torchvision_pth(path: str, variant: str, num_classes: int = 400, seed: int = 0) -> str:
    """``torch.save`` of :func:`video_resnet_state_dict` (torch tensors), as
    torchvision's ``model.state_dict()`` would be saved."""
    sd = video_resnet_state_dict(variant, num_classes=num_classes, seed=seed)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def write_i3d_saver_checkpoint(
    ckpt_prefix: str,
    num_classes: int = 400,
    seed: int = 0,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    eval_type: str = "rgb",
) -> str:
    """A DeepMind-layout TF checkpoint at `ckpt_prefix` of `state` (the
    port's InceptionI3D state dict; ``init_i3d_state(seed, num_classes)``
    when None).  eval_type="rgb600" writes the Kinetics-600 layout: prefix-less
    variable names (kinetics_i3d_utils.py:47-56)."""
    import tensorflow as tf

    from .flax_i3d import init_i3d_state

    if state is None:
        state = init_i3d_state(seed, num_classes)
    var_map = i3d_var_map(state, bare_names=eval_type == "rgb600")
    os.makedirs(os.path.dirname(ckpt_prefix), exist_ok=True)
    g = tf.Graph()
    with g.as_default():
        tf_vars = [
            tf.compat.v1.get_variable(name, initializer=value)
            for name, value in var_map.items()
        ]
        saver = tf.compat.v1.train.Saver(var_list=tf_vars)
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, ckpt_prefix)
    return ckpt_prefix


def write_npy_clips(
    npy_dir: str,
    class_names: List[str],
    *,
    frames: int = 90,
    size: int = 224,
    seed: int = 0,
    predict_fn=None,
    candidates: int = 24,
) -> List[str]:
    """One `rgb_fakeN@<class>.npy` clip (f32 in [-1,1]) per class name.

    With `predict_fn` (a numpy clip [T,H,W,3] -> logits) the class in each
    filename is the victim's OWN clean prediction: the single-video driver
    skips clean-misclassified clips (i3d_adversarial_main_single_video_npy.py
    :137-139), and a random-weight victim misclassifies a randomly labelled
    clip with probability ~399/400.  Per slot, `candidates` random clips are
    tried and the one with the largest top1-top2 logit margin wins, so that
    the runner's own forward reproduces the argmax."""
    from ..data.npy import save_npy_clip
    from ..utils.labels import load_label_map

    os.makedirs(npy_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    label_names = load_label_map(None) if predict_fn is not None else None
    paths = []
    for i, cls in enumerate(class_names):
        best = None
        for _ in range(candidates if predict_fn is not None else 1):
            u8 = rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8)
            clip = u8.astype(np.float32) / 128.0 - 1.0
            if predict_fn is None:
                best = (0.0, clip, cls)
                break
            logits = np.asarray(predict_fn(clip), np.float32).reshape(-1)
            order = np.argsort(-logits, kind="stable")
            margin = float(logits[order[0]] - logits[order[1]])
            if best is None or margin > best[0]:
                best = (margin, clip, label_names[order[0]])
        margin, clip, cls_name = best
        if predict_fn is not None and margin < 1e-4:
            print(
                f"[fake_assets] warn: clip {i} best top1-top2 margin {margin:.2e} "
                "is tiny; the runner's forward may flip the argmax"
            )
        p = os.path.join(npy_dir, f"rgb_fake{i}@{cls_name.replace(' ', '_')}.npy")
        save_npy_clip(p, clip)
        paths.append(p)
    return paths


def write_tfrecord_shards(
    out_dir: str,
    *,
    n_shards: int = 2,
    per_shard: int = 4,
    frames: int = 90,
    size: int = 224,
    num_classes: int = 400,
    seed: int = 0,
) -> List[str]:
    """uint8-schema shards named like the shuffled all-class writer's."""
    from ..data.tfrecord import TFRecordWriter, make_uint8_example

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    shards = []
    for s in range(n_shards):
        path = os.path.join(out_dir, f"all_cls_{s:04d}.tfrecords")
        with TFRecordWriter(path) as w:
            for _ in range(per_shard):
                video = rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8)
                label = int(rng.integers(0, num_classes))
                w.write(make_uint8_example(video, label))
        shards.append(path)
    return shards


def fabricate(
    data_dir: str,
    *,
    frames: int = 8,
    size: int = 32,
    npy_classes: Optional[List[str]] = None,
    torch_variants=("r3d_18", "mc3_18", "r2plus1d_18"),
    device=None,
) -> Dict[str, object]:
    """Everything scripts/real_weight_parity.sh consumes, under `data_dir`.

    Rehearsal geometry is tiny but structurally faithful: every variable
    name, layout transform, schema and filename convention matches the real
    assets; only shapes (T, S) and weight values differ.  The npy clips are
    labelled with the clean predictions of the port's InceptionI3D (400
    classes, f32, the checkpoint's weights) on `device`: the card unless
    ``device="cpu"`` is given."""
    from ..models.i3d import InceptionI3D
    from .flax_i3d import init_i3d_state

    state = init_i3d_state(0, 400)
    out: Dict[str, object] = {}
    out["i3d_ckpt"] = write_i3d_saver_checkpoint(
        os.path.join(data_dir, "checkpoints", "rgb_imagenet", "model.ckpt"), state=state)
    # Kinetics-600 I3D: prefix-less Saver layout, 600-way head (reference
    # eval_type='rgb600', kinetics_i3d_utils.py:47-56)
    out["i3d_rgb600_ckpt"] = write_i3d_saver_checkpoint(
        os.path.join(data_dir, "checkpoints", "rgb_scratch_kin600", "model.ckpt"),
        state=init_i3d_state(1, 600), eval_type="rgb600")
    for variant in torch_variants:
        out[variant] = write_torchvision_pth(os.path.join(data_dir, f"{variant}.pth"), variant)
    # ig65m r2plus1d_34 heads (torch.hub moabitcoin/ig65m-pytorch via the
    # reference's MODELS table, model.py:47-52): 32-frame/359-way and
    # 8-frame/487-way state dicts
    for name, ncls in (("r2plus1d_34_32_ig65m", 359), ("r2plus1d_34_8_ig65m", 487)):
        out[name] = write_torchvision_pth(
            os.path.join(data_dir, f"{name}.pth"), "r2plus1d_34", num_classes=ncls, seed=ncls)
    # clean-prediction labelling by the model the runner builds, in f32 so
    # that the argmaxes carry over (write_npy_clips)
    model = InceptionI3D(400, torch.float32, device=device)
    model.load_state_dict(state)

    @torch.no_grad()
    def predict(clip: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(clip)[None].to(model.device)
        return model(x)[0][0].float().cpu().numpy()

    out["npy"] = write_npy_clips(
        os.path.join(data_dir, "videos_for_tests", "npy"),
        npy_classes or ["juggling balls", "bartending"],
        frames=frames, size=size, predict_fn=predict)
    out["tfrecords"] = write_tfrecord_shards(
        os.path.join(data_dir, "tfrecord", "test_all_cls"), frames=frames, size=size)
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_dir")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out = fabricate(args.data_dir, frames=args.frames, size=args.size, device=args.device)
    for k, v in out.items():
        print(f"fabricated {k}: {v}")


if __name__ == "__main__":
    main()
