"""Per-video attack statistics sweep on the video-ResNet victims (the
mean/std world).

Port of the JAX package's ``runners/torch_per_video.py``: a deterministic
split (the records of <video-root>/<class>/ shuffled with seed 13, cut to
``--num-videos``), then the per-video flickering attack (L-inf 0.2 by
default) over each clip, with the skip-if-done ledger and the escalation of
max_norm (``engine/sweep.py``).  Videos are decoded with OpenCV
(``data/video_dataset.py``), which the port's card lacks: there, stub
``VideoDataset._decode``.

Not ported yet, each raising: several videos in flight (``--slots`` > 1,
the vectorized sweep; ROADMAP.md queue A item 10's rest) and the device mesh
(``--mesh``; item 11).

Usage:
  python -m flickering_adversarial_video_tpu_torch.runners.torch_per_video \\
      --model r2plus1d_18 --video-root /data/kinetics400/val \\
      --num-videos 100 --model-dir results_per_video [--device cpu]
"""

from __future__ import annotations

import argparse
import random
from typing import List, Optional

import torch

from ..attack import TorchStyleFlickerSpec
from ..data.video_dataset import VideoDataset, VideoRecord, records_from_folders
from ..engine import AttackConfig, AttackEngine, RuntimeFlags
from ..engine.sweep import fit_many_videos
from ..utils.labels import load_label_map, warn_if_placeholder
from .common import build_victim


def build_split(video_root: str, class_names, num_videos: int, seed: int = 13) -> List[VideoRecord]:
    """The records shuffled with a fixed seed (``random.Random(13)``, as the
    reference's ``random.seed(a=13)``) and cut to `num_videos`."""
    records = records_from_folders(video_root, class_names)
    random.Random(seed).shuffle(records)
    return records[:num_videos]


def run(
    model_name: str = "r2plus1d_18",
    *,
    records: List[VideoRecord],
    label_names,
    ckpt_path: Optional[str] = None,
    l_inf_norm: float = 0.2,
    n_iter: int = 3000,
    sample_length: int = 16,
    input_size: int = 112,
    model_dir: str = "results_per_video",
    loss_cfg: Optional[dict] = None,
    max_videos: Optional[int] = None,
    num_classes: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    slots: int = 1,
    use_mesh: bool = False,
    device=None,
):
    """The sweep on `device` (CUDA unless the caller asks for "cpu");
    returns its counts and each attacked video's (result path, fooled)."""
    if slots > 1:
        raise NotImplementedError(
            "slots > 1 (the vectorized sweep, engine/vector_sweep.py) is ROADMAP.md queue A "
            "item 10's rest")
    if use_mesh:
        raise NotImplementedError("the device mesh is ROADMAP.md queue A item 11")
    loss_cfg = loss_cfg or {}
    model = build_victim(model_name, ckpt_path, compute_dtype, sample_length, input_size,
                         num_classes=num_classes, device=device)
    spec = TorchStyleFlickerSpec(frames=sample_length, max_norm=l_inf_norm)
    cfg = AttackConfig(
        improve_loss=loss_cfg.get("improve_loss", True),
        margin=loss_cfg.get("margin", 0.05),
        targeted=loss_cfg.get("targeted", False),
        use_logits=loss_cfg.get("use_logits", False),
        norm_world="meanstd",
        reg_weighting="torch",
        target_class=loss_cfg.get("target_class"),
    )
    engine = AttackEngine(model, spec, cfg, track_probs=False)
    flags = RuntimeFlags(
        beta0=loss_cfg.get("lambda_", 1.0),
        beta1=loss_cfg.get("beta_1", 0.5),
        max_norm=l_inf_norm,
    )
    ds = VideoDataset(records, sample_length=sample_length, input_size=input_size,
                      random_offset=False, random_crop=False, random_flip=False)
    return fit_many_videos(
        engine,
        ds.batches(1, drop_remainder=False, shuffle=False),
        flags,
        model_dir=model_dir,
        label_names=label_names,
        n_iter=n_iter,
        max_norm=l_inf_norm,
        max_videos=max_videos,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="r2plus1d_18")
    p.add_argument("--video-root", required=True)
    p.add_argument("--ckpt", default=None, help="torchvision state_dict path (.pt/.pth) or .msgpack")
    p.add_argument("--num-videos", type=int, default=100)
    p.add_argument("--linf", type=float, default=0.2)
    p.add_argument("--model-dir", default="results_per_video")
    p.add_argument("--num-classes", type=int, default=None,
                   help="head width (359/487 for ig65m r2plus1d_34; default: the checkpoint's)")
    p.add_argument("--slots", type=int, default=1,
                   help="videos attacked at once (only 1 is ported: ROADMAP.md queue A item "
                   "10's rest)")
    p.add_argument("--mesh", action="store_true",
                   help="shard the slots over the devices (ROADMAP.md queue A item 11)")
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    labels = load_label_map(None, num_classes=args.num_classes or 400)
    warn_if_placeholder(labels)
    class_names = [c.replace(" ", "_") for c in labels]
    records = build_split(args.video_root, class_names, args.num_videos)
    out = run(
        args.model,
        records=records,
        label_names=labels,
        ckpt_path=args.ckpt,
        l_inf_norm=args.linf,
        model_dir=args.model_dir,
        num_classes=args.num_classes,
        slots=args.slots,
        use_mesh=args.mesh,
        device=args.device,
    )
    print(out)


if __name__ == "__main__":
    main()
