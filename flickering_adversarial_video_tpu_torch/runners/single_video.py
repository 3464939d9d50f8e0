"""Single-video flickering attack runner.

Port of the JAX package's ``runners/single_video.py``: iterate the npy clip
directory, skip clips the clean model misclassifies, attack each until
fooled (stop rule `step > MAX_NUM_STEP and is_adversarial`), and dump a pkl
with the full per-step history under the reference's filename convention.

Not ported yet, each raising: several clips in flight (``slots > 1`` or the
YAML key ``SLOTS``; ROADMAP.md queue A item 10's rest), sharding them over a mesh
(``use_mesh``; item 11) and the live dashboard (``dashboard_path``; item 13).

Usage: python -m flickering_adversarial_video_tpu_torch.runners.single_video [run_config.yml]
"""

from __future__ import annotations

import os
import sys

from ..data.npy import list_npy_videos, load_npy_clip, parse_label_from_filename
from ..engine.loops import flags_from_config, single_video_attack
from ..utils.config import load_config
from ..viz.results import save_result_pkl
from .common import build_engine


def run(cfg, *, frames: int = 90, size=None, stop_rule: str = "reference", max_videos=None,
        dashboard_path=None, slots: int = 1, use_mesh: bool = False, device=None):
    """Run the attack of cfg.SINGLE_VIDEO_ATTACK on `device` (CUDA unless
    the caller asks for "cpu"); returns the paths of the pkls written."""
    attack_cfg = cfg.SINGLE_VIDEO_ATTACK
    # an explicit slots beats the YAML key; the default (1) defers to it
    if slots == 1:
        slots = int(attack_cfg.get("SLOTS", 1))
    if slots > 1:
        raise NotImplementedError(
            "SLOTS > 1 (the vectorized sweep, engine/vector_sweep.py) is ROADMAP.md queue A "
            "item 10's rest"
        )
    if use_mesh:
        raise NotImplementedError("the device mesh is ROADMAP.md queue A item 11")
    if dashboard_path:
        raise NotImplementedError(
            "the live dashboard (viz/live.py) is ROADMAP.md queue A item 13"
        )
    engine, labels = build_engine(attack_cfg, cfg.MODEL, frames=frames, size=size, device=device)
    flags = flags_from_config(attack_cfg)

    npy_path = attack_cfg.NPY_PATH
    result_path = attack_cfg.PKL_RESULT_PATH
    if not os.path.exists(npy_path):
        print(f"npy path {npy_path} does not exist")
        return []

    written = []
    videos = list_npy_videos(npy_path)[:max_videos]
    for k, video_path in enumerate(videos):
        clip = load_npy_clip(video_path, frames=frames)
        correct_cls = parse_label_from_filename(video_path)
        if correct_cls not in labels:
            print(f"skip {video_path}: unknown class {correct_cls!r}")
            continue
        label = labels.index(correct_cls)
        target_label = None
        if attack_cfg.TARGETED_ATTACK:
            target_label = labels.index(attack_cfg.TARGETED_CLASS)
        res = single_video_attack(
            engine,
            clip,
            label,
            flags,
            target_label=target_label,
            max_step=int(attack_cfg.MAX_NUM_STEP),
            stop_rule=stop_rule,
            seed=k,
        )
        if res is None:
            print(f"skip video {video_path}: clean model misclassifies")
            continue
        res["correct_cls"] = correct_cls
        path = save_result_pkl(res, result_path, correct_cls)
        written.append(path)
        print(
            f"[{k}] {correct_cls}: fooled={res['is_adversarial']} "
            f"steps={res['total_steps']} th={res['fatness'][-1]:.2f}% "
            f"rg={res['smoothness'][-1]:.2f}% ({res['steps_per_sec']:.2f} steps/s)"
        )
    return written


def main(argv=None):
    import argparse

    argv = argv if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=None, help="run_config.yml path")
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--size", type=int, default=None)
    p.add_argument(
        "--stop-rule", default="reference", choices=("reference", "early"),
        help="'early' stops at first fooling (sweep/rehearsal throughput)",
    )
    p.add_argument("--max-videos", type=int, default=None)
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    run(
        cfg,
        frames=args.frames,
        size=args.size,
        stop_rule=args.stop_rule,
        max_videos=args.max_videos,
        device=args.device,
    )


if __name__ == "__main__":
    main()
