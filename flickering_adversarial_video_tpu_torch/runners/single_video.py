"""Single-video flickering attack runner.

Port of the JAX package's ``runners/single_video.py``: iterate the npy clip
directory, skip clips the clean model misclassifies, attack each until
fooled (stop rule `step > MAX_NUM_STEP and is_adversarial`), and dump a pkl
with the full per-step history under the reference's filename convention.

Several clips in flight (``slots > 1``, ``--slots`` or the YAML key
``SLOTS``) run the vectorized sweep (``engine/vector_sweep.py``), with the
same per-clip seeds (the clip's index), stop rule, pkl schema and file names
as one clip at a time.  ``--mesh`` (``use_mesh``) splits the slots over the
ranks of a torchrun launch (``engine/vector_sweep.py``): rank r attacks clips
r, r + W, ... with slots / W slots, each clip with its seed, and writes its
own pkls; at one rank it changes nothing, and at one slot the JAX package
ignores it, as the port does at W = 1.  A run of several ranks without that
split (one slot, or no ``--mesh``) is refused.  ``dashboard_path`` draws the
live dashboard (``viz/live.py``, a PNG refreshed every 100 steps) for each
clip; it is per clip, so with several slots the runner warns and goes on
without it, as the JAX runner does.  It needs matplotlib (a host tool: the
card's machine has none).

Usage: python -m flickering_adversarial_video_tpu_torch.runners.single_video [run_config.yml]
       torchrun --nproc-per-node N -m flickering_adversarial_video_tpu_torch.runners.single_video \
           cfg.yml --slots 4 --mesh
"""

from __future__ import annotations

import os
import sys

from ..data.npy import list_npy_videos, load_npy_clip, parse_label_from_filename
from ..engine.loops import flags_from_config, single_video_attack
from ..engine.vector_sweep import vector_single_video_attacks
from ..parallel import mesh as mesh_lib
from ..utils.config import load_config
from ..viz.results import save_result_pkl
from .common import build_engine


def run(cfg, *, frames: int = 90, size=None, stop_rule: str = "reference", max_videos=None,
        dashboard_path=None, slots: int = 1, use_mesh: bool = False, device=None):
    """Run the attack of cfg.SINGLE_VIDEO_ATTACK on `device` (CUDA unless
    the caller asks for "cpu"); returns the paths of the pkls written (by
    every rank, in the clips' order)."""
    attack_cfg = cfg.SINGLE_VIDEO_ATTACK
    # an explicit slots beats the YAML key; the default (1) defers to it
    if slots == 1:
        slots = int(attack_cfg.get("SLOTS", 1))
    split = mesh_lib.slot_split("the single-video runner", use_mesh, slots)
    # a clip at a time: the engine has no mesh (the sweep splits the slots)
    engine, labels = build_engine(attack_cfg, cfg.MODEL, frames=frames, size=size, device=device,
                                  use_mesh=False)
    flags = flags_from_config(attack_cfg)

    npy_path = attack_cfg.NPY_PATH
    result_path = attack_cfg.PKL_RESULT_PATH
    if not os.path.exists(npy_path):
        print(f"npy path {npy_path} does not exist")
        return []

    written = []
    videos = list_npy_videos(npy_path)[:max_videos]
    if slots > 1:
        if dashboard_path:
            print("[warn] live dashboard is per-clip and not supported with "
                  "SLOTS > 1; continuing without it")
        mesh = mesh_lib.make_mesh(device) if split else None
        return _run_vectorized(engine, labels, attack_cfg, flags, videos, result_path,
                               frames=frames, slots=slots, stop_rule=stop_rule, mesh=mesh)
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
        log_fn = None
        if dashboard_path:
            from ..viz.live import LiveDashboard

            log_fn = LiveDashboard(title=correct_cls, save_path=dashboard_path,
                                   refresh_every=100).update
        res = single_video_attack(
            engine,
            clip,
            label,
            flags,
            target_label=target_label,
            max_step=int(attack_cfg.MAX_NUM_STEP),
            stop_rule=stop_rule,
            seed=k,
            log_fn=log_fn,
        )
        if res is None:
            print(f"skip video {video_path}: clean model misclassifies")
            continue
        written.append(_save(res, result_path, correct_cls, k))
    return written


def _save(res, result_path, correct_cls, k) -> str:
    res["correct_cls"] = correct_cls
    path = save_result_pkl(res, result_path, correct_cls)
    print(
        f"[{k}] {correct_cls}: fooled={res['is_adversarial']} "
        f"steps={res['total_steps']} th={res['fatness'][-1]:.2f}% "
        f"rg={res['smoothness'][-1]:.2f}% ({res['steps_per_sec']:.2f} steps/s)"
    )
    return path


def _run_vectorized(engine, labels, attack_cfg, flags, videos, result_path, *, frames, slots,
                    stop_rule, mesh=None):
    """`slots` clips in flight (``vector_sweep.vector_single_video_attacks``):
    the sequential path's per-clip seeds (the enumeration index), stop rule,
    pkl schema and file names; with a mesh, this rank's clips k = rank (mod
    W), and the paths every rank wrote."""
    clips, true_labels, names, seeds = [], [], [], []
    for k, video_path in enumerate(videos):
        if mesh is not None and k % mesh.world != mesh.rank:
            continue
        correct_cls = parse_label_from_filename(video_path)
        if correct_cls not in labels:
            print(f"skip {video_path}: unknown class {correct_cls!r}")
            continue
        clips.append(load_npy_clip(video_path, frames=frames))
        true_labels.append(labels.index(correct_cls))
        names.append(correct_cls)
        seeds.append(k)
    target_label = None
    if attack_cfg.TARGETED_ATTACK:
        target_label = labels.index(attack_cfg.TARGETED_CLASS)
    results = vector_single_video_attacks(
        engine, clips, true_labels, flags, slots=slots, max_step=int(attack_cfg.MAX_NUM_STEP),
        stop_rule=stop_rule, target_label=target_label, seeds=seeds, mesh=mesh,
    )
    written = []
    for res, correct_cls, k in zip(results, names, seeds):
        if res is None:
            print(f"skip video {k} ({correct_cls}): clean model misclassifies")
            continue
        written.append((k, _save(res, result_path, correct_cls, k)))
    every = sorted(w for part in mesh_lib.gather_objects(mesh, written) for w in part)
    return [path for _, path in every]


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
    p.add_argument("--slots", type=int, default=1,
                   help="clips attacked at once (the vectorized sweep; also YAML SLOTS)")
    p.add_argument("--mesh", action="store_true",
                   help="split the slots over the ranks of a torchrun launch (slots %% W == 0)")
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    run(
        cfg,
        frames=args.frames,
        size=args.size,
        stop_rule=args.stop_rule,
        max_videos=args.max_videos,
        slots=args.slots,
        use_mesh=args.mesh,
        device=args.device,
    )


if __name__ == "__main__":
    main()
