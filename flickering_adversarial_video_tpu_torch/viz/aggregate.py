"""Aggregate sweep plots — fooling ratio / thickness / roughness vs number of
training videos, per victim model.

The port's own copy of the JAX package's ``viz/aggregate.py`` (numpy and
matplotlib; a host tool: matplotlib is imported when a figure is drawn).  ``python -m
flickering_adversarial_video_tpu_torch.viz.aggregate <root> [--save out.png]``.

Rebuild of utils_cv/action_recognition/stats_and_plot_2_1_d.py: read the
per-epoch result .npy files of several torch-universal experiments, as the
port's ``runners.torch_universal`` writes them (``engine/epoch_fit.py``; each
directory named for its model + train size), pick per-experiment the epoch
with the minimum thickness among epochs whose fooling ratio exceeds a
threshold (:23-43 'minimum-thickness-at-fooling' selection), and plot the
three curves per model.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


def best_epoch_stats(
    results: List[dict], fooling_threshold: float = 0.8, phase: str = "valid"
) -> Optional[Dict[str, float]]:
    """Minimum-thickness epoch among those fooling above the threshold; falls
    back to the max-fooling epoch when none reaches it."""
    if not results:
        return None
    fooling = np.asarray([r[f"{phase}/fooling_ratio"] for r in results], float)
    thickness = np.asarray([r[f"{phase}/pert_thickness"] for r in results], float)
    roughness = np.asarray([r[f"{phase}/pert_roughness"] for r in results], float)
    ok = fooling >= fooling_threshold
    idx = int(np.argmin(np.where(ok, thickness, np.inf))) if ok.any() else int(np.argmax(fooling))
    return {
        "fooling_ratio": float(fooling[idx]),
        "thickness": float(thickness[idx]),
        "roughness": float(roughness[idx]),
        "epoch": idx + 1,
    }


def collect_experiments(
    root: str, models=("r2plus1d_18", "mc3_18", "r3d_18")
) -> Dict[str, List[Tuple[int, Dict[str, float]]]]:
    """Scan <root>/<model>_t<N>*/ experiment dirs; N = #train videos."""
    out: Dict[str, List[Tuple[int, Dict[str, float]]]] = {m: [] for m in models}
    for d in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(d):
            continue
        name = os.path.basename(d)
        for m in models:
            match = re.match(rf"{m}_t(\d+)", name)
            if not match:
                continue
            n_train = int(match.group(1))
            npys = sorted(glob.glob(os.path.join(d, f"{m}_*.npy")))
            if not npys:
                continue
            results = np.load(npys[-1], allow_pickle=True).tolist()
            stats = best_epoch_stats(results)
            if stats:
                out[m].append((n_train, stats))
    for m in out:
        out[m].sort()
    return out


def plot_sweep(experiments, save: Optional[str] = None):
    import matplotlib

    if save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    metrics = ["fooling_ratio", "thickness", "roughness"]
    for m, points in experiments.items():
        if not points:
            continue
        xs = [n for n, _ in points]
        for ax, metric in zip(axes, metrics):
            ax.plot(xs, [s[metric] for _, s in points], marker="o", label=m)
    for ax, metric in zip(axes, metrics):
        ax.set_xlabel("# train videos")
        ax.set_title(metric)
        ax.set_xscale("log")
        ax.grid(True)
        ax.legend()
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return save
    plt.show()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("root", help="directory of experiment result dirs")
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)
    plot_sweep(collect_experiments(args.root), save=args.save)


if __name__ == "__main__":
    main()
