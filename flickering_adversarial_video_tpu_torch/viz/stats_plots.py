"""Result visualization — animated clean/perturbation/adversarial viewer.

The port's own copy of the JAX package's ``viz/stats_plots.py`` (numpy and
matplotlib; a host tool: matplotlib is imported when a figure is drawn).  Rebuild of utils/stats_and_plot/stats_plots.py:
given a single-video result
pkl, show a 2x3 animated figure — clean clip, amplified-delta clip, and
adversarial clip on top; a scrolling per-channel RGB delta waveform below —
with thickness/roughness percentages in the title, optional mp4/gif export.

Usage: python -m flickering_adversarial_video_tpu_torch.viz.stats_plots <result.pkl>
           [--save out.mp4] [--amp 5]

It reads the pkl the port's single-video runner writes.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .results import load_result


def to_uint8(frame_pm1: np.ndarray) -> np.ndarray:
    """[-1,1] -> uint8 pixels."""
    return np.clip((frame_pm1 + 1.0) * 127.5, 0, 255).astype(np.uint8)


def extract_videos(res: dict, amp: float = 5.0):
    """(clean, amplified-delta, adversarial) uint8 videos from a result dict."""
    clean = np.asarray(res["rgb_sample"])
    if clean.ndim == 5:
        clean = clean[0]
    adv = np.asarray(res["adv_video"])
    if adv.ndim == 5:
        adv = adv[0]
    delta = np.asarray(
        res["perturbation"][-1] if isinstance(res["perturbation"], list) else res["perturbation"]
    )
    delta_vid = np.zeros_like(clean) + amp * delta  # broadcast [T,1,1,3]
    return to_uint8(clean), to_uint8(np.clip(delta_vid, -1, 1)), to_uint8(adv)


def select_writer(save_path: str) -> tuple:
    """(writer_name, effective_path) for an animation export target.

    mp4 (any non-gif container) needs matplotlib's ffmpeg writer
    (reference stats_plots.py:209-219 exports mp4); when no ffmpeg binary is
    on PATH the export falls back LOUDLY to an animated gif next to the
    requested path instead of crashing deep inside matplotlib."""
    from matplotlib import animation

    if save_path.endswith(".gif"):
        return "pillow", save_path
    if animation.writers.is_available("ffmpeg"):
        return "ffmpeg", save_path
    fallback = save_path.rsplit(".", 1)[0] + ".gif"
    print(
        f"[stats_plots] ffmpeg writer unavailable (no ffmpeg on PATH): "
        f"cannot write {save_path!r}; falling back to {fallback!r} (pillow gif)"
    )
    return "pillow", fallback


def animate(res: dict, amp: float = 5.0, save: Optional[str] = None, fps: int = 25, show: bool = True):
    import matplotlib

    if save or not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    clean, delta_vid, adv = extract_videos(res, amp)
    delta = np.asarray(
        res["perturbation"][-1] if isinstance(res["perturbation"], list) else res["perturbation"]
    ).reshape(-1, 3)
    T = clean.shape[0]
    thickness = res["fatness"][-1] if res.get("fatness") else 0.0
    roughness = res["smoothness"][-1] if res.get("smoothness") else 0.0

    fig, axes = plt.subplots(2, 3, figsize=(12, 7))
    fig.suptitle(
        f"{res.get('correct_cls', '?')} — thickness {thickness:.2f}% "
        f"roughness {roughness:.2f}% (delta x{amp} for display)"
    )
    ims = []
    titles = ["clean", f"perturbation x{amp}", "adversarial"]
    for j in range(3):
        axes[0, j].set_title(titles[j])
        axes[0, j].axis("off")
        ims.append(axes[0, j].imshow([[clean, delta_vid, adv][j][0]][0]))
    wf = axes[1, 0]
    gs = axes[1, 0].get_gridspec()
    for ax in axes[1, :]:
        ax.remove()
    wf = fig.add_subplot(gs[1, :])
    for c, color in enumerate("rgb"):
        wf.plot(delta[:, c], color, label=f"delta {color.upper()}")
    cursor = wf.axvline(0, color="k", linestyle="--")
    wf.set_xlabel("frame")
    wf.set_ylabel("delta")
    wf.legend(loc="upper right")
    wf.grid(True)

    def update(t):
        for j, vid in enumerate((clean, delta_vid, adv)):
            ims[j].set_data(vid[t % T])
        cursor.set_xdata([t % T])
        return ims + [cursor]

    ani = animation.FuncAnimation(fig, update, frames=T, interval=1000 // fps, blit=False)
    if save:
        writer, save = select_writer(save)
        ani.save(save, writer=writer, fps=fps)
        plt.close(fig)
        return save
    if show:
        plt.show()
    return ani


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("result", help="single-video result .pkl")
    p.add_argument("--save", default=None, help="write mp4/gif instead of showing")
    p.add_argument("--amp", type=float, default=5.0)
    args = p.parse_args(argv)
    res = load_result(args.result)
    animate(res, amp=args.amp, save=args.save)


if __name__ == "__main__":
    main()
