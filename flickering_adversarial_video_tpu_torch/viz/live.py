"""Live attack dashboard: the reference's matplotlib panels, refreshed
during the attack loop (i3d_adversarial_main_single_video_npy.py:256-302).

The port's own copy of the JAX package's ``viz/live.py``.  A 4-pane figure
-- losses (semilog), regularizer terms, thickness/roughness, probabilities
(or a fooling ratio) -- refreshed every `refresh_every` steps.  Headless,
matplotlib's Agg backend renders it to a PNG (`save_path`); `show` opens a
window instead.  matplotlib is imported at the first render, so that the
module imports where matplotlib is absent (the card's machine has none: the
dashboard is a host tool, tested on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class LiveDashboard:
    def __init__(
        self,
        title: str = "attack",
        refresh_every: int = 25,
        save_path: Optional[str] = None,
        show: bool = False,
    ):
        self.refresh_every = refresh_every
        self.save_path = save_path
        self.show = show
        self.history: Dict[str, List[float]] = {}
        self._fig = None
        self._title = title

    def update(self, step: int, metrics: Dict[str, float]) -> None:
        for k in (
            "total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
            "laplacian_norm_reg", "thickness", "roughness", "prob_to_min",
            "prob_to_max",
        ):
            if k in metrics:
                self.history.setdefault(k, []).append(float(metrics[k]))
        if step % self.refresh_every == 0:
            self.render()

    def add_fooling(self, step: int, miss_rate: float) -> None:
        self.history.setdefault("fool_rate_steps", []).append(step)
        self.history.setdefault("fool_rate", []).append(miss_rate)

    def render(self) -> None:
        import matplotlib

        if not self.show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._fig is None:
            self._fig, self._axes = plt.subplots(4, 1, figsize=(8, 10))
        h = self.history
        ax1, ax2, ax3, ax4 = self._axes
        for ax in self._axes:
            ax.clear()
        if h.get("total_loss"):
            ax1.semilogy(h["total_loss"], "r", label="total_loss")
            ax1.semilogy(h["adv_loss"], "--b", label="adv_loss")
            ax1.semilogy(h["reg_loss"], "--g", label="reg_loss")
            ax1.set_title("Loss")
            ax1.legend(loc=3)
            ax1.grid(True)
        if h.get("norm_reg"):
            ax2.plot(h["reg_loss"], "--g", label="reg_loss")
            ax2.plot(h["norm_reg"], "k", label="thick")
            ax2.plot(h["diff_norm_reg"], "m", label="1st diff")
            ax2.plot(h["laplacian_norm_reg"], "b", label="2nd diff")
            ax2.set_title("Regularization Loss")
            ax2.legend(loc=3)
            ax2.grid(True)
        if h.get("thickness"):
            ax3.plot([t / 2 * 100 for t in h["thickness"]], "k", label="thickness")
            ax3.plot([r / 2 * 100 for r in h["roughness"]], "m", label="roughness")
            ax3.set_title("Metric")
            ax3.set_ylabel("Amplitude[%]")
            ax3.legend(loc=3)
            ax3.grid(True)
        if h.get("fool_rate"):
            ax4.plot(h["fool_rate_steps"], h["fool_rate"], "r", label="Fooling ratio")
            ax4.set_title("Fooling ratio")
            ax4.legend(loc=3)
        elif h.get("prob_to_min"):
            ax4.plot(h["prob_to_min"], "-k", label="prob to min")
            ax4.plot(h["prob_to_max"], "-b", label="prob to max")
            ax4.set_title("Probability")
            ax4.legend(loc=3)
        ax4.grid(True)
        self._fig.suptitle(self._title)
        self._fig.tight_layout()
        if self.save_path:
            self._fig.savefig(self.save_path, dpi=90)
        if self.show:
            plt.pause(0.05)

    def close(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self._fig)
