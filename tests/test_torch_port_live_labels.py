"""The port's live dashboard (``viz/live.py``) and UCF-101 label map
(``utils/labels.py``) held against the JAX package's: the dashboard's history
and PNG as the JAX class records and draws them (the same inputs, the same
history, the same image size), and the label maps name for name.  Both are
host tools: matplotlib runs with its Agg backend, on the CPU.
"""

import os

import pytest

from flickering_adversarial_video_tpu.utils import labels as jlabels
from flickering_adversarial_video_tpu.viz.live import LiveDashboard as JDashboard
from flickering_adversarial_video_tpu_torch.utils import labels as tlabels
from flickering_adversarial_video_tpu_torch.viz.live import LiveDashboard

METRICS = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
           "laplacian_norm_reg", "thickness", "roughness", "prob_to_min", "prob_to_max")


def _drive(cls, path, fooling: bool):
    dash = cls(title="clip", refresh_every=100, save_path=str(path))  # drawn at step 0
    for step in range(11):
        dash.update(step, {k: (i + 1) / (step + 1) for i, k in enumerate(METRICS)}
                    | {"probs": [0.1]})  # a key the dashboard does not keep
    if fooling:  # the fooling pane, drawn again
        dash.add_fooling(10, 0.5)
        dash.render()
    dash.close()
    return dash.history


class TestLiveDashboard:
    @pytest.mark.parametrize("fooling", [False, True])
    def test_history_and_png_as_the_jax_dashboard(self, tmp_path, fooling):
        from PIL import Image

        got = _drive(LiveDashboard, tmp_path / "port.png", fooling)
        want = _drive(JDashboard, tmp_path / "jax.png", fooling)
        assert got == want and len(got["total_loss"]) == 11
        assert ("fool_rate" in got) == fooling
        with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
            assert a.format == b.format == "PNG" and a.size == b.size

    def test_renders_on_its_refresh_steps(self, tmp_path, monkeypatch):
        drawn = []
        monkeypatch.setattr(LiveDashboard, "render", lambda self: drawn.append(1))
        dash = LiveDashboard(refresh_every=100, save_path=str(tmp_path / "d.png"))
        for step in range(201):
            dash.update(step, {"total_loss": 1.0})
        assert len(drawn) == 3 and not os.path.exists(tmp_path / "d.png")


class TestLabelMaps:
    def test_ucf101_equals_the_jax_packages(self):
        ucf = tlabels.ucf101_labels()
        assert ucf == jlabels.ucf101_labels()
        assert len(set(ucf)) == 101 and ucf[0] == "ApplyEyeMakeup" and ucf[-1] == "YoYo"

    @pytest.mark.parametrize("n", [101, 400, 600, 7])
    def test_labels_for_num_classes_and_fallback(self, n):
        assert tlabels.labels_for_num_classes(n) == jlabels.labels_for_num_classes(n)
        assert tlabels.load_label_map("/nonexistent/x.txt", num_classes=n) == (
            jlabels.load_label_map("/nonexistent/x.txt", num_classes=n))
