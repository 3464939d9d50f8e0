"""The port's torch world held against the JAX package's, in f32 on the CPU:
the mean/std perturbation, the engine's mean/std step on r2plus1d_18 (Adam
trajectories, ``train_eval_step``'s counters), the per-video sweep, the
epoch fit, the one-cycle LR, the video dataset and the runners.

The sweep, the epoch fit and the runners run on a linear mean/std victim
(the clip's mean colour times a fixed [3, 40] matrix), as the JAX package's
own tests/test_torch_world.py builds one, in both packages.  The initial
delta is drawn from a torch generator in the port and with threefry in the
JAX package; the streams differ, so each comparison hands the port the JAX
draw.  Tolerances: losses 1e-5 relative, delta 1e-6 absolute against Adam
steps of 1e-3 (f32 reassociation); on r2plus1d_18, delta 1e-5 (1% of a
step): its d(delta) agrees to 1e-4 relative where the adversarial and the
regularizer gradients nearly cancel (tests/test_torch_port_resnet_grad.py),
and Adam's g / (|g| + eps) divides each component by its own magnitude, so
such a component's second step carries that error; counters, schedules,
skips, escalations and file schemas exactly.
"""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import TorchStyleFlickerSpec as JSpec
from flickering_adversarial_video_tpu.attack import perturbation as jpert
from flickering_adversarial_video_tpu.data import video_dataset as jvd
from flickering_adversarial_video_tpu.engine import AttackConfig as JConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JFlags
from flickering_adversarial_video_tpu.engine import epoch_fit as jfit
from flickering_adversarial_video_tpu.engine import sweep as jsweep
from flickering_adversarial_video_tpu.models.video_resnet import VideoResNet as JResNet
from flickering_adversarial_video_tpu.runners import torch_per_video as jper_video
from flickering_adversarial_video_tpu.runners import torch_universal as juniversal
from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
from flickering_adversarial_video_tpu_torch.attack import perturbation as tpert
from flickering_adversarial_video_tpu_torch.convert import video_resnet_state_dict
from flickering_adversarial_video_tpu_torch.convert.flax_video_resnet import to_flax_variables
from flickering_adversarial_video_tpu_torch.data import video_dataset as tvd
from flickering_adversarial_video_tpu_torch.engine import (
    AttackConfig, AttackEngine, AttackState, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.engine import epoch_fit as tfit
from flickering_adversarial_video_tpu_torch.engine import sweep as tsweep
from flickering_adversarial_video_tpu_torch.engine.loops import single_video_attack
from flickering_adversarial_video_tpu_torch.models.video_resnet import VideoResNet
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import torch_per_video as tper_video
from flickering_adversarial_video_tpu_torch.runners import torch_universal as tuniversal
from flickering_adversarial_video_tpu_torch.utils import config as tconfig

FRAMES, SIZE, K = 4, 8, 40
MEANSTD = dict(norm_world="meanstd", reg_weighting="torch")
W = (np.random.default_rng(11).standard_normal((3, K)) * 3.0).astype(np.float32)


class LinearVictim(torch.nn.Module):
    """logits = mean over (T, H, W) of the normalized clip @ W."""

    def __init__(self, w=W):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.asarray(w)))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w


def jax_linear(w=W):
    return (lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"]), {"w": jnp.asarray(w)}


def engines(max_norm=0.2, track_probs=False, w=W):
    apply_fn, variables = jax_linear(w)
    je = JEngine(apply_fn, variables, JSpec(frames=FRAMES, max_norm=max_norm),
                 JConfig(**MEANSTD), track_probs=track_probs)
    te = AttackEngine(LinearVictim(w), TorchStyleFlickerSpec(FRAMES, max_norm=max_norm),
                      AttackConfig(**MEANSTD), track_probs=track_probs)
    return je, te


def self_labelled(rng, b=1, n=1):
    """`n` batches of `b` uint8 clips labelled with the linear victim's clean
    prediction (computed in numpy, as both engines normalize)."""
    out = []
    for i in range(n):
        video = rng.integers(0, 255, (b, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
        x = (video.astype(np.float32) / 255.0 - np.float32(tvd.DEFAULT_MEAN)) / np.float32(
            tvd.DEFAULT_STD)
        labels = (x.mean(axis=(1, 2, 3)) @ W).argmax(-1)
        out.append({"video": video, "labels": labels.astype(np.int64),
                    "paths": [f"v{i}_{j}.mp4" for j in range(b)]})
    return out


# ---------------- the mean/std perturbation ----------------

class TestPerturbation:
    def test_spec_matches_jax(self):
        for kw in ({}, dict(max_norm=0.2, height=8, width=8), dict(mean=(0.5,) * 3, std=(0.25,) * 3)):
            j, t = JSpec(frames=FRAMES, **kw), TorchStyleFlickerSpec(FRAMES, **kw)
            assert t.shape == j.shape and t.clamp_range == j.clamp_range
            assert t.init_scale == j.init_scale == 1e-6

    @pytest.mark.parametrize("cyclic", [False, True])
    def test_apply_matches_jax_with_the_half_gradient_at_the_bounds(self, cyclic):
        """Values bit-equal, and d(delta) of a random cotangent: 0.5 of the
        cotangent where delta sits exactly on +-max_norm (jnp.clip's rule);
        the cyclic blend with the JAX key's shift handed over."""
        rng = np.random.default_rng(0)
        spec, jspec = TorchStyleFlickerSpec(FRAMES), JSpec(frames=FRAMES)
        x = rng.normal(size=(2, FRAMES, 3, 3, 3)).astype(np.float32)
        delta = rng.uniform(-0.3, 0.3, (FRAMES, 1, 1, 3)).astype(np.float32)
        delta[0, 0, 0, :2] = (0.2, -0.2)  # exactly on the bound
        ct = rng.normal(size=x.shape).astype(np.float32)
        key = jax.random.key(3) if cyclic else None

        def jf(d):
            return jpert.apply_perturbation_torch_style(
                jnp.asarray(x), d, jspec, adv_flag=1.0, max_norm=0.2, cyclic_pert_flag=0.7,
                key=key)

        jy, vjp = jax.vjp(jf, jnp.asarray(delta))
        (jg,) = vjp(jnp.asarray(ct))
        shift = (torch.tensor(int(jax.random.randint(key, (), 0, FRAMES))) if cyclic else None)
        d = torch.from_numpy(delta).requires_grad_(True)
        y = tpert.apply_perturbation_torch_style(
            torch.from_numpy(x), d, spec, adv_flag=1.0, max_norm=torch.tensor(0.2),
            cyclic_pert_flag=0.7, shift=shift)
        (g,) = torch.autograd.grad(y, d, torch.from_numpy(ct))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
        if not cyclic:  # half of what a delta just inside the bound receives
            inside = delta.copy()
            inside[0, 0, 0, :2] = (np.float32(0.2) - 1e-6, np.float32(-0.2) + 1e-6)
            d = torch.from_numpy(inside).requires_grad_(True)
            y = tpert.apply_perturbation_torch_style(torch.from_numpy(x), d, spec,
                                                     max_norm=torch.tensor(0.2))
            (g_in,) = torch.autograd.grad(y, d, torch.from_numpy(ct))
            np.testing.assert_allclose(g[0, 0, 0, :2].numpy(), 0.5 * g_in[0, 0, 0, :2].numpy(),
                                       rtol=1e-6)

    def test_init_delta_from_a_generator(self):
        spec = TorchStyleFlickerSpec(FRAMES, init_scale=0.005)
        a = tpert.init_delta(spec, generator=torch.Generator().manual_seed(4))
        b = tpert.init_delta(spec, generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and a.shape == spec.shape and a.abs().max() <= 0.005
        assert torch.equal(tpert.init_delta(spec), tpert.init_delta(spec))  # seed 0 by default
        assert a.abs().min() > 0


# ---------------- the engine's mean/std step on r2plus1d_18 ----------------

RB, RT, RS, RK = 2, 4, 16, 7
MAX_NORMS = (0.0015, 0.0015, 0.00195)  # the third step's bound 1.3 times the first two's
TERMS = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
         "laplacian_norm_reg", "thickness", "roughness")
DELTA_TERMS = ("delta_max", "delta_min")


@pytest.fixture(scope="module")
def resnet_runs():
    """3 Adam steps of the JAX engine (its generic path: the packed torch
    head the JAX runners add computes the same function) and of the port's,
    from the JAX draw of the initial delta; then one train_eval_step of the
    port's."""
    state = {k: torch.from_numpy(v) for k, v in video_resnet_state_dict("r2plus1d_18", RK, 1).items()}
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(state, "r2plus1d_18"))
    model = VideoResNet("r2plus1d_18", RK, torch.float32, device="cpu")
    model.load_state_dict(state)
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (RB, RT, RS, RS, 3), dtype=np.uint8)
    te = AttackEngine(model, TorchStyleFlickerSpec(RT), AttackConfig(**MEANSTD), track_probs=True)
    labels = te.forward(None, {"video": video, "labels": np.zeros(RB)}, RuntimeFlags(),
                        adversarial=False).argmax(-1).numpy()
    je = JEngine(JResNet("r2plus1d_18", RK, jnp.float32).apply, variables, JSpec(frames=RT),
                 JConfig(**MEANSTD), track_probs=True)
    jbatch = {"video": jnp.asarray(video), "labels": jnp.asarray(labels)}
    tbatch = {"video": video, "labels": labels}
    out = {"jax": [], "torch": []}
    js = je.init_state(jax.random.key(5))
    delta0 = np.asarray(js.delta)
    for m in MAX_NORMS:
        js, mt = je.train_step(js, jbatch, JFlags(max_norm=m), jax.random.key(0))
        out["jax"].append({k: float(mt[k]) for k in TERMS + DELTA_TERMS + ("is_adversarial",)})
    out["jax_delta"] = np.asarray(js.delta)
    ts = te.init_state()
    ts.delta = torch.from_numpy(delta0.copy())
    for m in MAX_NORMS:
        ts, mt = te.train_step(ts, tbatch, RuntimeFlags(max_norm=m))
        out["torch"].append({k: float(mt[k]) for k in TERMS + DELTA_TERMS + ("is_adversarial",)})
    out["torch_delta"] = ts.delta.numpy()
    ts2 = te.init_state()
    ts2.delta = torch.from_numpy(delta0.copy())
    ts2, tm = te.train_eval_step(ts2, tbatch, RuntimeFlags(max_norm=MAX_NORMS[0]))
    out["torch_counters"] = (int(tm["miss"]), int(tm["valid"]))
    out["torch_te_delta"] = ts2.delta.numpy()
    out["torch_te_adv"] = bool(tm["is_adversarial"])
    out["delta0"] = delta0
    return out


class TestMeanStdStep:
    @pytest.mark.parametrize("step", range(len(MAX_NORMS)))
    def test_loss_terms_match(self, resnet_runs, step):
        got, want = resnet_runs["torch"][step], resnet_runs["jax"][step]
        assert got["is_adversarial"] == want["is_adversarial"]
        for k in TERMS:  # the regularizers of a delta of ~1e-3 that agrees to 1e-6
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9, err_msg=k)
        for k in DELTA_TERMS:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)

    def test_delta_trajectory_matches(self, resnet_runs):
        got, want = resnet_runs["torch_delta"], resnet_runs["jax_delta"]
        assert np.abs(want - resnet_runs["delta0"]).max() > 1e-3  # Adam moved it
        assert np.abs(want).max() > MAX_NORMS[0]  # past the first bound: the clamp acts
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_train_eval_step_on_the_resnet(self, resnet_runs):
        """The fused step's update is the train step's first (against the
        JAX engine's), its counters those of the first step's probabilities:
        every self-labelled clip valid, a miss where the step fooled it."""
        miss, valid = resnet_runs["torch_counters"]
        assert valid == RB and miss == (RB if resnet_runs["torch_te_adv"] else miss)
        np.testing.assert_array_equal(resnet_runs["torch_te_adv"],
                                      resnet_runs["jax"][0]["is_adversarial"])

    def test_train_eval_step_counters_match_jax(self, rng):
        """miss / valid of train_eval_step against the JAX engine's on the
        linear victim: a batch with a clip the clean model gets wrong (not
        valid) and two it gets right, over three steps from the JAX draw."""
        je, te = engines(track_probs=True, max_norm=1.0)
        batch = self_labelled(rng, b=3)[0]
        batch["labels"][0] = (batch["labels"][0] + 1) % K
        js = je.init_state(jax.random.key(2))
        d0 = torch.from_numpy(np.asarray(js.delta).copy())
        ts = AttackState(d0, torch.zeros_like(d0), torch.zeros_like(d0), 0)
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "paths"}
        for lr in (0.3, 0.3, 0.3):
            js, jm = je.train_eval_step(js, jb, JFlags(max_norm=1.0, learning_rate=lr),
                                        jax.random.key(0))
            ts, tm = te.train_eval_step(ts, batch, RuntimeFlags(max_norm=1.0, learning_rate=lr))
            assert (int(tm["miss"]), int(tm["valid"])) == (int(jm["miss"]), int(jm["valid"]))
            np.testing.assert_allclose(ts.delta.numpy(), np.asarray(js.delta), rtol=1e-5, atol=1e-6)
        assert int(tm["valid"]) == 2 and int(tm["miss"]) >= 1

    def test_train_eval_step_needs_probs_and_equals_train_step(self, rng):
        je, te = engines(track_probs=False)
        batch = self_labelled(rng, b=2)[0]
        with pytest.raises(ValueError, match="track_probs"):
            te.train_eval_step(te.init_state(), batch, RuntimeFlags(max_norm=0.2))
        _, te = engines(track_probs=True)
        a, m = te.train_eval_step(te.init_state(), batch, RuntimeFlags(max_norm=0.2))
        b, _ = te.train_step(te.init_state(), batch, RuntimeFlags(max_norm=0.2))
        assert torch.equal(a.delta, b.delta) and int(m["valid"]) == 2
        fresh = te.reset_delta(a, torch.Generator().manual_seed(3))
        want = te.init_state(torch.Generator().manual_seed(3))
        assert fresh.step == 0 and torch.equal(fresh.delta, want.delta)
        assert not fresh.mu.any() and not fresh.nu.any()

    def test_clean_forward_does_not_clamp(self):
        """The clean forward normalizes only: white pixels stay at
        (1 - mean)/std per channel, above the scalar clamp range's top."""
        _, te = engines()
        white = np.full((1, FRAMES, SIZE, SIZE, 3), 255, np.uint8)
        x = te._normalize(torch.from_numpy(white))
        assert x.max() > TorchStyleFlickerSpec(FRAMES).clamp_range[1]
        seen = []
        te.model.forward = lambda v: seen.append(v.max()) or v.mean(dim=(1, 2, 3)) @ te.model.w
        te.forward(None, {"video": white, "labels": np.zeros(1)}, adversarial=False)
        te.forward(te.init_state().delta, {"video": white, "labels": np.zeros(1)})
        assert seen[0] == x.max() and seen[1] <= TorchStyleFlickerSpec(FRAMES).clamp_range[1]

    def test_frame_window_is_refused(self):
        with pytest.raises(ValueError, match="frame_window"):
            AttackEngine(LinearVictim(), TorchStyleFlickerSpec(FRAMES),
                         AttackConfig(frame_window=(0, 1), **MEANSTD))


# ---------------- the per-video sweep ----------------

def _hand_over_the_jax_draw(monkeypatch):
    """The port's per-video re-init draws what the JAX sweep draws."""
    def draw(shape, seed, init_scale):
        key = jax.random.fold_in(jax.random.key(seed), 1)
        u = jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)
        return torch.from_numpy(np.asarray(u * init_scale))

    monkeypatch.setattr(tsweep, "draw_init_delta", draw)


def _assert_results_match(got, want):
    assert set(got) == set(want)
    for k in ("is_adversarial", "escalations", "final_max_norm"):
        assert np.all(np.asarray(got[k]) == np.asarray(want[k])), k
    # tens of Adam steps: the losses of deltas that agree to 1e-6
    for k in ("loss/total", "loss/adv_loss", "loss/reg_loss", "perturbation/thickness",
              "perturbation/roughness"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(got["perturbation"]), np.asarray(want["perturbation"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["prob_clean_input"], want["prob_clean_input"], rtol=1e-5)
    np.testing.assert_array_equal(got["label"], want["label"])


class TestPerVideoSweep:
    def test_single_video_fools_as_jax(self, rng, monkeypatch):
        _hand_over_the_jax_draw(monkeypatch)
        je, te = engines()
        batch = self_labelled(rng)[0]
        want = jsweep.fit_single_video(je, batch, JFlags(max_norm=0.2), n_iter=40, max_norm=0.2,
                                       seed=3)
        got = tsweep.fit_single_video(te, batch, RuntimeFlags(max_norm=0.2), n_iter=40,
                                      max_norm=0.2, seed=3)
        assert np.asarray(want["is_adversarial"]).any()
        _assert_results_match(got, want)

    def test_escalation_caps_at_four_chances_as_jax(self, rng, monkeypatch):
        """A victim that always predicts class 0 is never fooled: 4
        escalations, max_norm * 1.3^4, in both packages."""
        _hand_over_the_jax_draw(monkeypatch)
        w = np.zeros((3, K), np.float32)
        w[:, 0] = 100.0
        je, te = engines(max_norm=0.05, w=w)
        batch = {"video": rng.integers(0, 255, (1, FRAMES, SIZE, SIZE, 3), dtype=np.uint8),
                 "labels": np.asarray([0])}
        want = jsweep.fit_single_video(je, batch, JFlags(max_norm=0.05), n_iter=5, max_norm=0.05)
        got = tsweep.fit_single_video(te, batch, RuntimeFlags(max_norm=0.05), n_iter=5,
                                      max_norm=0.05)
        assert got["escalations"] == 4 and not np.asarray(got["is_adversarial"]).any()
        np.testing.assert_allclose(got["final_max_norm"], 0.05 * 1.3 ** 4, rtol=1e-12)
        assert len(got["loss/total"]) == len(want["loss/total"]) == 4 * (5 + 1)
        _assert_results_match(got, want)

    def test_misclassified_and_targeted(self, rng):
        je, te = engines()
        batch = self_labelled(rng)[0]
        batch["labels"] = (batch["labels"] + 1) % K
        assert tsweep.fit_single_video(te, batch, RuntimeFlags(max_norm=0.2), n_iter=3) is None
        assert jsweep.fit_single_video(je, batch, JFlags(max_norm=0.2), n_iter=3) is None

    def test_ledger_and_file_schema_as_jax(self, rng, tmp_path, monkeypatch):
        """Two fooled videos and a misclassified one: the result files'
        schema equals the JAX package's, a rerun skips the fooled, and a
        None placeholder (a video in progress) is attacked again."""
        _hand_over_the_jax_draw(monkeypatch)
        labels = [f"class {i}" for i in range(K)]
        batches = self_labelled(rng, n=3)
        batches[1]["labels"] = (batches[1]["labels"] + 1) % K
        je, te = engines()
        jout = jsweep.fit_many_videos(je, batches, JFlags(max_norm=0.2),
                                      model_dir=str(tmp_path / "j"), label_names=labels, n_iter=40)
        tout = tsweep.fit_many_videos(te, batches, RuntimeFlags(max_norm=0.2),
                                      model_dir=str(tmp_path / "t"), label_names=labels, n_iter=40)
        for k in ("attacked", "skipped_existing", "skipped_misclassified"):
            assert tout[k] == jout[k], k
        assert tout["attacked"] == 2 and tout["skipped_misclassified"] == 1
        assert [os.path.basename(p) for p, _ in tout["results"]] == [
            os.path.basename(p) for p, _ in jout["results"]]
        for (tp, tf), (jp, jf) in zip(tout["results"], jout["results"]):
            assert tf == jf
            _assert_results_match(np.load(tp, allow_pickle=True).tolist(),
                                  np.load(jp, allow_pickle=True).tolist())
        again = tsweep.fit_many_videos(te, batches, RuntimeFlags(max_norm=0.2),
                                       model_dir=str(tmp_path / "t"), label_names=labels,
                                       n_iter=40)
        assert again["skipped_existing"] == 2 and again["attacked"] == 0
        first = tout["results"][0][0]
        np.save(first, None)
        assert not tsweep.should_skip(first) and not jsweep.should_skip(first)
        assert tsweep.result_path_for("d", "a/b c.mp4", "x y") == jsweep.result_path_for(
            "d", "a/b c.mp4", "x y")


# ---------------- the epoch fit ----------------

class TestEpochFit:
    def test_results_resume_and_files_as_jax(self, rng, tmp_path):
        """Two epochs of the fit (train_eval_step in the train phase), then
        a resume to a third, in both packages from the JAX initial delta:
        the same results, key for key, and files."""
        je, te = engines(track_probs=True)
        train, valid = self_labelled(rng, b=2, n=3), self_labelled(rng, b=2, n=2)
        flags_j, flags_t = JFlags(max_norm=0.2), RuntimeFlags(max_norm=0.2)
        js = je.init_state(jax.random.key(7))
        delta0 = torch.from_numpy(np.asarray(js.delta).copy())
        ts = AttackState(delta0, torch.zeros_like(delta0), torch.zeros_like(delta0), 0)
        kw = dict(epochs=2, lr=1e-2, model_name="r2plus1d_18", use_one_cycle_policy=True)
        want = jfit.fit_universal_epochs(je, lambda: iter(train), lambda: iter(valid), flags_j,
                                         model_dir=str(tmp_path / "j"), state=js, **kw)
        got = tfit.fit_universal_epochs(te, lambda: iter(train), lambda: iter(valid), flags_t,
                                        model_dir=str(tmp_path / "t"), state=ts, **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if k.endswith(("time", "steps_per_sec")):
                    continue
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert any(r["train/fooling_ratio"] > 0 for r in want)
        assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
            "r2plus1d_18_001.npy", "r2plus1d_18_002.npy"]
        saved = np.load(tmp_path / "t" / "r2plus1d_18_002.npy", allow_pickle=True).tolist()
        assert len(saved) == 2 and set(saved[1]) == set(want[1])
        for m, pkg in ((tfit, "t"), (jfit, "j")):
            delta, epoch = m.find_resume(str(tmp_path / pkg), "r2plus1d_18")
            assert epoch == 2
            np.testing.assert_array_equal(delta, saved[1]["valid/perturbation"] if pkg == "t"
                                          else want[1]["valid/perturbation"])
        assert tfit.find_resume(str(tmp_path / "none"), "m") == (None, 0)
        more = tfit.fit_universal_epochs(
            te, lambda: iter(train), lambda: iter(valid), flags_t, model_dir=str(tmp_path / "t"),
            start_epoch=3, state=AttackState(torch.from_numpy(delta.copy()), torch.zeros_like(delta0),
                                             torch.zeros_like(delta0), 0),
            **{**kw, "epochs": 3})
        assert len(more) == 1 and os.path.exists(tmp_path / "t" / "r2plus1d_18_003.npy")

    def test_train_step_path_without_probs(self, rng, tmp_path):
        """Without track_probs the train phase steps and the counters come
        from eval steps, as in the JAX fit."""
        je, te = engines(track_probs=False)
        batches = self_labelled(rng, b=2, n=2)
        js = je.init_state(jax.random.key(1))
        d0 = torch.from_numpy(np.asarray(js.delta).copy())
        kw = dict(epochs=1, lr=1e-2, model_name="m", save=False)
        want = jfit.fit_universal_epochs(je, lambda: iter(batches), lambda: iter(batches),
                                         JFlags(max_norm=0.2), model_dir=str(tmp_path), state=js,
                                         **kw)
        got = tfit.fit_universal_epochs(
            te, lambda: iter(batches), lambda: iter(batches), RuntimeFlags(max_norm=0.2),
            model_dir=str(tmp_path), state=AttackState(d0, torch.zeros_like(d0),
                                                       torch.zeros_like(d0), 0), **kw)
        for k in ("train/loss", "train/fooling_ratio", "valid/fooling_ratio", "valid/inf_norm"):
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)

    @pytest.mark.parametrize("epochs,step_size", [(22, None), (9, 3)])
    def test_step_lr(self, epochs, step_size):
        for e in range(1, epochs + 1):
            s = step_size or int(np.ceil(2 / 3 * epochs))
            assert tfit.step_lr(1e-3, e, s) == jfit.step_lr(1e-3, e, s)


class TestOneCycleLR:
    @pytest.mark.parametrize("epochs,pct", [(22, 0.3), (10, 0.3), (8, 0.5), (3, 0.3)])
    def test_matches_jax_and_torch(self, epochs, pct):
        """one_cycle_lr against the JAX package's and against
        torch.optim.lr_scheduler.OneCycleLR as the reference builds it."""
        lr = 1e-3
        opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=lr)
        sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=lr, total_steps=epochs,
                                                    pct_start=pct)
        for epoch in range(1, epochs + 1):
            got = tfit.one_cycle_lr(lr, epoch, epochs, pct_start=pct)
            assert got == jfit.one_cycle_lr(lr, epoch, epochs, pct_start=pct)
            # a warm-up shorter than one epoch takes the JAX package's own
            # branch (max_lr at once), which OneCycleLR does not share
            if pct * epochs - 1 > 0:
                assert got == pytest.approx(opt.param_groups[0]["lr"], rel=1e-6), epoch
            if epoch < epochs:
                sched.step()


# ---------------- the video dataset ----------------

def _frames(path):
    seed = sum(map(ord, os.path.basename(path)))
    return np.random.default_rng(seed).integers(0, 256, (7, 20, 30, 3), dtype=np.uint8)


class TestVideoDataset:
    def test_records_and_sampling_as_jax(self, tmp_path):
        split = tmp_path / "split.txt"
        split.write_text("a/x.mp4 3\n\nb/y z.mp4 7\n")
        assert ([vars(r) for r in tvd.records_from_split_file(str(split), "/r")]
                == [vars(r) for r in jvd.records_from_split_file(str(split), "/r")])
        for cls in ("c0", "c2"):
            os.makedirs(tmp_path / "v" / cls)
            for n in ("b.mp4", "a.mp4"):
                (tmp_path / "v" / cls / n).write_bytes(b"")
        names = ["c0", "c1", "c2"]
        assert ([vars(r) for r in tvd.records_from_folders(str(tmp_path / "v"), names)]
                == [vars(r) for r in jvd.records_from_folders(str(tmp_path / "v"), names)])
        for n, length, kw in ((10, 4, {}), (3, 8, {}), (20, 6, dict(random_offset=True)),
                              (20, 6, dict(random_offset=True, temporal_jitter=True))):
            np.testing.assert_array_equal(
                tvd.sample_clip_indices(n, length, rng=np.random.default_rng(1), **kw),
                jvd.sample_clip_indices(n, length, rng=np.random.default_rng(1), **kw))
        assert tvd.DEFAULT_MEAN == jvd.DEFAULT_MEAN and tvd.DEFAULT_STD == jvd.DEFAULT_STD

    @pytest.mark.parametrize("train", [True, False])
    def test_batches_as_jax(self, train, monkeypatch):
        """The same records and decoded frames give the same clips, labels
        and paths (random offset, crop and flip from the same seed; cv2's
        resize of the short side to im_scale)."""
        records = [tvd.VideoRecord(f"v{i}.mp4", i % 3) for i in range(5)]
        kw = dict(sample_length=FRAMES, input_size=SIZE, im_scale=12, seed=2)
        if not train:
            kw.update(random_offset=False, random_crop=False, random_flip=False)
        tds = tvd.VideoDataset(records, **kw)
        jds = jvd.VideoDataset([jvd.VideoRecord(r.path, r.label) for r in records], **kw)
        monkeypatch.setattr(tds, "_decode", _frames)
        monkeypatch.setattr(jds, "_decode", _frames)
        got = list(tds.batches(2, drop_remainder=False, shuffle=train))
        want = list(jds.batches(2, drop_remainder=False, shuffle=train))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["video"], w["video"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
            assert g["paths"] == w["paths"] and g["video"].dtype == np.uint8

    def test_decode_without_cv2_raises_and_no_resize_needs_none(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "cv2", None)
        ds = tvd.VideoDataset([tvd.VideoRecord("v.mp4", 0)], sample_length=FRAMES,
                              input_size=SIZE, im_scale=20)
        with pytest.raises(RuntimeError, match="cv2"):
            ds.load_clip(ds.records[0])
        monkeypatch.setattr(ds, "_decode", _frames)  # short side 20 = im_scale: no resize
        assert ds.load_clip(ds.records[0]).shape == (FRAMES, SIZE, SIZE, 3)

    def test_real_decode_as_jax(self, tmp_path):
        """A video written by OpenCV decodes to the JAX package's frames."""
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (24, 16))
        for f in np.random.default_rng(0).integers(0, 256, (6, 16, 24, 3), dtype=np.uint8):
            w.write(f)
        w.release()
        rec = [tvd.VideoRecord(path, 1)]
        got = tvd.VideoDataset(rec, sample_length=FRAMES, input_size=SIZE, im_scale=12,
                               random_offset=False, random_crop=False, random_flip=False)
        want = jvd.VideoDataset([jvd.VideoRecord(path, 1)], sample_length=FRAMES, input_size=SIZE,
                                im_scale=12, random_offset=False, random_crop=False,
                                random_flip=False)
        np.testing.assert_array_equal(got.load_clip(rec[0]), want.load_clip(want.records[0]))


# ---------------- the runners ----------------

def _jax_victim(*a, **kw):
    return jax_linear()


def _torch_victim(model_name, ckpt_path, compute_dtype, frames, size, device=None, **kw):
    return LinearVictim()


def _records(rng, n):
    """Records labelled with the linear victim's clean prediction of the
    center crop of their stub frames, resized as the runners resize them."""
    out = []
    for i in range(n):
        path = f"vid{i}.mp4"
        ds = tvd.VideoDataset([tvd.VideoRecord(path, 0)], sample_length=FRAMES, input_size=SIZE,
                              random_offset=False, random_crop=False, random_flip=False)
        ds._decode = _frames
        x = (ds.load_clip(ds.records[0]).astype(np.float32) / 255.0 - np.float32(
            tvd.DEFAULT_MEAN)) / np.float32(tvd.DEFAULT_STD)
        out.append(tvd.VideoRecord(path, int((x.mean(axis=(0, 1, 2)) @ W).argmax())))
    return out


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' torch runners on the linear victims and the stub
    decoder (frames of 20x30: im_scale 128 resizes them with cv2)."""
    monkeypatch.setattr(juniversal, "build_victim", _jax_victim)
    monkeypatch.setattr(jper_video, "build_victim", _jax_victim)
    monkeypatch.setattr(tuniversal, "build_victim", _torch_victim)
    monkeypatch.setattr(tper_video, "build_victim", _torch_victim)
    monkeypatch.setattr(jvd.VideoDataset, "_decode", lambda self, p: _frames(p))
    monkeypatch.setattr(tvd.VideoDataset, "_decode", lambda self, p: _frames(p))

    def jax_draw(spec, device=None, dtype=torch.float32, generator=None):
        return torch.from_numpy(np.asarray(jpert.init_delta(JSpec(frames=spec.frames),
                                                            jax.random.key(0))))

    monkeypatch.setattr(tpert, "init_delta", jax_draw)  # the JAX runners' default key(0)
    _hand_over_the_jax_draw(monkeypatch)


class TestTorchRunners:
    def test_torch_universal_as_jax_and_resume(self, stubbed, rng, tmp_path):
        records = _records(rng, 6)
        kw = dict(train_records=records[:4], valid_records=records[4:], epochs=2, lr=1e-2,
                  batch_size=2, sample_length=FRAMES, input_size=SIZE)
        with contextlib.redirect_stdout(io.StringIO()):
            want = juniversal.run("r2plus1d_18", model_dir=str(tmp_path / "j"),
                                  compute_dtype=jnp.float32, **kw)
            got = tuniversal.run("r2plus1d_18", model_dir=str(tmp_path / "t"), device="cpu",
                                 compute_dtype=torch.float32, **kw)
        for g, w in zip(got, want):
            for k in ("train/loss", "train/fooling_ratio", "valid/fooling_ratio",
                      "valid/pert_thickness", "valid/perturbation"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            more = tuniversal.run("r2plus1d_18", model_dir=str(tmp_path / "t"), device="cpu",
                                  **{**kw, "epochs": 3})
        assert "resuming from epoch 2" in said.getvalue() and len(more) == 1
        assert tuniversal.BATCH_SIZES == juniversal.BATCH_SIZES

    def test_torch_per_video_as_jax(self, stubbed, rng, tmp_path):
        records = _records(rng, 3)
        records[2] = tvd.VideoRecord(records[2].path, (records[2].label + 1) % K)
        labels = [f"class {i}" for i in range(K)]
        kw = dict(label_names=labels, n_iter=30, sample_length=FRAMES, input_size=SIZE)
        want = jper_video.run("r2plus1d_18", records=[jvd.VideoRecord(r.path, r.label)
                                                      for r in records],
                              model_dir=str(tmp_path / "j"), compute_dtype=jnp.float32, **kw)
        got = tper_video.run("r2plus1d_18", records=records, model_dir=str(tmp_path / "t"),
                             device="cpu", **kw)
        assert {k: v for k, v in got.items() if k != "results"} == {
            k: v for k, v in want.items() if k != "results"}
        assert got["skipped_misclassified"] == 1
        assert [f for _, f in got["results"]] == [f for _, f in want["results"]]

    def test_build_split_as_jax(self, tmp_path):
        for cls in ("a", "b"):
            os.makedirs(tmp_path / cls)
            for i in range(4):
                (tmp_path / cls / f"{i}.mp4").write_bytes(b"")
        got = tper_video.build_split(str(tmp_path), ["a", "b"], 5)
        want = jper_video.build_split(str(tmp_path), ["a", "b"], 5)
        assert [vars(r) for r in got] == [vars(r) for r in want] and len(got) == 5

    @pytest.mark.parametrize("module", [tuniversal, tper_video])
    def test_cli_help(self, module, capsys):
        with pytest.raises(SystemExit) as e:
            module.main(["--help"])
        assert e.value.code == 0 and "--device" in capsys.readouterr().out

    @pytest.mark.parametrize("kw,item", [(dict(slots=2), "item 10's rest"),
                                         (dict(use_mesh=True), "item 11")])
    def test_unported_options_raise(self, kw, item):
        with pytest.raises(NotImplementedError, match=item):
            tper_video.run(records=[], label_names=[], device="cpu", **kw)

    @pytest.mark.parametrize("variant", ["r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34"])
    def test_build_engine_takes_the_torch_world(self, variant, monkeypatch):
        """MODEL_NAME of a video ResNet: the mean/std spec with L_INF_NORM,
        the torch weighting, the seeded random victim when no checkpoint
        exists, no host prepack, and ATTACK_FRAME_WINDOW refused."""
        cfg = tconfig.default_config()
        ac = cfg.UNIVERSAL_ATTACK
        ac.MODEL_NAME, ac.L_INF_NORM, ac.COMPUTE_DTYPE = variant, 0.1, "float32"
        cfg.MODEL.CKPT_PATH = "/nonexistent.pth"
        with contextlib.redirect_stdout(io.StringIO()) as said:
            engine, labels = tcommon.build_engine(ac, cfg.MODEL, frames=FRAMES, size=SIZE,
                                                  device="cpu")
        assert "[warn]" in said.getvalue() and len(labels) == 400
        assert isinstance(engine.spec, TorchStyleFlickerSpec) and engine.spec.max_norm == 0.1
        assert engine.spec.shape == (FRAMES, 1, 1, 3)
        assert engine.config.norm_world == "meanstd" and engine.config.reg_weighting == "torch"
        assert isinstance(engine.model, VideoResNet) and engine.model.variant == variant
        _, prepack = tcommon.make_shard_batches(ac, engine, None, frames=FRAMES, size=SIZE,
                                                batch_size=2)
        assert prepack is False
        ac.ATTACK_FRAME_WINDOW = [0, 1]
        with pytest.raises(ValueError, match="frame_window"), \
                contextlib.redirect_stdout(io.StringIO()):
            tcommon.build_engine(ac, cfg.MODEL, frames=FRAMES, size=SIZE, device="cpu")

    def test_single_video_attack_starts_from_the_small_uniform_delta(self, rng, monkeypatch):
        """single_video_attack on a mean/std engine starts from
        U(-1e-6, 1e-6), drawn by `init_generator` (seed 0 when None, as the
        JAX loop's default key)."""
        _, te = engines()
        batch = self_labelled(rng)[0]
        starts = []
        init = te.init_state
        monkeypatch.setattr(te, "init_state", lambda g=None: starts.append(init(g)) or starts[-1])
        for g in (None, torch.Generator().manual_seed(0), torch.Generator().manual_seed(9)):
            single_video_attack(te, batch["video"][0], int(batch["labels"][0]),
                                RuntimeFlags(max_norm=0.2), max_step=0, stop_rule="early",
                                hard_cap=1, init_generator=g)
        d = [s.delta.clone() for s in starts]
        assert all(0 < x.abs().max() <= 1e-6 for x in d)
        assert torch.equal(d[0], d[1]) and not torch.equal(d[0], d[2])
