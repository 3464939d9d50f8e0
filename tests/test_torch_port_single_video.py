"""The port's single-video attack, class-gen runner and inference wrapper held
against the JAX package's: ``engine/loops.single_video_attack``,
``runners/single_video.run``, ``runners/class_gen.run``, ``engine/inference``,
``data/npy`` and ``viz/results``.

Loops and runners use the tiny linear victim of ``tests/test_runners_e2e.py``
(logits = mean over T,H,W of the clip times a [3,400] matrix), built in both
packages from the same numpy matrix through the same seam (monkeypatching
each package's ``common.build_victim``), on the same clips with the same
config: T=4, 16x16, f32.  Tolerances: delta 1e-6 absolute against Adam steps
of 1e-3; histories 1e-5 relative (f32 reassociation) plus 1e-7 absolute: from
the second step on the regularizers are norms of a delta of 1e-3 whose
components differ by up to 1e-8 between the packages (Adam's g / (|g| + eps)
on gradient components near eps), and they enter the total.  The real I3D
runs once, at frames=8, size=32, with the index-pair pools switched on by the
environment as the runners read it.
"""

import contextlib
import io
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.data import npy as jnpy
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu.engine import loops as jloops
from flickering_adversarial_video_tpu.engine.inference import InferenceModel as JaxInferenceModel
from flickering_adversarial_video_tpu.runners import class_gen as jclass_gen
from flickering_adversarial_video_tpu.runners import common as jcommon
from flickering_adversarial_video_tpu.runners import single_video as jsingle
from flickering_adversarial_video_tpu.utils import config as jconfig
from flickering_adversarial_video_tpu.viz import results as jresults
from flickering_adversarial_video_tpu_torch.data import npy as tnpy
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.engine import loops as tloops
from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
from flickering_adversarial_video_tpu_torch.engine.inference import InferenceModel
from flickering_adversarial_video_tpu_torch.ops import pool_strided
from flickering_adversarial_video_tpu_torch.runners import class_gen as tclass_gen
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import single_video as tsingle
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils.labels import kinetics400_labels
from flickering_adversarial_video_tpu_torch.viz import results as tresults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, SIZE = 4, 16
W_LINEAR = (np.random.default_rng(5).standard_normal((3, 400)) * 4.0).astype(np.float32)
LABELS = kinetics400_labels()
HISTORY_KEYS = ("total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l",
                "diff_norm_reg_loss_l", "fatness", "smoothness")
RESULT_KEYS = {
    "correct_cls_id", "correct_cls_prob", "softmax_init", "rgb_sample", "total_loss_l",
    "adv_loss_l", "reg_loss_l", "norm_reg_loss_l", "diff_norm_reg_loss_l", "perturbation",
    "adv_video", "softmax", "total_steps", "beta_0", "beta_1", "beta_2", "beta_3", "fatness",
    "smoothness", "is_adversarial", "final_delta", "steps_per_sec",
}


class LinearVictim(torch.nn.Module):
    def __init__(self, device):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(W_LINEAR).to(device))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w


def _jax_victim(model_name, ckpt_path, compute_dtype, frames, size, **kw):
    w = jnp.asarray(W_LINEAR)
    return (lambda variables, x: jnp.mean(x, axis=(1, 2, 3)) @ variables["w"]), {"w": w}


def _torch_victim(model_name, ckpt_path, compute_dtype, frames, size, device=None, **kw):
    return LinearVictim(torch.device(device))


def _patch_victims(mp):
    mp.setattr(jcommon, "build_victim", _jax_victim)
    mp.setattr(tcommon, "build_victim", _torch_victim)


def _clips(n, seed=29):
    """(float32 clip [1,T,H,W,3] in [-1,1], the linear victim's clean class)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = rng.integers(0, 255, (FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
        x = c.astype(np.float32) / 128.0 - 1.0
        out.append((x[None], int((x.mean(axis=(0, 1, 2)) @ W_LINEAR).argmax())))
    return out


def _close_lists(got, want, rel=1e-5):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-7)


@pytest.fixture
def engines(monkeypatch):
    _patch_victims(monkeypatch)
    ac = tconfig.default_config().SINGLE_VIDEO_ATTACK
    ac.COMPUTE_DTYPE = "float32"
    jeng, _ = jcommon.build_engine(ac, jconfig.default_config().MODEL, frames=FRAMES, size=SIZE)
    teng, _ = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES, size=SIZE,
                                   device="cpu")
    return jeng, teng, ac


# ---------------- npy clips and result files ----------------

class TestNpyAndResults:
    def test_npy_tools_equal_the_jax_packages(self, tmp_path):
        name = "rgb_abc@playing_guitar.npy"
        assert tnpy.parse_label_from_filename(f"/x/{name}") == "playing guitar"
        assert tnpy.parse_label_from_filename(name) == jnpy.parse_label_from_filename(name)
        clip = np.random.default_rng(0).uniform(-1, 1, (6, 4, 4, 3))
        tnpy.save_npy_clip(str(tmp_path / name), clip)
        jnpy.save_npy_clip(str(tmp_path / "j.npy"), clip)
        assert (tmp_path / name).read_bytes() == (tmp_path / "j.npy").read_bytes()
        (tmp_path / "notes.txt").write_text("x")
        assert tnpy.list_npy_videos(str(tmp_path)) == jnpy.list_npy_videos(str(tmp_path))
        got = tnpy.load_npy_clip(str(tmp_path / name), frames=4)
        want = jnpy.load_npy_clip(str(tmp_path / name), frames=4)
        assert got.shape == (1, 4, 4, 4, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], clip[-4:].astype(np.float32))

    def test_result_files_equal_the_jax_packages(self, tmp_path):
        args = ("playing guitar", 0.5, 3.14159, 0.271828)
        assert tresults.result_filename(*args) == jresults.result_filename(*args)
        assert tresults.result_filename(*args) == "playing_guitar_beta1_0.5_th_3.14%_rg_0.27%.pkl"
        res = {"fatness": [1.0, 2.5], "smoothness": [0.25], "beta_1": 0.5, "x": np.arange(3)}
        tp = tresults.save_result_pkl(res, str(tmp_path / "t"), "abseiling")
        jp = jresults.save_result_pkl(res, str(tmp_path / "j"), "abseiling")
        assert os.path.basename(tp) == os.path.basename(jp)
        back = jresults.load_result(tp)  # the JAX package reads the port's file
        assert back["fatness"] == [1.0, 2.5] and tresults.load_result(jp)["beta_1"] == 0.5
        assert os.path.basename(tresults.save_result_pkl({}, str(tmp_path / "t"), "a b")) == \
            "a_b_beta1_0.0_th_0.00%_rg_0.00%.pkl"


# ---------------- the loop ----------------

class TestSingleVideoAttack:
    @pytest.mark.parametrize("stop_rule,max_step", [("reference", 6), ("early", 400)])
    def test_matches_the_jax_loop(self, engines, stop_rule, max_step):
        jeng, teng, ac = engines
        clip, label = _clips(1)[0]
        kw = dict(max_step=max_step, stop_rule=stop_rule, seed=3)
        want = jloops.single_video_attack(jeng, clip, label, jloops.flags_from_config(ac), **kw)
        got = tloops.single_video_attack(teng, clip, label, tloops.flags_from_config(ac), **kw)
        assert set(got) == set(want) == RESULT_KEYS
        assert got["total_steps"] == want["total_steps"]
        assert got["is_adversarial"] is True and want["is_adversarial"]
        if stop_rule == "reference":
            assert got["total_steps"] > max_step  # never stops early
        for k in HISTORY_KEYS:
            assert len(got[k]) == got["total_steps"] + 1
            _close_lists(got[k], want[k])
        for k in ("perturbation", "softmax"):
            assert len(got[k]) == len(want[k]) == got["total_steps"] + 1
        for g, w in zip(got["perturbation"], want["perturbation"]):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["softmax"][-1], np.asarray(want["softmax"][-1]), atol=1e-6)
        np.testing.assert_allclose(got["final_delta"], np.asarray(want["final_delta"]),
                                   atol=1e-6, rtol=0)
        assert np.abs(got["final_delta"]).max() > 0
        np.testing.assert_allclose(got["adv_video"], np.asarray(want["adv_video"]), atol=1e-6)
        np.testing.assert_allclose(got["softmax_init"], np.asarray(want["softmax_init"]), atol=1e-6)
        np.testing.assert_array_equal(got["rgb_sample"], np.asarray(want["rgb_sample"]))
        for k in ("correct_cls_id", "beta_0", "beta_1", "beta_2", "beta_3"):
            assert got[k] == want[k]
        assert got["correct_cls_prob"] == pytest.approx(want["correct_cls_prob"], rel=1e-5)
        assert got["steps_per_sec"] > 0

    def test_result_holds_numpy_and_python_values_only(self, engines):
        _, teng, ac = engines
        clip, label = _clips(1)[0]
        res = tloops.single_video_attack(teng, clip, label, tloops.flags_from_config(ac),
                                         max_step=2, stop_rule="early")

        def plain(v):
            if isinstance(v, (list, tuple)):
                return all(plain(u) for u in v)
            return isinstance(v, (np.ndarray, float, int, bool))

        assert all(plain(v) for v in res.values()), {k: type(v) for k, v in res.items()}
        assert res["perturbation"][0].shape == (FRAMES, 1, 1, 3)
        assert res["softmax"][0].shape == (1, 400) and res["adv_video"].shape == clip.shape

    def test_clean_miss_is_skipped_in_both(self, engines):
        jeng, teng, ac = engines
        clip, label = _clips(1)[0]
        wrong = (label + 1) % 400
        assert jloops.single_video_attack(jeng, clip, wrong, jloops.flags_from_config(ac)) is None
        assert tloops.single_video_attack(teng, clip, wrong, tloops.flags_from_config(ac)) is None

    def test_hard_cap_and_untracked_history(self, engines):
        jeng, teng, ac = engines
        clip, label = _clips(1)[0]
        kw = dict(max_step=50, hard_cap=3, track_history=False)
        want = jloops.single_video_attack(jeng, clip, label, jloops.flags_from_config(ac), **kw)
        got = tloops.single_video_attack(teng, clip, label, tloops.flags_from_config(ac), **kw)
        assert got["total_steps"] == want["total_steps"] == 3
        assert got["total_loss_l"] == want["total_loss_l"] == []
        assert got["is_adversarial"] == bool(want["is_adversarial"])
        np.testing.assert_allclose(got["final_delta"], np.asarray(want["final_delta"]), atol=1e-6)

    def test_targeted_label_and_log_fn(self, monkeypatch):
        _patch_victims(monkeypatch)
        ac = tconfig.default_config().SINGLE_VIDEO_ATTACK
        ac.COMPUTE_DTYPE, ac.TARGETED_ATTACK, ac.TARGETED_CLASS = "float32", True, LABELS[7]
        jeng, _ = jcommon.build_engine(ac, jconfig.default_config().MODEL, frames=FRAMES, size=SIZE)
        teng, _ = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES, size=SIZE,
                                       device="cpu")
        clip, label = _clips(1)[0]
        seen = []
        kw = dict(target_label=7, max_step=4, hard_cap=8)
        want = jloops.single_video_attack(jeng, clip, label, jloops.flags_from_config(ac), **kw)
        got = tloops.single_video_attack(
            teng, clip, label, tloops.flags_from_config(ac),
            log_fn=lambda step, m: seen.append((step, float(m["total_loss"]))), **kw)
        assert got["correct_cls_id"] == label and got["total_steps"] == want["total_steps"]
        _close_lists(got["total_loss_l"], want["total_loss_l"])
        assert [s for s, _ in seen] == list(range(got["total_steps"] + 1))
        _close_lists([v for _, v in seen], got["total_loss_l"], rel=1e-6)


# ---------------- the single-video runner ----------------

def _npy_dir(root):
    """Two self-labelled clips and one named with a wrong class."""
    d = root / "npy"
    d.mkdir()
    clips = _clips(3)
    for i, (clip, label) in enumerate(clips):
        cls = label if i < 2 else (label + 1) % 400
        np.save(d / f"rgb_vid{i}@{LABELS[cls].replace(' ', '_')}.npy", clip)
    return str(d), clips


def _sv_cfg(module, npy_dir, out_dir, **over):
    cfg = module.default_config()
    ac = cfg.SINGLE_VIDEO_ATTACK
    ac.NPY_PATH, ac.PKL_RESULT_PATH = npy_dir, str(out_dir)
    ac.COMPUTE_DTYPE, ac.MAX_NUM_STEP = "float32", 5
    for k, v in over.items():
        ac[k] = v
    return cfg


@pytest.fixture(scope="module")
def sv_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("single_video")
    npy_dir, clips = _npy_dir(root)
    out = {"clips": clips, "npy_dir": npy_dir}
    with pytest.MonkeyPatch.context() as mp:
        _patch_victims(mp)
        out["jax"] = jsingle.run(_sv_cfg(jconfig, npy_dir, root / "jax_out"), frames=FRAMES)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["torch"] = tsingle.run(_sv_cfg(tconfig, npy_dir, root / "torch_out"),
                                       frames=FRAMES, device="cpu")
        out["stdout"] = text.getvalue()
    return out


class TestSingleVideoRunner:
    def test_files_and_skip(self, sv_runs):
        got, want = sv_runs["torch"], sv_runs["jax"]
        assert len(got) == len(want) == 2  # the third clip's name is wrong: skipped
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert "skip video" in sv_runs["stdout"] and "clean model misclassifies" in sv_runs["stdout"]
        assert sv_runs["stdout"].count("fooled=True") == 2 and "steps/s)" in sv_runs["stdout"]

    def test_pkls_match_the_jax_runners(self, sv_runs):
        for tp, jp in zip(sv_runs["torch"], sv_runs["jax"]):
            with open(tp, "rb") as f:
                got = pickle.load(f)
            with open(jp, "rb") as f:
                want = pickle.load(f)
            assert set(got) == set(want) == RESULT_KEYS | {"correct_cls"}
            assert got["correct_cls"] == want["correct_cls"]
            assert got["total_steps"] == want["total_steps"] > 5
            for k in HISTORY_KEYS:
                _close_lists(got[k], want[k])
            np.testing.assert_allclose(got["final_delta"], np.asarray(want["final_delta"]),
                                       atol=1e-6, rtol=0)

    def test_pkl_loads_without_torch(self, sv_runs):
        code = (
            "import pickle, sys\n"
            "res = pickle.load(open(sys.argv[1], 'rb'))\n"
            "assert 'torch' not in sys.modules\n"
            "print(res['total_steps'], res['final_delta'].shape)\n"
        )
        import subprocess

        out = subprocess.run([sys.executable, "-c", code, sv_runs["torch"][0]],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split()[1:] == ["(4,", "1,", "1,", "3)"]

    def test_max_videos_and_missing_path(self, sv_runs, tmp_path, monkeypatch, capsys):
        _patch_victims(monkeypatch)
        cfg = _sv_cfg(tconfig, sv_runs["npy_dir"], tmp_path / "o")
        assert len(tsingle.run(cfg, frames=FRAMES, stop_rule="early", max_videos=1,
                               device="cpu")) == 1
        cfg = _sv_cfg(tconfig, str(tmp_path / "nowhere"), tmp_path / "o")
        assert tsingle.run(cfg, frames=FRAMES, device="cpu") == []
        assert "does not exist" in capsys.readouterr().out

    @pytest.mark.parametrize("kw,over,world,error,match", [
        # slots without --mesh under 2 ranks: no split, refused
        (dict(slots=2), {}, "2", ValueError, "--slots .* --mesh"),
        # the dashboard is per clip: with slots the runner warns and goes on
        (dict(dashboard_path="d.png"), {"SLOTS": 2}, None, None, "[warn] live dashboard"),
        # --mesh at one slot under 2 ranks: no split, refused
        (dict(use_mesh=True), {}, "2", ValueError, "--slots .* --mesh"),
        # one clip at a time: the dashboard's PNG
        (dict(dashboard_path="d.png"), {}, None, None, "png"),
    ])
    def test_unported_options_raise(self, sv_runs, tmp_path, monkeypatch, kw, over, world,
                                    error, match):
        """A torchrun launch of several ranks without the slots' split is
        refused, naming it.  The live dashboard (error None) draws its PNG
        one clip at a time, and with slots warns and goes on without it, as
        the JAX runner does; the pkls are the run's without it."""
        _patch_victims(monkeypatch)
        if world is not None:
            monkeypatch.setenv("WORLD_SIZE", world)
        cfg = _sv_cfg(tconfig, sv_runs["npy_dir"], tmp_path / "o", **over)
        if error is not None:
            with pytest.raises(error, match=match):
                tsingle.run(cfg, frames=FRAMES, device="cpu", **kw)
            return
        png = tmp_path / kw["dashboard_path"]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            got = tsingle.run(cfg, frames=FRAMES, device="cpu", dashboard_path=str(png))
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in sv_runs["torch"]]
        if match == "png":
            assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
            assert "[warn]" not in text.getvalue()
        else:
            assert match in text.getvalue() and not png.exists()

    def test_cli(self, monkeypatch):
        with pytest.raises(SystemExit) as e:
            tsingle.main(["--help"])
        assert e.value.code == 0
        seen = {}
        monkeypatch.setattr(tsingle, "run", lambda cfg, **kw: seen.update(kw, cfg=cfg))
        tsingle.main([os.path.join(REPO, "configs", "run_config.yml"), "--frames", "8", "--size",
                      "32", "--stop-rule", "early", "--max-videos", "2", "--device", "cpu"])
        assert (seen["frames"], seen["size"], seen["stop_rule"], seen["max_videos"],
                seen["device"]) == (8, 32, "early", 2, "cpu")
        assert seen["cfg"].SINGLE_VIDEO_ATTACK.MAX_NUM_STEP == 2500

    def test_no_cuda_and_no_cpu_request_raises(self, sv_runs, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _sv_cfg(tconfig, sv_runs["npy_dir"], tmp_path / "o")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsingle.run(cfg, frames=FRAMES, size=SIZE)


# ---------------- the class-gen runner ----------------

def _shards(shard_dir, n_shards=1, per_shard=8):
    rng = np.random.default_rng(13)
    os.makedirs(shard_dir, exist_ok=True)
    for s in range(n_shards):
        with ttfr.TFRecordWriter(os.path.join(shard_dir, f"shard{s}.tfrecords")) as w:
            for _ in range(per_shard):
                c = rng.integers(0, 255, (FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
                x = c.astype(np.float32) / 128.0 - 1.0
                w.write(ttfr.make_uint8_example(c, int((x.mean(axis=(0, 1, 2)) @ W_LINEAR).argmax())))
    return str(shard_dir)


def _cg_cfg(module, shard_dir, out_dir, max_step):
    cfg = module.default_config()
    ac = cfg.CLASS_GEN_ATTACK
    ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shard_dir]
    ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = 1
    ac.BATCH_SIZE, ac.MAX_NUM_STEP = 4, max_step
    ac.PKL_RESULT_PATH, ac.COMPUTE_DTYPE = str(out_dir) + "/", "float32"
    return cfg


@pytest.fixture(scope="module")
def cg_runs(tmp_path_factory):
    """Both class-gen runners: 2 epochs of 2 batches, then a resume to 8."""
    root = tmp_path_factory.mktemp("class_gen")
    shard_dir = _shards(root / "shards")
    out = {"root": root}
    with pytest.MonkeyPatch.context() as mp:
        _patch_victims(mp)
        mp.setitem(sys.modules, "tensorboardX", None)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(jclass_gen, "tfrecord_batches",
                   lambda shards, bs, frames=None, **kw: jtfr.tfrecord_batches(
                       shards, bs, frames=frames,
                       **{**kw, "height": SIZE, "width": SIZE, "use_native": False}))
        mp.setattr(tclass_gen, "tfrecord_batches",
                   lambda shards, bs, frames=None, **kw: ttfr.tfrecord_batches(
                       shards, bs, frames=frames, **{**kw, "height": SIZE, "width": SIZE}))
        for steps, tag in ((4, "first"), (8, "resumed")):
            out[f"jax_{tag}"] = jclass_gen.run(_cg_cfg(jconfig, shard_dir, root / "jax_out", steps),
                                               frames=FRAMES)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                out[f"torch_{tag}"] = tclass_gen.run(
                    _cg_cfg(tconfig, shard_dir, root / "torch_out", steps), frames=FRAMES,
                    device="cpu")
            out[f"stdout_{tag}"] = text.getvalue()
            with open(root / "torch_out" / "res.pkl", "rb") as f:
                out[f"torch_res_{tag}"] = pickle.load(f)
            with open(root / "jax_out" / "res.pkl", "rb") as f:
                out[f"jax_res_{tag}"] = pickle.load(f)
    return out


class TestClassGenRunner:
    def test_first_run_matches_the_jax_runner(self, cg_runs):
        got, want = cg_runs["torch_first"], cg_runs["jax_first"]
        assert got["steps"] == want["steps"] == 4
        # an epoch is 2 batches: evals at 0, 2, 4 (epoch ends) and the final one
        assert got["history"]["fool_rate_steps"] == want["history"]["fool_rate_steps"] == [0, 2, 4, 4]
        assert got["history"]["fool_rate"] == pytest.approx(want["history"]["fool_rate"])
        assert got["final_eval"] == want["final_eval"]
        np.testing.assert_allclose(got["state"].delta.numpy(), np.asarray(want["state"].delta),
                                   atol=1e-6, rtol=0)
        assert "resumed from" not in cg_runs["stdout_first"]

    def test_res_pkl_keys_and_values(self, cg_runs):
        got, want = cg_runs["torch_res_first"], cg_runs["jax_res_first"]
        assert set(got) == set(want) == {
            "total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l", "diff_norm_reg_loss_l",
            "perturbation", "total_steps", "beta_1", "beta_2", "fatness", "smoothness", "fool_rate"}
        assert got["total_steps"] == want["total_steps"] == 4
        assert (got["beta_1"], got["beta_2"]) == (want["beta_1"], want["beta_2"])
        for k in HISTORY_KEYS:
            _close_lists(got[k], want[k])  # step 1 only: log_every is 50
        assert len(got["perturbation"]) == len(want["perturbation"]) == 2
        for g, w in zip(got["perturbation"], want["perturbation"]):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)

    def test_epoch_end_checkpoints_and_resume(self, cg_runs):
        ck = AttackCheckpointer(os.path.join(str(cg_runs["root"] / "torch_out"), "ckpt"))
        assert ck.steps() == [2, 4, 6, 8]
        assert "resumed from step 4" in cg_runs["stdout_resumed"]
        got, want = cg_runs["torch_resumed"], cg_runs["jax_resumed"]
        assert got["steps"] == want["steps"] == 8 and got["state"].step == 8
        assert got["history"]["fool_rate_steps"] == want["history"]["fool_rate_steps"] == [4, 6, 8, 8]
        np.testing.assert_allclose(got["state"].delta.numpy(), np.asarray(want["state"].delta),
                                   atol=1e-6, rtol=0)
        assert cg_runs["torch_res_resumed"]["total_steps"] == 8

    def test_cli(self, monkeypatch):
        with pytest.raises(SystemExit) as e:
            tclass_gen.main(["--help"])
        assert e.value.code == 0
        seen = {}
        monkeypatch.setattr(tclass_gen, "run", lambda cfg, **kw: seen.update(kw, cfg=cfg))
        tclass_gen.main([os.path.join(REPO, "configs", "run_config.yml"), "--frames", "8",
                         "--size", "32", "--max-steps", "3", "--device", "cpu"])
        assert (seen["frames"], seen["size"], seen["max_steps"], seen["device"]) == (8, 32, 3, "cpu")

    def test_no_cuda_and_no_cpu_request_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _cg_cfg(tconfig, str(tmp_path), tmp_path / "o", 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tclass_gen.run(cfg, frames=FRAMES, size=SIZE)


# ---------------- the inference wrapper ----------------

class TestInferenceModel:
    def test_call_and_evaluate_match_the_jax_wrapper(self, engines, capsys):
        jeng, teng, _ = engines
        rng = np.random.default_rng(31)
        delta = rng.uniform(-0.3, 0.3, (FRAMES, 1, 1, 3)).astype(np.float32)
        clips = rng.uniform(-1, 1, (3, FRAMES, SIZE, SIZE, 3)).astype(np.float32)
        jm, tm = JaxInferenceModel(jeng), InferenceModel(teng)
        np.testing.assert_allclose(tm(clips[0]), jm(clips[0]), atol=1e-6)  # 4-D: one clip
        jm.load_perturbation(delta)
        tm.load_perturbation(delta)
        clean, adv = tm(clips), tm(clips, adv_flag=1.0)
        assert clean.shape == (3, 400) and isinstance(adv, np.ndarray)
        np.testing.assert_allclose(clean, jm(clips), atol=1e-6)
        np.testing.assert_allclose(adv, jm(clips, adv_flag=1.0), atol=1e-6)
        assert np.abs(adv - clean).max() > 1e-4
        np.testing.assert_allclose(InferenceModel(teng, delta)(clips, adv_flag=1.0), adv)
        label = int(clean.sum(axis=0).argmax())
        samples = [(clips, label), (clips[0], label + 1)]
        got, want = tm.evaluate(samples, verbose=True), jm.evaluate(samples, verbose=False)
        assert "Video prediction accuracy" in capsys.readouterr().out
        for k in ("video_preds", "video_trues", "clip_preds", "clip_trues", "video_accuracy",
                  "clip_accuracy"):
            assert got[k] == want[k], k
        assert len(got["infer_times"]) == 2 and min(got["infer_times"]) > 0

    @pytest.mark.parametrize("kw", [dict(cyclic_input_flag=1.0), dict(cyclic_eps_flag=1.0)])
    def test_cyclic_flags_raise(self, engines, kw):
        """On an engine built without the cyclic modes the flags are inert in
        both packages (the rolls are not compiled in); with them,
        tests/test_torch_port_sparse_cyclic.py."""
        jeng, teng, _ = engines
        clips = np.random.default_rng(3).uniform(-1, 1, (2, FRAMES, SIZE, SIZE, 3))
        clips = clips.astype(np.float32)
        delta = np.random.default_rng(4).uniform(-0.3, 0.3, (FRAMES, 1, 1, 3)).astype(np.float32)
        got = InferenceModel(teng, delta)(clips, adv_flag=1.0, **kw)
        np.testing.assert_array_equal(got, InferenceModel(teng, delta)(clips, adv_flag=1.0))
        np.testing.assert_allclose(got, JaxInferenceModel(jeng, delta)(clips, adv_flag=1.0, **kw),
                                   atol=1e-6)


# ---------------- the real I3D, once ----------------

class TestRealI3DWithThePairSwitch:
    @pytest.mark.parametrize("env,want", [
        ({}, ()),
        ({"FLICKER_POOL_PALLAS_2A": "1"}, ()),
        ({"FLICKER_POOL_PALLAS_2A": "2"}, ("MaxPool3d_2a_3x3",)),
        ({"FLICKER_POOL_PALLAS_2A": "2", "FLICKER_POOL_PALLAS_3A": "1"},
         ("MaxPool3d_2a_3x3", "MaxPool3d_3a_3x3")),
        ({"FLICKER_POOL_PALLAS_3A": "1"}, ()),
    ])
    def test_switches_read_from_the_environment(self, env, want):
        assert tcommon.pair_pools_from_env(env) == want

    def test_runner_on_i3d_with_and_without_the_pair(self, tmp_path, monkeypatch):
        """frames=8, size=32, f32, seeded random weights: the clip is named
        with the model's own clean class; both configurations take the same
        steps to the same delta (the pair changes what the pools save, not
        what they compute), and the pair's wrappers are what ran."""
        monkeypatch.delenv("FLICKER_POOL_PALLAS_2A", raising=False)
        monkeypatch.delenv("FLICKER_POOL_PALLAS_3A", raising=False)
        cfg = tconfig.default_config()
        cfg.SINGLE_VIDEO_ATTACK.COMPUTE_DTYPE = "float32"
        with contextlib.redirect_stdout(io.StringIO()):
            eng, labels = tcommon.build_engine(cfg.SINGLE_VIDEO_ATTACK, cfg.MODEL, frames=8,
                                               size=32, device="cpu")
        assert eng.model.pair_pools == ()
        clip = np.random.default_rng(2).uniform(-1, 1, (1, 8, 32, 32, 3)).astype(np.float32)
        top = int(InferenceModel(eng)(clip).argmax())
        npy = tmp_path / "npy"
        npy.mkdir()
        tnpy.save_npy_clip(str(npy / f"rgb_v@{labels[top].replace(' ', '_')}.npy"), clip)
        calls = []
        real = pool_strided.max_pool_133_s2_pair
        monkeypatch.setattr("flickering_adversarial_video_tpu_torch.models.i3d.max_pool_133_s2_pair",
                            lambda x: calls.append(tuple(x.shape)) or real(x))
        res = {}
        for pair in (False, True):
            if pair:
                monkeypatch.setenv("FLICKER_POOL_PALLAS_2A", "2")
                monkeypatch.setenv("FLICKER_POOL_PALLAS_3A", "1")
            c = _sv_cfg(tconfig, str(npy), tmp_path / f"out{int(pair)}", MAX_NUM_STEP=1)
            with contextlib.redirect_stdout(io.StringIO()):
                (path,) = tsingle.run(c, frames=8, size=32, device="cpu")
            if not pair:
                assert calls == []
            res[pair] = tresults.load_result(path)
        # per forward: MaxPool3d_2a then 3a; the clean forward and every step
        assert calls[:2] == [(1, 4, 16, 16, 64), (1, 4, 8, 8, 192)]
        assert len(calls) == 2 * (1 + res[True]["total_steps"] + 1)
        assert res[True]["total_steps"] == res[False]["total_steps"]
        _close_lists(res[True]["total_loss_l"], res[False]["total_loss_l"], rel=1e-6)
        np.testing.assert_allclose(res[True]["final_delta"], res[False]["final_delta"], atol=1e-6)
