"""The port's last host tools held against the JAX package's on the CPU:
``utils/system.py``, ``utils/profiling.py``, ``ops/accounting.py`` (with the
record of every kernel wrapper), ``viz/stats_plots.py``, ``viz/aggregate.py``,
the rest of ``convert/fake_assets.py`` and the two flicker regularizers.
"""

import os
import platform

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flickering_adversarial_video_tpu.attack import regularizers as jreg
from flickering_adversarial_video_tpu.convert import fake_assets as jfake
from flickering_adversarial_video_tpu.utils import system as jsystem
from flickering_adversarial_video_tpu.viz import aggregate as jagg
from flickering_adversarial_video_tpu.viz import stats_plots as jplots
from flickering_adversarial_video_tpu_torch import ops
from flickering_adversarial_video_tpu_torch.attack import (
    FlickerSpec, flicker_regularizer, flicker_regularizer_torch)
from flickering_adversarial_video_tpu_torch.convert import fake_assets as tfake
from flickering_adversarial_video_tpu_torch.convert import init_i3d_state, read_bundle
from flickering_adversarial_video_tpu_torch.engine import AttackEngine, RuntimeFlags
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.ops import accounting, fused_apply, packed_apply
from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided, stem_combine
from flickering_adversarial_video_tpu_torch.ops import stem_conv
from flickering_adversarial_video_tpu_torch.utils import profiling, system
from flickering_adversarial_video_tpu_torch.viz import aggregate as tagg
from flickering_adversarial_video_tpu_torch.viz import stats_plots as tplots

# a train step's and an eval step's launches by kernel on the card (chip_smoke.py
# TRAIN_COUNTS, EVAL_COUNTS): the default configuration, uint8 clips
TRAIN_COUNTS = {"B1": 1, "B2": 19, "B3": 9, "B4": 9, "B5": 3, "B6": 3, "B7": 1}
EVAL_COUNTS = {"B1": 2, "B3": 18, "B5": 6, "B7": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- system and profiling ----------------

class TestSystem:
    def test_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert system.num_devices() == 1
        assert system.device_kind() == "cpu"
        info = system.system_info()
        want = set(jsystem.system_info()) - {"jax"} | {"torch", "cuda"}
        assert set(info) == want
        assert (info["backend"], info["devices"]) == ("cpu", ["cpu"])
        assert (info["process_index"], info["process_count"]) == (0, 1)
        assert info["torch"] == torch.__version__
        assert system.db_num_workers() == jsystem.db_num_workers()
        assert system.db_num_workers(2) == (0 if platform.system() == "Windows"
                                            else min(2, os.cpu_count() or 1))


class TestProfiling:
    def test_timer_sections_accumulate(self):
        timer = profiling.Timer()
        for _ in range(2):
            with timer.section("a"):
                pass
        with timer.section("b"):
            pass
        assert set(timer.sections) == {"a", "b"} and timer.sections["a"] >= 0.0

    def test_cpu_trace_written(self, tmp_path):
        with profiling.trace_steps(str(tmp_path / "trace"), device="cpu"):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
        path = tmp_path / "trace" / "trace.json"
        assert path.exists() and "aten::" in path.read_text()

    def test_trace_needs_cuda_or_cpu(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with profiling.trace_steps(str(tmp_path)):
                pass


# ---------------- accounting ----------------

def _taps(n: int) -> int:
    """Taps of a 4-tap axis padded (1, 2) that land inside n positions."""
    return sum(1 for i in range(n) for m in range(4) if 0 <= i + m - 1 < n)


class TestAccounting:
    def test_no_op_outside_recording_and_nesting(self):
        x = torch.randn(1, 2, 4, 4, 8)
        pool_s1.pool333_fwd(x)  # nothing active: nothing recorded, nothing raised
        with accounting.recording() as outer:
            pool_s1.pool333_fwd(x)
            with accounting.recording() as inner:
                pool_strided.pool133_s2_fwd(x)
            pool_s1.pool333_fwd(x)
        assert inner.counts() == {"B5": 1}
        assert outer.counts() == {"B3": 2, "B5": 1}
        assert outer.hbm_bytes == 2 * 2 * x.numel() * 4 + x.numel() * 4 * 5 / 4
        assert not accounting._active

    def test_one_eager_step_tallies_the_launch_counts(self):
        model = InceptionI3D(7, torch.float32, device="cpu")
        model.load_state_dict(init_i3d_state(0, 7))
        eng = AttackEngine(model, FlickerSpec(frames=8))
        rng = np.random.default_rng(0)
        batch = {"video": rng.integers(0, 256, (1, 8, 16, 16, 3), dtype=np.uint8),
                 "labels": rng.integers(0, 7, (1,))}
        state = eng.init_state()
        before = ops.launch_counts()
        with accounting.recording() as step:
            eng._train_step(state, *eng.prepare_batch(batch), RuntimeFlags())
        with accounting.recording() as ev:
            eng.eval_step(state.delta, batch, RuntimeFlags())
        # on CPU tensors the wrappers run their plain versions, count no
        # launch and record the launches they stand in for
        assert ops.launch_counts() == before
        assert step.counts() == TRAIN_COUNTS
        assert ev.counts() == EVAL_COUNTS
        (b1,) = [c for c in step.calls if c[0] == "B1"]
        # the stem's input: [1, 4, 8, 8, 24] packed
        assert b1[1] == 2 * 64 * 24 * _taps(4) * _taps(8) * _taps(8)
        assert b1[2] == (4 * 8 * 8 * (24 + 64) + 4 ** 3 * 24 * 64) * 4 + 3 * 64 * 4
        assert step.flops == b1[1]  # the pools and the elementwise kernels record 0

    def test_b1_records_each_column_segment(self):
        x = torch.randn(1, 4, 6, 6, 24)
        pk = torch.randn(4, 4, 4, 24, 64)
        bn = (torch.zeros(64), torch.ones(64), torch.zeros(64))
        with accounting.recording() as tally:
            stem_conv.stem_conv_bn_relu(x, pk, *bn, max_w=5)
        segs = stem_conv.stem_segments(6, 5)
        assert len(segs) == 2 and tally.counts() == {"B1": 2}
        for (_, _, lo, hi), (_, flops, nbytes) in zip(segs, tally.calls):
            w = hi - lo
            assert flops == 2 * 64 * 24 * _taps(4) * _taps(6) * _taps(w)
            assert nbytes == (4 * 6 * w * (24 + 64) + 4 ** 3 * 24 * 64) * 4 + 3 * 64 * 4

    def test_every_wrapper_records_its_bytes(self):
        """Each input read once, each output written once, by formula."""
        bf = torch.bfloat16
        x = torch.randn(2, 3, 4, 6, 8, dtype=bf)
        n = x.numel()
        dy = torch.randn(2, 3, 2, 3, 8, dtype=bf)
        part = torch.randn(2, 3, 4, 6, 3 * 8, dtype=bf)
        u8 = torch.randint(0, 256, (2, 3, 4, 6, 24), dtype=torch.uint8)
        video = torch.randint(0, 256, (2, 4, 5, 6, 3), dtype=torch.uint8)
        delta, deltas, flag = torch.zeros(4, 1, 1, 3), torch.zeros(2, 4, 1, 1, 3), torch.ones(())
        g = torch.randn(video.shape)
        _, idx = pool_strided.pool133_s2_pair_fwd(x)
        calls = [
            ("B2", lambda: stem_combine.temporal_combine(part, 8, 1), (n * 3 + n) * 2),
            ("B3", lambda: pool_s1.pool333_fwd(x), 2 * n * 2),
            ("B4", lambda: pool_s1.pool333_bwd(x, x), 3 * n * 2),
            ("B5", lambda: pool_strided.pool133_s2_fwd(x), (n + n // 4) * 2),
            ("B6", lambda: pool_strided.pool133_s2_bwd(x, dy), (2 * n + n // 4) * 2),
            ("B9f", lambda: pool_strided.pool133_s2_pair_fwd(x), (n + n // 4) * 2 + n // 4),
            ("B9f", lambda: pool_strided.pool133_s2_pair_fwd(x, want_idx=False),
             (n + n // 4) * 2),
            ("B9b", lambda: pool_strided.pool133_s2_pair_bwd(idx, dy), (n // 4 + n) * 2 + n // 4),
            ("B7", lambda: packed_apply.emit_adv_mask(u8, torch.zeros(3, 24), -1, 1, bf),
             u8.numel() * (1 + 2 + 1) + 3 * 24 * 4),
            ("B7", lambda: packed_apply.emit_adv_mask(u8, torch.zeros(3, 24), -1, 1,
                                                      torch.float32, want_mask=False),
             u8.numel() * (1 + 4) + 3 * 24 * 4),
            ("B7c", lambda: packed_apply.emit_adv_mask(u8, torch.zeros(2, 3, 24), -1, 1, bf),
             u8.numel() * (1 + 2 + 1) + 2 * 3 * 24 * 4),
            ("B8f", lambda: fused_apply.fused_apply_fwd(video, delta, flag),
             video.numel() * (1 + 4) + (12 + 1) * 4),
            ("B8b", lambda: fused_apply.fused_apply_bwd(video, delta, flag, g),
             video.numel() * (1 + 4) + (2 * 12 + 1) * 4),
            ("B8cf", lambda: fused_apply.fused_apply_fwd(video, deltas, flag),
             video.numel() * (1 + 4) + (24 + 1) * 4),
            ("B8cb", lambda: fused_apply.fused_apply_bwd(video, deltas, flag, g),
             video.numel() * (1 + 4) + (2 * 24 + 1) * 4),
        ]
        for tag, call, want in calls:
            with accounting.recording() as tally:
                call()
            assert tally.calls == [(tag, 0.0, float(want))], tag


# ---------------- the plotting tools ----------------

def _result(rng, frames=4, size=8):
    return {
        "rgb_sample": rng.uniform(-1, 1, (1, frames, size, size, 3)).astype(np.float32),
        "adv_video": rng.uniform(-1, 1, (1, frames, size, size, 3)).astype(np.float32),
        "perturbation": [rng.normal(0, 0.05, (frames, 1, 1, 3)).astype(np.float32)
                         for _ in range(2)],
        "fatness": [1.0, 2.5], "smoothness": [0.5, 0.75], "correct_cls": "juggling balls",
    }


class TestPlots:
    def test_extract_videos_equal_jax(self):
        res = _result(np.random.default_rng(31))
        for amp in (1.0, 5.0):
            for got, want in zip(tplots.extract_videos(res, amp), jplots.extract_videos(res, amp)):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.uint8

    def test_gif_written(self, tmp_path):
        pytest.importorskip("matplotlib")
        out = tplots.animate(_result(np.random.default_rng(32)), save=str(tmp_path / "v.gif"),
                             show=False)
        assert out.endswith(".gif") and os.path.getsize(out) > 0

    def test_best_epoch_and_experiments_equal_jax(self, tmp_path):
        rng = np.random.default_rng(33)

        def epochs(n):
            return [{f"valid/{k}": float(rng.uniform()) for k in
                     ("fooling_ratio", "pert_thickness", "pert_roughness")} for _ in range(n)]

        for results in (epochs(5), epochs(3), []):
            for thr in (0.0, 0.5, 1.1):
                assert tagg.best_epoch_stats(results, thr) == jagg.best_epoch_stats(results, thr)
        # two experiments' per-epoch .npy files, named as the epoch fit names them
        for model, n_train in (("r3d_18", 8), ("r3d_18", 32), ("mc3_18", 8)):
            d = tmp_path / f"{model}_t{n_train}_run"
            d.mkdir()
            np.save(d / f"{model}_003.npy", np.asarray(epochs(3), dtype=object),
                    allow_pickle=True)
        got = tagg.collect_experiments(str(tmp_path))
        assert got == jagg.collect_experiments(str(tmp_path))
        assert [n for n, _ in got["r3d_18"]] == [8, 32]
        if pytest.importorskip("matplotlib"):
            png = tagg.plot_sweep(got, save=str(tmp_path / "sweep.png"))
            assert os.path.getsize(png) > 0


# ---------------- the rehearsal assets ----------------

def _logits(clip):
    """A numpy predict_fn: 400 logits from the clip's per-channel means."""
    w = np.random.default_rng(34).normal(size=(3, 400)).astype(np.float32)
    return clip.reshape(-1, 3).mean(axis=0) @ w


class TestFakeAssets:
    def test_shards_and_clips_byte_equal_jax(self, tmp_path):
        kw = dict(frames=3, size=8, seed=5)
        got = tfake.write_tfrecord_shards(str(tmp_path / "t"), **kw)
        want = jfake.write_tfrecord_shards(str(tmp_path / "j"), **kw)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        for a, b in zip(got, want):
            assert open(a, "rb").read() == open(b, "rb").read()
        for predict in (None, _logits):
            got = tfake.write_npy_clips(str(tmp_path / "tn"), ["a b", "c"], predict_fn=predict,
                                        candidates=3, **kw)
            want = jfake.write_npy_clips(str(tmp_path / "jn"), ["a b", "c"], predict_fn=predict,
                                         candidates=3, **kw)
            assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
            for a, b in zip(got, want):
                assert open(a, "rb").read() == open(b, "rb").read()

    @pytest.mark.parametrize("eval_type", ["rgb", "rgb600"])
    def test_saver_checkpoint_reads_back(self, tmp_path, eval_type):
        """TensorFlow's Saver files of a state (the stem and the logits of a
        600-class I3D: the layouts of every leaf kind), read back by the
        port's bundle reader as i3d_var_map of the state."""
        pytest.importorskip("tensorflow")
        state = {k: v for k, v in init_i3d_state(1, 600).items()
                 if k.startswith(("Conv3d_1a_7x7.", "Logits."))}
        prefix = tfake.write_i3d_saver_checkpoint(str(tmp_path / "ck" / "model.ckpt"),
                                                  state=state, eval_type=eval_type)
        want = tfake.i3d_var_map(state, bare_names=eval_type == "rgb600")
        got = read_bundle(prefix)
        assert set(got) == set(want) and len(want) == len(state)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])

    def test_fabricate(self, tmp_path, monkeypatch):
        """The whole set at 8x32 on the CPU, clips named with the port's own
        f32 prediction; the two file writers tested above and with the
        converters are recorded, not run (two full I3D Saver checkpoints and
        r2plus1d_34 .pth files of ~250 MB each)."""
        ckpt, pth = [], []
        monkeypatch.setattr(
            tfake, "write_i3d_saver_checkpoint",
            lambda prefix, state, eval_type="rgb": ckpt.append((prefix, state, eval_type)) or prefix)
        monkeypatch.setattr(tfake, "write_torchvision_pth",
                            lambda path, variant, **kw: pth.append((variant, kw)) or path)
        out = tfake.fabricate(str(tmp_path), npy_classes=["x"], device="cpu")
        assert [(os.path.relpath(p, tmp_path), e) for p, _, e in ckpt] == [
            ("checkpoints/rgb_imagenet/model.ckpt", "rgb"),
            ("checkpoints/rgb_scratch_kin600/model.ckpt", "rgb600")]
        for (_, state, _), (seed, classes) in zip(ckpt, ((0, 400), (1, 600))):
            want = init_i3d_state(seed, classes)
            assert state.keys() == want.keys()
            assert all(torch.equal(state[k], want[k]) for k in want)
        assert [v for v, _ in pth] == ["r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34",
                                       "r2plus1d_34"]
        assert [kw.get("num_classes", 400) for _, kw in pth][-2:] == [359, 487]
        model = InceptionI3D(400, torch.float32, device="cpu")
        model.load_state_dict(init_i3d_state(0, 400))
        (npy,) = out["npy"]
        clip = np.load(npy)
        assert clip.shape == (1, 8, 32, 32, 3)
        with torch.no_grad():
            top = int(model(torch.from_numpy(clip))[0][0].argmax())
        from flickering_adversarial_video_tpu_torch.utils.labels import load_label_map

        assert os.path.basename(npy) == f"rgb_fake0@{load_label_map(None)[top].replace(' ', '_')}.npy"
        assert len(out["tfrecords"]) == 2


# ---------------- the regularizers ----------------

class TestRegularizers:
    @pytest.mark.parametrize("betas", [(0.5, 0.5, None), (0.2, 0.7, 0.1), (1.0, 0.0, 3.0)])
    def test_flicker_regularizers_equal_jax(self, betas):
        delta = np.random.default_rng(35).normal(0, 0.05, (16, 1, 1, 3)).astype(np.float32)
        b1, b2, b3 = betas
        got = float(flicker_regularizer(torch.from_numpy(delta), b1, b2, b3))
        want = float(jreg.flicker_regularizer(jnp.asarray(delta), b1, b2, b3))
        assert abs(got - want) <= 1e-6 * abs(want)
        got = float(flicker_regularizer_torch(torch.from_numpy(delta), b1))
        want = float(jreg.flicker_regularizer_torch(jnp.asarray(delta), b1))
        assert abs(got - want) <= 1e-6 * abs(want)
