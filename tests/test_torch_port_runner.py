"""The port's universal runner slice held against the JAX package's: config,
labels, registry, tfrecord codec and pipeline, prefetcher, checkpointer,
scalar writer, the batched attack loop and ``runners/universal.run``.

The loop and runner tests use the tiny linear victim of
``tests/test_runners_e2e.py`` (logits = mean over T,H,W of the clip times a
[3,400] matrix), built in both packages from the same numpy matrix through
the same seam (monkeypatching each package's ``common.build_victim``), on the
same shards with the same config: B=4, T=4, 16x16, f32.  Tolerances: losses
1e-5 relative (f32 reassociation), delta 1e-6 absolute against Adam steps of
1e-3.
"""

import contextlib
import io
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu.engine import loops as jloops
from flickering_adversarial_video_tpu.models import registry as jregistry
from flickering_adversarial_video_tpu.runners import common as jcommon
from flickering_adversarial_video_tpu.runners import universal as juniversal
from flickering_adversarial_video_tpu.utils import config as jconfig
from flickering_adversarial_video_tpu.utils import labels as jlabels
from flickering_adversarial_video_tpu.viz.tensorboard import ScalarWriter as JaxScalarWriter
from flickering_adversarial_video_tpu_torch.convert import (
    attack_state_from_jax,
    attack_state_to_jax,
    init_i3d_state,
)
from flickering_adversarial_video_tpu_torch.convert.tf_bundle import BundleError
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.data.video_dataset import PrefetchIterator
from flickering_adversarial_video_tpu_torch.engine import AttackState, RuntimeFlags
from flickering_adversarial_video_tpu_torch.engine import loops as tloops
from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
from flickering_adversarial_video_tpu_torch.models import registry as tregistry
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import universal as tuniversal
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils import labels as tlabels
from flickering_adversarial_video_tpu_torch.viz.tensorboard import ScalarWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, SIZE, BATCH = 4, 16, 4
LOGGED = ("total_loss", "adv_loss", "reg_loss", "norm_reg", "diff_norm_reg",
          "laplacian_norm_reg", "thickness", "roughness")


def _plain(d):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in d.items()}


# ---------------- config, labels, registry ----------------

class TestConfig:
    def test_default_config_equals_the_jax_packages(self):
        assert _plain(tconfig.default_config()) == _plain(jconfig.default_config())

    def test_repository_yaml_loads_unchanged_and_equal(self):
        path = os.path.join(REPO, "configs", "run_config.yml")
        got, want = tconfig.load_config(path), jconfig.load_config(path)
        assert _plain(got) == _plain(want)
        assert got.UNIVERSAL_ATTACK.USE_PALLAS_FUSED is False
        assert got.UNIVERSAL_ATTACK.BATCH_SIZE == 8

    def test_attr_access_and_partial_yaml(self, tmp_path):
        p = tmp_path / "c.yml"
        p.write_text("UNIVERSAL_ATTACK:\n    BATCH_SIZE: 2\n")
        cfg = tconfig.load_config(str(p))
        assert cfg.UNIVERSAL_ATTACK.BATCH_SIZE == 2 and cfg.UNIVERSAL_ATTACK.LAMBDA == 1.0
        cfg.UNIVERSAL_ATTACK.EXTRA = {"A": 1}
        assert cfg.UNIVERSAL_ATTACK.EXTRA.A == 1
        with pytest.raises(AttributeError):
            cfg.NOPE


class TestLabelsAndRegistry:
    def test_kinetics400_equals_the_jax_packages(self):
        assert tlabels.kinetics400_labels() == jlabels.kinetics400_labels()
        assert tlabels.load_label_map(None, 400) == jlabels.load_label_map(None, 400)
        assert tlabels.labels_for_num_classes(7) == jlabels.labels_for_num_classes(7)

    @pytest.mark.parametrize("n", [600, 101])
    def test_unported_label_maps_raise(self, n):
        """Kinetics-600 (the rgb600 victims) and UCF-101 are ported: each
        equals the JAX package's map, a distinct name a class."""
        assert tlabels.labels_for_num_classes(n) == jlabels.labels_for_num_classes(n)
        assert len(set(tlabels.labels_for_num_classes(n))) == n

    def test_label_map_file(self, tmp_path):
        p = tmp_path / "map.txt"
        p.write_text("a b\n\nc\n")
        assert tlabels.load_label_map(str(p)) == ["a b", "c"]

    def test_i3d_entry_equals_the_jax_packages(self):
        got, want = tregistry.MODEL_REGISTRY["i3d"], jregistry.MODEL_REGISTRY["i3d"]
        for field in ("norm_world", "default_frames", "default_size", "num_classes"):
            assert getattr(got, field) == getattr(want, field)
        assert (got.norm_world, got.default_frames, got.default_size, got.num_classes) == (
            "tanh", 90, 224, 400)
        model, _ = tregistry.create_model("i3d", num_classes=5, device="cpu")
        assert model.num_classes == 5 and model.compute_dtype == torch.float32


# ---------------- tfrecord codec and pipeline ----------------

def _clips(rng, lengths):
    return [(rng.integers(0, 256, (t, SIZE, SIZE, 3), dtype=np.uint8), int(rng.integers(0, 400)))
            for t in lengths]


def _write(module, path, clips):
    with module.TFRecordWriter(str(path)) as w:
        for clip, label in clips:
            w.write(module.make_uint8_example(clip, label))


class TestCrc32c:
    @pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 255, 2047, 2048, 2049, 4097, 70001])
    def test_numpy_version_equals_the_byte_loop(self, n):
        data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttfr.crc32c_numpy(data) == ttfr.crc32c_bytewise(data)

    def test_known_vector_and_mask(self):
        assert ttfr.crc32c_numpy(b"123456789") == 0xE3069283
        data = bytes(range(256)) * 40
        assert ttfr.crc32c_numpy(data) == ttfr.crc32c_bytewise(data)

    def test_without_the_c_extension(self, monkeypatch):
        monkeypatch.setattr(ttfr, "_crc32c_fast", None)
        data = np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        assert ttfr.masked_crc32c(data) == jtfr.masked_crc32c(data)


class TestTFRecord:
    def test_jax_shard_read_by_the_port_and_back(self, tmp_path, monkeypatch):
        rng = np.random.default_rng(5)
        clips = _clips(rng, [4, 6, 4])
        _write(jtfr, tmp_path / "j.tfrecords", clips)
        monkeypatch.setattr(ttfr, "_crc32c_fast", None)  # the port's own crc
        _write(ttfr, tmp_path / "t.tfrecords", clips)
        assert (tmp_path / "j.tfrecords").read_bytes() == (tmp_path / "t.tfrecords").read_bytes()
        for reader, parse, path in ((ttfr, ttfr.parse_example_uint8, "j.tfrecords"),
                                    (jtfr, jtfr.parse_example_uint8, "t.tfrecords")):
            recs = list(reader.read_records(str(tmp_path / path), verify_crc=True))
            assert len(recs) == len(clips)
            for rec, (clip, label) in zip(recs, clips):
                video, got_label = parse(rec, height=SIZE, width=SIZE)
                np.testing.assert_array_equal(video, clip)
                assert got_label == label

    def test_crc_mismatch_and_truncation(self, tmp_path):
        clips = _clips(np.random.default_rng(6), [4, 4])
        path = tmp_path / "x.tfrecords"
        _write(ttfr, path, clips)
        raw = bytearray(path.read_bytes())
        raw[40] ^= 0xFF
        path.write_bytes(bytes(raw))
        with pytest.raises(IOError):
            list(ttfr.read_records(str(path), verify_crc=True))
        path.write_bytes(bytes(raw[: len(raw) - 7]))
        assert len(list(ttfr.read_records(str(path)))) == 1

    def test_list_shards_suffix_and_limit(self, tmp_path):
        for name in ("b.tfrecords", "a.tfrecords", "c.tfrecord", "d.txt"):
            (tmp_path / name).write_bytes(b"")
        got = ttfr.list_shards([str(tmp_path)])
        assert got == jtfr.list_shards([str(tmp_path)])
        assert [os.path.basename(p) for p in got] == ["a.tfrecords", "b.tfrecords"]
        assert len(ttfr.list_shards(str(tmp_path), 1)) == 1
        assert ttfr.list_shards(str(tmp_path / "a.tfrecords")) == [str(tmp_path / "a.tfrecords")]

    @pytest.mark.parametrize("prepack", [False, True])
    @pytest.mark.parametrize("drop_remainder", [True, False])
    def test_batches_equal_the_jax_packages(self, tmp_path, prepack, drop_remainder):
        """Same batches, including the skip-short rule (a 2-frame clip is
        dropped, a 6-frame clip cropped to its last 4) and the remainder."""
        rng = np.random.default_rng(7)
        _write(ttfr, tmp_path / "s0.tfrecords", _clips(rng, [4, 2, 6, 4]))
        _write(ttfr, tmp_path / "s1.tfrecords", _clips(rng, [4, 4, 2, 4]))
        shards = ttfr.list_shards(str(tmp_path))
        kw = dict(frames=FRAMES, drop_remainder=drop_remainder, height=SIZE, width=SIZE,
                  prepack=prepack)
        got = list(ttfr.tfrecord_batches(shards, BATCH, **kw))
        want = list(jtfr.tfrecord_batches(shards, BATCH, use_native=False, **kw))
        assert len(got) == len(want) == (1 if drop_remainder else 2)
        key = "video_packed" if prepack else "video"
        for g, w in zip(got, want):
            assert set(g) == set(w) == {key, "labels"}
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(g["labels"], w["labels"])
            assert g[key].dtype == np.uint8 and g["labels"].dtype == np.int64

    def test_unported_options_are_refused(self, tmp_path):
        with pytest.raises(ValueError):
            list(ttfr.tfrecord_batches([], 2, frames=4, prepack="view"))
        with pytest.raises(ValueError):
            list(ttfr.tfrecord_batches([], 2, prepack=True))
        with pytest.raises(ValueError):
            list(ttfr.tfrecord_batches([], 2, frames=3, prepack=True))
        # use_native is ported: the native reader gives the Python codec's batches
        rng = np.random.default_rng(3)
        _write(ttfr, tmp_path / "s0.tfrecords", _clips(rng, [4, 2, 6, 4, 4]))
        kw = dict(frames=FRAMES, height=SIZE, width=SIZE, prepack=True)
        native = list(ttfr.tfrecord_batches([str(tmp_path / "s0.tfrecords")], 2, use_native=True, **kw))
        plain = list(ttfr.tfrecord_batches([str(tmp_path / "s0.tfrecords")], 2, use_native=False, **kw))
        assert len(native) == len(plain) == 2
        for g, w in zip(native, plain):
            np.testing.assert_array_equal(g["video_packed"], w["video_packed"])
            np.testing.assert_array_equal(g["labels"], w["labels"])


# ---------------- prefetcher, checkpointer, writer ----------------

class TestPrefetchIterator:
    def test_yields_in_order(self):
        assert list(PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def test_producer_exception_reaches_the_consumer(self):
        def gen():
            yield 1
            raise OSError("shard unreadable")

        it = PrefetchIterator(gen())
        assert next(it) == 1
        with pytest.raises(OSError, match="shard unreadable"):
            next(it)
        with pytest.raises(OSError):  # and does not turn into a silent end
            next(it)

    def test_close_stops_a_blocked_producer(self):
        it = PrefetchIterator(iter(range(100)), depth=1)
        assert next(it) == 0
        it.close()
        assert not it._t.is_alive()


def _state(step, value=0.0):
    d = torch.full((FRAMES, 1, 1, 3), float(value))
    return AttackState(d, d * 2, d * 3, step)


class TestCheckpointer:
    def test_keeps_five_of_seven_and_restores_the_latest(self, tmp_path):
        ck = AttackCheckpointer(str(tmp_path / "ckpt"), max_to_keep=5)
        assert ck.latest_step() is None and ck.restore(_state(0)) is None
        for step in range(1, 8):
            ck.save(_state(step, step))
        files = sorted(os.listdir(tmp_path / "ckpt"))
        assert len(files) == 5 and all(f.endswith(".pt") for f in files)
        assert ck.steps() == [3, 4, 5, 6, 7] and ck.latest_step() == 7
        got = ck.restore(_state(0))
        assert got.step == 7
        np.testing.assert_array_equal(got.delta.numpy(), _state(7, 7).delta.numpy())
        np.testing.assert_array_equal(got.mu.numpy(), _state(7, 7).mu.numpy())
        np.testing.assert_array_equal(got.nu.numpy(), _state(7, 7).nu.numpy())
        assert ck.restore(_state(0), step=4).step == 4
        ck.close()

    def test_shape_mismatch_is_refused(self, tmp_path):
        ck = AttackCheckpointer(str(tmp_path))
        ck.save(_state(1))
        other = AttackState(*(torch.zeros(8, 1, 1, 3) for _ in range(3)), 0)
        with pytest.raises(ValueError):
            ck.restore(other)

    def test_state_dict_round_trip_and_jax_bridge(self):
        s = _state(3, 0.25)
        back = _state(0).load_state_dict(s.state_dict())
        assert back.step == 3 and torch.equal(back.nu, s.nu)
        delta, mu, nu, count = attack_state_to_jax(s)
        again = attack_state_from_jax(delta, mu, nu, count)
        assert again.step == 3 and torch.equal(again.mu, s.mu) and torch.equal(again.delta, s.delta)


def _jsonl_only(mp):
    """Force both packages' ScalarWriter onto the JSONL back end."""
    mp.setitem(sys.modules, "tensorboardX", None)
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)


def _read_scalars(log_dir):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


class TestScalarWriter:
    def test_tags_equal_the_jax_writers(self, tmp_path, monkeypatch):
        _jsonl_only(monkeypatch)
        m = {k: 0.5 for k in LOGGED + ("weighted_reg", "l12", "delta_max", "delta_min",
                                       "prob_to_min", "prob_to_max")}
        for cls, name in ((ScalarWriter, "t"), (JaxScalarWriter, "j")):
            w = cls(str(tmp_path / name))
            w.attack_step_scalars(m, 3)
            w.scalar("Eval/fooling_ratio", 0.25, 3)
            w.close()
        got, want = _read_scalars(tmp_path / "t"), _read_scalars(tmp_path / "j")
        assert [(r["tag"], r["value"], r["step"]) for r in got] == [
            (r["tag"], r["value"], r["step"]) for r in want]
        assert len(got) == 15


# ---------------- the loop and the runner on the linear victim ----------------

W_LINEAR = (np.random.default_rng(5).standard_normal((3, 400)) * 4.0).astype(np.float32)


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
    mp.setattr(juniversal, "tfrecord_batches",
               lambda shards, bs, frames=None, **kw: jtfr.tfrecord_batches(
                   shards, bs, frames=frames,
                   **{**kw, "height": SIZE, "width": SIZE, "use_native": False}))
    mp.setattr(tuniversal, "tfrecord_batches",
               lambda shards, bs, frames=None, **kw: ttfr.tfrecord_batches(
                   shards, bs, frames=frames, **{**kw, "height": SIZE, "width": SIZE}))


def _self_labelled_shards(shard_dir, n_shards=2, per_shard=4):
    """Clips labelled with the linear victim's clean prediction, so every
    video is valid under the exclude-misclassified accounting."""
    rng = np.random.default_rng(13)
    os.makedirs(shard_dir, exist_ok=True)
    for s in range(n_shards):
        clips = []
        for _ in range(per_shard):
            c = rng.integers(0, 255, (FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
            x = c.astype(np.float32) / 128.0 - 1.0
            clips.append((c, int((x.mean(axis=(0, 1, 2)) @ W_LINEAR).argmax())))
        _write(ttfr, os.path.join(shard_dir, f"shard{s}.tfrecords"), clips)
    return str(shard_dir)


def _cfg(module, shard_dir, out_dir, **over):
    cfg = module.default_config()
    ac = cfg.UNIVERSAL_ATTACK
    ac.TF_RECORDS_TRAIN_PATH = [shard_dir]
    ac.TF_RECORDS_VAL_PATH = [shard_dir]
    ac.NUM_OF_TRAIN_TF_RECORDS = 2
    ac.NUM_OF_VAL_TF_RECORDS = 2
    ac.BATCH_SIZE = BATCH
    ac.PKL_RESULT_PATH = str(out_dir)
    ac.COMPUTE_DTYPE = "float32"
    ac.MAX_NUM_STEP = 6
    ac.EVAL_EVERY_STEPS = 2
    for k, v in over.items():
        ac[k] = v
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners on the same shards: 6 steps, then a resume to 10."""
    root = tmp_path_factory.mktemp("runner")
    shard_dir = _self_labelled_shards(root / "shards")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_victims(mp)
        _jsonl_only(mp)
        jc = _cfg(jconfig, shard_dir, root / "jax_out")
        tc = _cfg(tconfig, shard_dir, root / "torch_out")
        out["jax"] = juniversal.run(jc, frames=FRAMES)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["torch"] = tuniversal.run(tc, frames=FRAMES, device="cpu")
        out["torch_stdout"] = text.getvalue()
        out["torch_dir"] = tuniversal.model_dir_name(tc.UNIVERSAL_ATTACK)
        out["jax_dir"] = juniversal.model_dir_name(jc.UNIVERSAL_ATTACK)
        tc.UNIVERSAL_ATTACK.MAX_NUM_STEP = 10
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["torch_resumed"] = tuniversal.run(tc, frames=FRAMES, device="cpu")
        out["resume_stdout"] = text.getvalue()
    return out


class TestUniversalRunner:
    def test_steps_and_artifacts(self, runs):
        out = runs["torch"]
        assert out["steps"] == runs["jax"]["steps"] == 6
        assert runs["torch_dir"].replace("torch_out", "") == runs["jax_dir"].replace("jax_out", "")
        with open(os.path.join(runs["torch_dir"], "res.pkl"), "rb") as f:
            res = pickle.load(f)
        assert set(res) == {"history", "final_eval"}
        assert "Begin new training from the zero-perturbation start" in runs["torch_stdout"]
        assert "input pipeline: host-prepacked" not in runs["torch_stdout"]  # no packed stem

    def test_history_matches(self, runs):
        got, want = runs["torch"]["history"], runs["jax"]["history"]
        assert set(got) == set(want)
        for k in LOGGED:
            assert len(got[k]) == len(want[k]) == 1  # step 1; log_every is 50
            assert got[k][0] == pytest.approx(want[k][0], rel=1e-5, abs=1e-9), k

    def test_eval_cadence_and_fooling_match(self, runs):
        got, want = runs["torch"]["history"], runs["jax"]["history"]
        assert got["fool_rate_steps"] == want["fool_rate_steps"] == [0, 2, 4, 6, 6]
        assert got["fool_rate"] == pytest.approx(want["fool_rate"])
        assert len(got["perturbation"]) == len(want["perturbation"]) == 3
        for g, w in zip(got["perturbation"], want["perturbation"]):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)
        assert runs["torch"]["final_eval"] == runs["jax"]["final_eval"]
        assert runs["torch"]["final_eval"]["total_valid_videos"] == 8

    def test_final_delta_matches(self, runs):
        got = runs["torch"]["state"].delta.numpy()
        want = np.asarray(runs["jax"]["state"].delta)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_scalar_tags_match_the_jax_runners(self, runs):
        got = _read_scalars(os.path.join(runs["torch_dir"], "train"))
        want = _read_scalars(os.path.join(runs["jax_dir"], "train"))
        got = [r for r in got if r["step"] <= 6][: len(want)]
        assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
        for g, w in zip(got, want):
            assert g["value"] == pytest.approx(w["value"], rel=1e-5, abs=1e-9), g["tag"]

    def test_resume_from_the_checkpoint(self, runs):
        assert "Continue training from step 6" in runs["resume_stdout"]
        out = runs["torch_resumed"]
        assert out["state"].step == 10 and out["steps"] == 10
        assert out["history"]["fool_rate_steps"] == [6, 8, 10, 10]
        ck = AttackCheckpointer(os.path.join(runs["torch_dir"], "ckpt"))
        assert ck.steps() == [6, 10]

    def test_cli(self, monkeypatch):
        with pytest.raises(SystemExit) as e:
            tuniversal.main(["--help"])
        assert e.value.code == 0
        seen = {}
        monkeypatch.setattr(tuniversal, "run", lambda cfg, **kw: seen.update(kw, cfg=cfg))
        tuniversal.main([os.path.join(REPO, "configs", "run_config.yml"), "--frames", "8",
                         "--size", "32", "--max-steps", "3", "--device", "cpu"])
        assert (seen["frames"], seen["size"], seen["max_steps"], seen["device"]) == (8, 32, 3, "cpu")
        assert seen["cfg"].UNIVERSAL_ATTACK.MAX_NUM_STEP == 10000

    def test_no_cuda_and_no_cpu_request_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _cfg(tconfig, str(tmp_path), tmp_path / "out")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tuniversal.run(cfg, frames=FRAMES, size=SIZE)

    def test_sparse_variant_raises(self, tmp_path, monkeypatch):
        """FLICKERING_ATTACK false is the L1,2 attack (tests/
        test_torch_port_sparse_cyclic.py runs it): its results go under
        SUP_ATTACK, and on an empty shard directory it gets as far as the
        pipeline, which raises for the missing batches."""
        _patch_victims(monkeypatch)
        cfg = _cfg(tconfig, str(tmp_path), tmp_path / "out", FLICKERING_ATTACK=False)
        assert "SUP_ATTACK" in tuniversal.model_dir_name(cfg.UNIVERSAL_ATTACK)
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(RuntimeError, match="yielded no batches"):
                tuniversal.run(cfg, frames=FRAMES, size=SIZE, device="cpu")


@pytest.fixture
def engines(monkeypatch):
    """The linear victim's engine in both packages, from the same config."""
    _patch_victims(monkeypatch)
    ac = tconfig.default_config().UNIVERSAL_ATTACK
    ac.COMPUTE_DTYPE = "float32"
    jeng, _ = jcommon.build_engine(ac, jconfig.default_config().MODEL, frames=FRAMES, size=SIZE,
                                   use_mesh=False, track_probs=False)
    teng, labels = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES,
                                        size=SIZE, track_probs=False, device="cpu")
    assert labels == tlabels.kinetics400_labels()
    return jeng, teng, ac


def _batches(n=3):
    rng = np.random.default_rng(17)
    return [{"video": rng.integers(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3), dtype=np.uint8),
             "labels": rng.integers(0, 400, (BATCH,))} for _ in range(n)]


class TestLoop:
    def test_every_step_logged_matches_the_jax_loop(self, engines):
        """log_every=1, epoch-cadence eval, a targeted label override."""
        jeng, teng, ac = engines
        data = _batches()
        kw = dict(max_steps=7, log_every=1, targeted_label=11)
        want = jloops.batched_attack_loop(
            jeng, lambda: iter(data), lambda: iter(data[:1]), jloops.flags_from_config(ac), **kw)
        got = tloops.batched_attack_loop(
            teng, lambda: iter(data), lambda: iter(data[:1]), tloops.flags_from_config(ac), **kw)
        assert got["steps"] == want["steps"] == 7
        for k in LOGGED:
            np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5,
                                       atol=1e-9, err_msg=k)
        # an epoch is 3 batches: evals at 0, 3, 6, 7 (epoch ends) and the final one
        assert got["history"]["fool_rate_steps"] == want["history"]["fool_rate_steps"]
        assert got["history"]["fool_rate"] == pytest.approx(want["history"]["fool_rate"])
        np.testing.assert_allclose(got["state"].delta.numpy(), np.asarray(want["state"].delta),
                                   atol=1e-6, rtol=0)
        assert got["steps_per_sec"] > 0

    def test_step_timer_leaves_out_the_first_interval(self, monkeypatch):
        """The first step of a batch shape captures its CUDA graph: the
        second rate leaves that interval out."""
        clock = iter([0.0, 2.5, 3.0, 3.5, 4.0])
        monkeypatch.setattr(tloops.time, "perf_counter", lambda: next(clock))
        timer = tloops.StepTimer()
        timer.tick()
        assert timer.steps_per_sec == timer.steps_per_sec_after_first == 0.0
        for _ in range(4):
            timer.tick()
        assert (timer.count, timer.first) == (4, 2.5)
        assert timer.steps_per_sec == pytest.approx(1.0)
        assert timer.steps_per_sec_after_first == pytest.approx(2.0)

    def test_flags_from_config(self, engines):
        _, _, ac = engines
        ac.LAMBDA, ac.BETA_1, ac.BETA_2, ac.LEARNING_RATE = 3.0, 0.25, 0.75, 0.01
        got, want = tloops.flags_from_config(ac), jloops.flags_from_config(ac)
        for k in ("adv_flag", "beta0", "beta1", "beta2", "beta3", "learning_rate"):
            assert getattr(got, k) == float(getattr(want, k))
        assert got.beta3 == got.beta2 == 0.75
        assert tloops.flags_from_config(ac, learning_rate=0.5).learning_rate == 0.5

    def test_empty_pipeline_raises(self, engines):
        _, teng, _ = engines
        with pytest.raises(RuntimeError, match="train pipeline yielded no batches"):
            tloops.batched_attack_loop(teng, lambda: iter(()), lambda: iter(()), RuntimeFlags(),
                                       max_steps=2)

    def test_failing_pipeline_is_not_hidden(self, engines):
        _, teng, _ = engines

        def broken():
            yield _batches(1)[0]
            raise OSError("shard unreadable")

        with pytest.raises(OSError, match="shard unreadable"):
            tloops.batched_attack_loop(teng, broken, lambda: iter(()), RuntimeFlags(), max_steps=5)

    def test_checkpoint_cadence(self, engines, tmp_path):
        _, teng, _ = engines
        data = _batches(2)
        ck = AttackCheckpointer(str(tmp_path / "ck"), max_to_keep=5)
        tloops.batched_attack_loop(teng, lambda: iter(data), lambda: iter(()), RuntimeFlags(),
                                   max_steps=7, checkpointer=ck, checkpoint_every=1,
                                   eval_every_steps=100)
        assert ck.steps() == [3, 4, 5, 6, 7]  # 7 step saves + the final one, 5 kept

    def test_state_carried_across_from_jax(self, engines):
        """A JAX AttackState after 2 steps, carried over, gives the same
        third step in both packages."""
        jeng, teng, ac = engines
        batch = _batches(1)[0]
        jflags, key = jloops.flags_from_config(ac), jax.random.key(0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate = jeng.init_state()
        for _ in range(2):
            jstate, _ = jeng.train_step(jstate, jbatch, jflags, key)
        adam = jstate.opt_state.inner_state[0]
        carried = attack_state_from_jax(*(np.asarray(a) for a in (jstate.delta, adam.mu, adam.nu)),
                                        int(adam.count))
        assert carried.step == 2
        jstate, _ = jeng.train_step(jstate, jbatch, jflags, key)
        tstate, _ = teng.train_step(carried, batch, tloops.flags_from_config(ac))
        assert tstate.step == 3
        np.testing.assert_allclose(tstate.delta.numpy(), np.asarray(jstate.delta), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tstate.nu.numpy(), np.asarray(jstate.opt_state.inner_state[0].nu),
                                   rtol=1e-5, atol=1e-12)


# ---------------- engine wiring from the config ----------------

class TestBuildEngine:
    def test_config_mapping(self, engines):
        _, _, ac = engines
        ac.TARGETED_ATTACK, ac.TARGETED_CLASS = True, "welding"
        ac.USE_LOGITS, ac.IMPROVE_ADV_LOSS, ac.PROB_MARGIN = True, False, 0.1
        ac.ATTACK_FRAME_WINDOW = [1, 2]
        ac.USE_PALLAS_FUSED = True
        eng, labels = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES,
                                           size=SIZE, device="cpu")
        c = eng.config
        assert c.targeted and c.target_class == labels.index("welding")
        assert c.use_logits and not c.improve_loss and c.margin == 0.1
        assert c.frame_window == (1, 2) and c.use_pallas_fused and c.reg_weighting == "tf"
        assert eng.spec.shape == (FRAMES, 1, 1, 3)

    @pytest.mark.parametrize("key", ["CYCLIC_ATTACK", "CYCLIC_PERTURBATION_ATTACK"])
    def test_cyclic_keys_raise(self, engines, key):
        """Either cyclic key compiles the rolls in, as the JAX package's
        build_engine does, and keeps the engine off the packed input path."""
        _, _, ac = engines
        ac[key] = True
        eng, _ = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES,
                                      device="cpu")
        jeng, _ = jcommon.build_engine(ac, jconfig.default_config().MODEL, frames=FRAMES,
                                       size=SIZE, use_mesh=False)
        assert eng.config.enable_cyclic and jeng.config.enable_cyclic
        assert not eng._packed_supported()

    def test_sparse_kind_raises(self, engines):
        """attack_kind 'sparse' builds the L1,2 attack's full delta, the JAX
        package's SparseSpec shape."""
        _, _, ac = engines
        eng, _ = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=FRAMES,
                                      size=SIZE, attack_kind="sparse", device="cpu")
        jeng, _ = jcommon.build_engine(ac, jconfig.default_config().MODEL, frames=FRAMES,
                                       size=SIZE, attack_kind="sparse", use_mesh=False)
        assert eng.config.attack_kind == jeng.config.attack_kind == "sparse"
        assert eng.spec.shape == jeng.spec.shape == (FRAMES, SIZE, SIZE, 3)
        assert eng.init_state().delta.eq(1e-8).all()


class TestBuildVictimAndPrepackGate:
    """The real build_victim (no seam): a full-width I3D on the CPU."""

    @pytest.fixture(scope="class")
    def built(self):
        cfg = tconfig.default_config()
        cfg.UNIVERSAL_ATTACK.COMPUTE_DTYPE = "float32"
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            eng, _ = tcommon.build_engine(cfg.UNIVERSAL_ATTACK, cfg.MODEL, frames=FRAMES,
                                          size=SIZE, device="cpu")
        return eng, cfg, text.getvalue()

    def test_missing_checkpoint_gives_seeded_weights_and_a_warning(self, built):
        eng, _, said = built
        assert "[warn] no checkpoint for i3d" in said and "random init" in said
        want = init_i3d_state(0, 400)
        key = "Mixed_4c.Branch_1.Conv3d_0b_3x3.conv_3d.weight"
        assert torch.equal(eng.model.state_dict()[key], want[key])
        assert eng.model.num_classes == 400 and eng.device.type == "cpu"

    def test_existing_checkpoint_is_not_ignored(self, tmp_path):
        """A checkpoint file that exists is read, never replaced by random
        init: an empty index fails in the bundle reader."""
        (tmp_path / "model.ckpt.index").write_bytes(b"")
        with pytest.raises(BundleError, match="shorter than a table footer"):
            tcommon.build_victim("i3d", str(tmp_path / "model.ckpt"), torch.float32, 4, 16,
                                 device="cpu")

    @pytest.mark.parametrize("fused,prepack_key,frames,want", [
        (False, True, 4, True), (True, True, 4, False), (False, False, 4, False),
        (False, True, 5, False)])
    def test_prepack_gate(self, built, fused, prepack_key, frames, want, capsys):
        eng, cfg, _ = built
        ac = cfg.UNIVERSAL_ATTACK
        ac.PREPACK_INPUT = prepack_key
        eng = type(eng)(eng.model, eng.spec, type(eng.config)(use_pallas_fused=fused))
        seen = {}

        def fake_batches(shards, bs, **kw):
            seen.update(kw, bs=bs)
            return iter(())

        batches, prepack = tcommon.make_shard_batches(ac, eng, fake_batches, frames=frames,
                                                      size=SIZE, batch_size=3)
        batches(["x"])
        assert prepack is want and seen["prepack"] is want
        assert (seen["bs"], seen["frames"], seen["height"], seen["width"]) == (3, frames, SIZE, SIZE)
        assert ("host-prepacked" in capsys.readouterr().out) is want
