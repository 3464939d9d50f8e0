"""Real victims in the port: the TF bundle reader, the DeepMind I3D name map,
the weight files and CLI, the golden files and ``build_victim``, held against
TensorFlow and the JAX package.

One checkpoint of each world (rgb: 400 classes under ``RGB/inception_i3d/``;
rgb600: 600 classes, bare names) is written once for the module by the JAX
package's ``convert/fake_assets.write_i3d_saver_checkpoint`` (TensorFlow's
Saver), from a state dict whose every tensor is random (BN statistics
included, so that a reshape or a swap shows).  The JAX package's golden
file is dumped at 8x16x16 in f32.  Tolerances: bit-equal for every tensor
read or converted; logits to atol = rtol = 1e-4 (f32 reassociation, as
tests/test_torch_port_i3d.py holds the model).
"""

import contextlib
import io
import os
import pickle
import struct
import sys

import flax.serialization
import jax
import numpy as np
import pytest
import tensorflow as tf
import torch

from flickering_adversarial_video_tpu.convert import convert_i3d_checkpoint as j_convert_ckpt
from flickering_adversarial_video_tpu.convert import convert_i3d_var_map as j_convert_map
from flickering_adversarial_video_tpu.convert import fake_assets as jfake
from flickering_adversarial_video_tpu.convert import golden as jgolden
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu_torch.convert import (
    BundleReader,
    cli,
    convert_i3d_checkpoint,
    flax_msgpack,
    from_flax_variables,
    golden,
    i3d_var_map,
    load_weights,
    read_bundle,
    save_variables,
    save_weights,
    to_flax_variables,
)
from flickering_adversarial_video_tpu_torch.convert.tf_bundle import BundleError, _handle
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.data.tfrecord import masked_crc32c
from flickering_adversarial_video_tpu_torch.models.i3d import state_shapes
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import universal as tuniversal
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils import labels as tlabels

FRAMES, SIZE = 8, 16
WORLDS = {"rgb": 400, "rgb600": 600}


def _random_state(seed, num_classes):
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in state_shapes(num_classes).items():
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(0.1)
        if key.endswith("conv_3d.weight"):
            a *= np.float32(1.0 / np.sqrt(np.prod(shape[1:]) * 0.01))
        if key.endswith("running_var"):
            a = np.abs(a) + np.float32(0.5)
        sd[key] = torch.from_numpy(a)
    return sd


def _flax(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Per world: the state, its Flax tree, the TF checkpoint prefix and the
    port's .pt of the state."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for seed, (world, classes) in enumerate(WORLDS.items(), start=1):
        state = _random_state(seed, classes)
        bare = world == "rgb600"
        variables = j_convert_map(i3d_var_map(state, bare_names=bare), eval_type=world)
        prefix = str(root / world / "model.ckpt")
        jfake.write_i3d_saver_checkpoint(prefix, num_classes=classes, variables=variables,
                                         eval_type=world)
        pt = str(root / f"{world}.pt")
        save_weights(state, pt)
        out[world] = dict(state=state, variables=_flax(variables), prefix=prefix, pt=pt)
    return out


@pytest.fixture(scope="module")
def jax_golden(assets, tmp_path_factory):
    """The JAX package's golden file for the rgb weights at 8x16x16, its
    weights file the port's .pt beside it."""
    root = tmp_path_factory.mktemp("golden")
    npz = str(root / "golden.npz")
    pt = str(root / "weights.pt")
    save_weights(assets["rgb"]["state"], pt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jgolden.GOLDEN_GEOMETRY, "tanh", (FRAMES, SIZE))
        jgolden.dump_golden("i3d", assets["rgb"]["variables"], npz, pt, num_classes=400)
    return npz


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# ---------------- the bundle reader ----------------

class TestBundleReader:
    @pytest.mark.parametrize("world", list(WORLDS))
    def test_every_variable_equals_tensorflows(self, assets, world):
        prefix = assets[world]["prefix"]
        ref = tf.train.load_checkpoint(prefix)
        shapes = ref.get_variable_to_shape_map()
        got = read_bundle(prefix)
        assert set(got) == set(shapes) and len(got) == len(state_shapes(WORLDS[world]))
        reader = BundleReader(prefix)
        for name, value in got.items():
            want = ref.get_tensor(name)
            assert value.dtype == want.dtype and value.shape == want.shape, name
            assert reader.entries[name].shape == tuple(shapes[name])
            np.testing.assert_array_equal(value, want, err_msg=name)

    def test_other_dtypes_and_a_scalar(self, tmp_path):
        prefix = str(tmp_path / "m.ckpt")
        values = {"a/f64": np.float64(3.25), "b/i64": np.arange(6, dtype=np.int64).reshape(2, 3),
                  "c/i32": np.array([-7, 9], np.int32), "d/f16": np.array([1.5, -2], np.float16)}
        g = tf.Graph()
        with g.as_default():
            tvars = [tf.compat.v1.get_variable(k, initializer=v) for k, v in values.items()]
            saver = tf.compat.v1.train.Saver(var_list=tvars)
            with tf.compat.v1.Session(graph=g) as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                saver.save(sess, prefix)
        got = read_bundle(prefix)
        for k, v in values.items():
            assert got[k].dtype == np.asarray(v).dtype and got[k].shape == np.shape(v)
            np.testing.assert_array_equal(got[k], v)

    def _index(self, assets, tmp_path):
        """A copy of the rgb checkpoint: (prefix, index bytes, index handle)."""
        src = assets["rgb"]["prefix"]
        prefix = str(tmp_path / "model.ckpt")
        for suffix in (".index", ".data-00000-of-00001"):
            with open(src + suffix, "rb") as f, open(prefix + suffix, "wb") as g:
                g.write(f.read())
        data = bytearray(open(prefix + ".index", "rb").read())
        footer = memoryview(bytes(data[-48:]))
        _, pos = _handle(footer, 0)
        (offset, size), _ = _handle(footer, pos)
        return prefix, data, offset, size

    @pytest.mark.parametrize("fault", ["magic", "block_crc", "compressed", "data_crc", "dtype",
                                       "sliced"])
    def test_faults_raise(self, assets, tmp_path, fault):
        prefix, data, offset, size = self._index(assets, tmp_path)
        name = "RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w"
        if fault == "magic":
            data[-1] ^= 0x01
            match = "bad magic number"
        elif fault == "block_crc":
            data[offset + 3] ^= 0x01
            match = "crc mismatch in the block"
        elif fault == "compressed":
            data[offset + size] = 1  # snappy, with a crc that matches it
            data[offset + size + 1: offset + size + 5] = struct.pack(
                "<I", masked_crc32c(bytes(data[offset: offset + size + 1])))
            match = "compressed"
        elif fault == "data_crc":
            entry = BundleReader(prefix).entries[name]
            with open(prefix + ".data-00000-of-00001", "r+b") as f:
                f.seek(entry.offset + 5)
                byte = f.read(1)
                f.seek(entry.offset + 5)
                f.write(bytes([byte[0] ^ 0x10]))
            match = "crc mismatch in"
        open(prefix + ".index", "wb").write(bytes(data))
        with pytest.raises(BundleError, match=match if fault not in ("dtype", "sliced") else None):
            reader = BundleReader(prefix)
            if fault == "dtype":
                reader.entries[name].dtype = 7  # DT_STRING
            if fault == "sliced":
                reader.entries[name].sliced = True
            reader.tensor(name)


# ---------------- the name map and the conversion ----------------

class TestConversion:
    @pytest.mark.parametrize("world", list(WORLDS))
    def test_equals_the_jax_conversion_carried_across(self, assets, world):
        a = assets[world]
        got = convert_i3d_checkpoint(a["prefix"], eval_type=world)
        want = from_flax_variables(_flax(j_convert_ckpt(a["prefix"], eval_type=world)))
        _assert_states_equal(got, want)
        _assert_states_equal(got, a["state"])
        assert set(got) == set(state_shapes(WORLDS[world]))

    @pytest.mark.parametrize("world", list(WORLDS))
    def test_var_map_equals_the_jax_fake_assets(self, assets, world):
        """The port's i3d_var_map (state dict -> DeepMind names) is the JAX
        package's on the same weights."""
        bare = world == "rgb600"
        got = i3d_var_map(assets[world]["state"], bare_names=bare)
        want = jfake.i3d_var_map(assets[world]["variables"], bare_names=bare)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_worlds_do_not_mix(self, assets):
        """Bare names are not the rgb world's; rgb600 also takes prefixed ones."""
        with pytest.raises(ValueError, match="no RGB/inception_i3d variables"):
            convert_i3d_checkpoint(assets["rgb600"]["prefix"], eval_type="rgb")
        _assert_states_equal(convert_i3d_checkpoint(assets["rgb"]["prefix"], eval_type="rgb600"),
                             assets["rgb"]["state"])
        with pytest.raises(ValueError, match="eval_type"):
            convert_i3d_checkpoint(assets["rgb"]["prefix"], eval_type="flow")


# ---------------- weight files and the CLI ----------------

class TestCli:
    @pytest.mark.parametrize("world", list(WORLDS))
    def test_converts_to_a_pt(self, assets, tmp_path, world, capsys):
        out = str(tmp_path / "w.pt")
        argv = ["i3d", assets[world]["prefix"], "--out", out]
        cli.main(argv + (["--eval-type", "rgb600"] if world == "rgb600" else []))
        assert f"wrote {out}" in capsys.readouterr().out
        _assert_states_equal(load_weights(out), assets[world]["state"])
        # a .pt input is taken as converted already
        again = str(tmp_path / "again.pt")
        cli.main(["i3d", out, "--out", again])
        _assert_states_equal(load_weights(again), assets[world]["state"])

    def test_unported_inputs_raise(self, tmp_path):
        """A video ResNet converts now (tests/test_torch_port_video_resnet.py);
        a missing .pth or a TF prefix for one still raises, and so does an
        I3D run with nothing to do."""
        with pytest.raises(FileNotFoundError):
            cli.main(["r2plus1d_18", str(tmp_path / "x.pth"), "--out", str(tmp_path / "w.pt")])
        with pytest.raises(ValueError, match=".pt/.pth or a .msgpack"):
            cli.main(["r2plus1d_18", str(tmp_path / "model.ckpt"), "--out", str(tmp_path / "w.pt")])
        with pytest.raises(SystemExit):
            cli.main(["i3d", str(tmp_path / "x")])

    def test_dump_golden_in_the_jax_format(self, assets, jax_golden, tmp_path, monkeypatch):
        """The CLI's golden file has the JAX package's keys and dtypes, and
        its logits and top-5 agree with the JAX package's dump."""
        monkeypatch.setitem(golden.GOLDEN_GEOMETRY, "tanh", (FRAMES, SIZE))
        out, npz = str(tmp_path / "weights.pt"), str(tmp_path / "g.npz")
        cli.main(["i3d", assets["rgb"]["prefix"], "--out", out, "--dump-golden", npz,
                  "--device", "cpu"])
        got, want = np.load(npz), np.load(jax_golden)
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        for k in ("model", "num_classes", "frames", "size", "seed", "norm_world", "top5"):
            assert (got[k] == want[k]).all(), k
        assert str(got["weights_file"]) == "weights.pt"
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4, rtol=1e-4)
        golden.verify_golden(npz, device="cpu")


# ---------------- logits and golden files ----------------

class TestGolden:
    def test_logits_match_jax(self, assets, jax_golden):
        """The port's f32 logits on the converted weights against the JAX
        package's (recorded in its golden file) at 8x16x16."""
        state = convert_i3d_checkpoint(assets["rgb"]["prefix"])
        got = golden.compute_logits("i3d", state, 400, device="cpu", geometry=(FRAMES, SIZE))
        want = np.load(jax_golden)["logits"]
        assert got.shape == want.shape == (1, 400)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_canonical_clip_equals_the_jax_packages(self):
        np.testing.assert_array_equal(golden.canonical_clip("tanh", FRAMES, SIZE),
                                      jgolden.canonical_clip("tanh", FRAMES, SIZE))

    @pytest.mark.parametrize("weights", ["recorded_pt", "tf_prefix"])
    def test_jax_golden_verifies_in_the_port(self, assets, jax_golden, weights):
        path = None if weights == "recorded_pt" else assets["rgb"]["prefix"]
        report = golden.verify_golden(jax_golden, weights_path=path, device="cpu")
        assert report["top5_recomputed"] == report["top5_recorded"]
        assert report["max_abs_diff"] < 1e-4

    def test_drift_is_caught(self, assets, jax_golden, tmp_path):
        state = {k: v.clone() for k, v in assets["rgb"]["state"].items()}
        state["Logits.Conv3d_0c_1x1.conv_3d.bias"] += 0.05
        path = str(tmp_path / "drift.pt")
        save_weights(state, path)
        with pytest.raises(AssertionError):
            golden.verify_golden(jax_golden, weights_path=path, device="cpu")


# ---------------- build_victim and the runners ----------------

class TestBuildVictim:
    @pytest.mark.parametrize("source", ["tf_prefix", "pt", "rgb600_prefix"])
    def test_loads_the_file_without_a_warning(self, assets, source, capsys):
        world = "rgb600" if source == "rgb600_prefix" else "rgb"
        path = assets[world]["pt" if source == "pt" else "prefix"]
        model = tcommon.build_victim("i3d", path, torch.float32, FRAMES, SIZE, eval_type=world,
                                     device="cpu")
        assert "[warn]" not in capsys.readouterr().out
        assert model.num_classes == WORLDS[world]  # rgb600: the head from the checkpoint
        _assert_states_equal(model.state_dict(), assets[world]["state"])

    def test_msgpack_raises(self, tmp_path):
        """A .msgpack that holds no Flax I3D variables (an empty map) is
        refused by name."""
        path = tmp_path / "i3d.msgpack"
        path.write_bytes(b"\x80")
        with pytest.raises(ValueError, match="params"):
            tcommon.build_victim("i3d", str(path), torch.float32, FRAMES, SIZE, device="cpu")

    def test_msgpack_gives_the_logits_of_the_pt(self, assets, tmp_path, capsys):
        """build_victim on a flax-written .msgpack of the JAX I3D's variables:
        the same weights, bit for bit, and the same logits as the .pt route."""
        path = str(tmp_path / "i3d.msgpack")
        with open(path, "wb") as f:
            f.write(flax.serialization.msgpack_serialize(assets["rgb"]["variables"]))
        models = {src: tcommon.build_victim("i3d", p, torch.float32, FRAMES, SIZE, device="cpu")
                  for src, p in (("msgpack", path), ("pt", assets["rgb"]["pt"]))}
        assert "[warn]" not in capsys.readouterr().out
        _assert_states_equal(models["msgpack"].state_dict(), models["pt"].state_dict())
        clip = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (1, FRAMES, SIZE, SIZE, 3))
                                .astype(np.float32))
        with torch.no_grad():
            logits = {k: m(clip)[0] for k, m in models.items()}
        assert torch.equal(logits["msgpack"], logits["pt"])

    def test_rgb600_engine_and_labels(self, assets):
        cfg = tconfig.default_config()
        cfg.MODEL.CKPT_PATH = assets["rgb600"]["prefix"]
        cfg.MODEL.EVAL_TYPE = "rgb600"
        cfg.SINGLE_VIDEO_ATTACK.COMPUTE_DTYPE = "float32"
        with contextlib.redirect_stdout(io.StringIO()):
            engine, labels = tcommon.build_engine(cfg.SINGLE_VIDEO_ATTACK, cfg.MODEL,
                                                  frames=FRAMES, size=SIZE, device="cpu")
        assert engine.model.num_classes == 600
        assert labels == tlabels.kinetics600_labels()


def _write_shards(shard_dir):
    rng = np.random.default_rng(5)
    shard_dir.mkdir()
    for s in range(2):
        with jtfr.TFRecordWriter(str(shard_dir / f"s{s}.tfrecords")) as w:
            for n in (FRAMES, FRAMES + 2, FRAMES - 1, FRAMES):
                clip = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
                w.write(jtfr.make_uint8_example(clip, int(rng.integers(0, 400))))


def test_universal_runner_on_a_checkpoint_reads_the_same_natively(assets, tmp_path, monkeypatch):
    """The universal runner on the converted rgb checkpoint: native shards
    (the default) and use_native=False give the same losses in res.pkl."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the JSONL scalar writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    shard_dir = tmp_path / "shards"
    _write_shards(shard_dir)
    results = {}
    for native in (True, False):
        cfg = tconfig.default_config()
        cfg.MODEL.CKPT_PATH = assets["rgb"]["pt"]
        ac = cfg.UNIVERSAL_ATTACK
        ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [str(shard_dir)]
        ac.NUM_OF_TRAIN_TF_RECORDS, ac.NUM_OF_VAL_TF_RECORDS = 2, 1
        ac.BATCH_SIZE = 2
        ac.PKL_RESULT_PATH = str(tmp_path / f"out_{native}")
        ac.COMPUTE_DTYPE = "float32"
        ac.MAX_NUM_STEP = 2  # the second batch spans the two shards
        if not native:
            monkeypatch.setattr(tuniversal, "tfrecord_batches",
                                lambda *a, **kw: ttfr.tfrecord_batches(*a, use_native=False, **kw))
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            tuniversal.run(cfg, frames=FRAMES, size=SIZE, device="cpu")
        assert "[warn]" not in said.getvalue() and "host-prepacked" in said.getvalue()
        with open(os.path.join(tuniversal.model_dir_name(ac), "res.pkl"), "rb") as f:
            results[native] = pickle.load(f)
    got, want = results[True]["history"], results[False]["history"]
    assert got["total_loss"] and all(np.isfinite(got["total_loss"]))
    for k in ("total_loss", "adv_loss", "reg_loss", "fool_rate"):
        assert got[k] == want[k], k
    assert len(got["perturbation"]) == len(want["perturbation"]) == 1
    for a, b in zip(got["perturbation"], want["perturbation"]):
        np.testing.assert_array_equal(a, b)
    assert results[True]["final_eval"] == results[False]["final_eval"]


# ---------------- .msgpack: flax's format in the port's own codec ----------------

def _assert_trees_equal(got, want):
    """Equal dict trees: the same keys, and leaves of one dtype and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    assert type(got) is type(want) and got == want


# every msgpack form flax writes: fixed and 8/16/32/64-bit ints, floats, str
# and bin lengths across their boundaries, maps and arrays above 15 entries,
# numpy scalars, empty and 0-d arrays, every numpy dtype I3D trees hold
CODEC_TREES = {
    "ints": {"v": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32,
                   -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]},
    "floats": {"a": 1.5, "b": -0.0, "c": 1e300, "d": float("inf")},
    "strings": {"s": "x" * 31, "t": "y" * 32, "u": "z" * 256, "v": "w" * 70000, "e": ""},
    "containers": {"m": {str(i): i for i in range(17)}, "l": list(range(16)), "n": None,
                   "t": True, "f": False},
    "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4), "f16": np.ones(3, np.float16),
               "i64": np.arange(-3, 3, dtype=np.int64), "u8": np.arange(7, dtype=np.uint8),
               "b": np.array([True, False]), "e": np.zeros((0, 3), np.float32),
               "z": np.array(2.5, np.float64), "s": np.float32(7), "i": np.int32(-9)},
}


class TestFlaxMsgpack:
    @pytest.mark.parametrize("name", list(CODEC_TREES))
    def test_codec_writes_and_reads_flaxs_bytes(self, name):
        tree = CODEC_TREES[name]
        data = flax.serialization.msgpack_serialize(tree)
        assert flax_msgpack.serialize(tree) == data
        _assert_trees_equal(flax_msgpack.restore(data), flax.serialization.msgpack_restore(data))

    def test_bfloat16_leaf(self):
        data = flax.serialization.msgpack_serialize(
            {"w": jax.numpy.arange(6, dtype=jax.numpy.bfloat16).reshape(2, 3)})
        got = flax_msgpack.restore(data)["w"]
        assert got.dtype == torch.bfloat16 and got.shape == (2, 3)
        assert torch.equal(got.float(), torch.arange(6.0).reshape(2, 3))

    def test_malformed_bytes_raise(self):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.restore(b"\x92\x01")
        with pytest.raises(ValueError, match="trailing"):
            flax_msgpack.restore(b"\x01\x02")
        with pytest.raises(ValueError, match="0xc1"):
            flax_msgpack.restore(b"\xc1")

    def test_to_flax_variables_is_the_jax_tree(self, assets):
        """The state as the JAX I3D's Flax variables: the tree the JAX
        package's converter builds from the same checkpoint, value for value,
        and back."""
        for world in WORLDS:
            got = to_flax_variables(assets[world]["state"])
            want = assets[world]["variables"]
            assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
            jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
            _assert_states_equal(from_flax_variables(got), assets[world]["state"])

    def test_flax_written_file_read_by_the_port(self, assets, tmp_path):
        path = str(tmp_path / "v.msgpack")
        data = flax.serialization.msgpack_serialize(assets["rgb"]["variables"])
        with open(path, "wb") as f:
            f.write(data)
        _assert_trees_equal(cli.load_variables(path), flax.serialization.msgpack_restore(data))
        _assert_states_equal(load_weights(path), assets["rgb"]["state"])

    def test_port_written_file_read_by_flax(self, assets, tmp_path):
        path = str(tmp_path / "v.msgpack")
        save_weights(assets["rgb"]["state"], path)
        with open(path, "rb") as f:
            data = f.read()
        assert data == flax.serialization.msgpack_serialize(assets["rgb"]["variables"])
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               flax.serialization.msgpack_restore(data),
                               assets["rgb"]["variables"])

    def test_chunked_arrays_both_ways(self, assets, tmp_path, monkeypatch):
        """Arrays above MAX_CHUNK_SIZE (here 64 KiB: every Mixed 3x3x3 kernel
        and the Logits kernel) are written in flax's chunks and reassembled."""
        variables = assets["rgb"]["variables"]
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 65536)
        data = flax.serialization.msgpack_serialize(variables)
        assert data.count(b"__msgpack_chunked_array__") > 10
        path = str(tmp_path / "chunked.msgpack")
        with open(path, "wb") as f:
            f.write(data)
        _assert_trees_equal(cli.load_variables(path), flax.serialization.msgpack_restore(data))
        _assert_states_equal(load_weights(path), assets["rgb"]["state"])
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 65536)
        save_variables(variables, str(tmp_path / "port.msgpack"))
        with open(tmp_path / "port.msgpack", "rb") as f:
            assert f.read() == data

    def test_cli_writes_and_reads_a_msgpack(self, assets, tmp_path, capsys):
        out = str(tmp_path / "w.msgpack")
        cli.main(["i3d", assets["rgb"]["prefix"], "--out", out])
        assert f"wrote {out}" in capsys.readouterr().out
        _assert_states_equal(load_weights(out), assets["rgb"]["state"])
        pt = str(tmp_path / "w.pt")
        cli.main(["i3d", out, "--out", pt])  # a .msgpack input is converted already
        _assert_states_equal(load_weights(pt), assets["rgb"]["state"])


def test_universal_runner_on_a_msgpack_equals_the_pt(assets, tmp_path, monkeypatch):
    """The universal runner with a .msgpack CKPT_PATH (the port's own
    save_variables) runs the attack of the .pt route, loss for loss."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    shard_dir = tmp_path / "shards"
    _write_shards(shard_dir)
    msgpack = str(tmp_path / "w.msgpack")
    save_variables(to_flax_variables(assets["rgb"]["state"]), msgpack)
    results = {}
    for src, path in (("msgpack", msgpack), ("pt", assets["rgb"]["pt"])):
        cfg = tconfig.default_config()
        cfg.MODEL.CKPT_PATH = path
        ac = cfg.UNIVERSAL_ATTACK
        ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [str(shard_dir)]
        ac.NUM_OF_TRAIN_TF_RECORDS, ac.NUM_OF_VAL_TF_RECORDS = 2, 1
        ac.BATCH_SIZE, ac.MAX_NUM_STEP, ac.COMPUTE_DTYPE = 2, 1, "float32"
        ac.PKL_RESULT_PATH = str(tmp_path / f"out_{src}")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            out = tuniversal.run(cfg, frames=FRAMES, size=SIZE, device="cpu")
        assert "[warn]" not in said.getvalue()
        results[src] = out
    assert results["msgpack"]["history"]["total_loss"] == results["pt"]["history"]["total_loss"]
    assert torch.equal(results["msgpack"]["state"].delta, results["pt"]["state"].delta)
