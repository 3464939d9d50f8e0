"""The port's data preparation held against the JAX package's on the CPU:
mp4 decoding (``data/video.py``), the float schema (``make_float_example``,
``parse_example_float``, ``tfrecord_batches(schema="float")``), the shard
writers (``data/write_tfrecords.py``, records byte for byte: both writers are
deterministic), the verified npy set (``data/npy.build_verified_npy_set``,
the same files byte for byte) and the Kinetics downloader's offline parts
(``data/kinetics_download.py``, with a stubbed ``urlopen`` and no yt-dlp:
nothing is fetched).

The videos are mp4 files the tests write with cv2 (small frames, resized by
the decoder to the reference's 256 short side and cropped to 224); a test
that needs cv2 skips without it.  Everything is compared exactly: both
packages run the same cv2 and numpy operations.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.data import example_proto as jproto
from flickering_adversarial_video_tpu.data import kinetics_download as jkd
from flickering_adversarial_video_tpu.data import npy as jnpy
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu.data import video as jvideo
from flickering_adversarial_video_tpu.data import write_tfrecords as jwrite
from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
from flickering_adversarial_video_tpu_torch.data import example_proto as tproto
from flickering_adversarial_video_tpu_torch.data import kinetics_download as tkd
from flickering_adversarial_video_tpu_torch.data import npy as tnpy
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.data import video as tvideo
from flickering_adversarial_video_tpu_torch.data import write_tfrecords as twrite
from flickering_adversarial_video_tpu_torch.engine import AttackEngine
from flickering_adversarial_video_tpu_torch.engine.inference import InferenceModel

FRAMES = 6
CLASSES = ["class a", "class b", "class c"]


def _write_mp4(path, frames):
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A class-folder tree of mp4 files: two clips of 10 frames in 'class_a'
    (and one of 2 frames, too short), one in 'class_b', none in 'class_c'."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(41)
    counts = {"class_a": {"a1.mp4": 10, "a2.mp4": 10, "short.mp4": 2},
              "class_b": {"b1.mp4": 10}, "class_c": {}}
    for cls, files in counts.items():
        (root / cls).mkdir()
        for name, n in files.items():
            _write_mp4(root / cls / name,
                       [rng.integers(0, 255, (60, 80, 3), dtype=np.uint8) for _ in range(n)])
    return root


def _tree_bytes(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ---------------- mp4 decoding ----------------

class TestVideoToFrames:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_equals_the_jax_decoder(self, videos, dtype):
        path = str(videos / "class_a" / "a1.mp4")
        got = tvideo.video_to_frames(path, n_steps=FRAMES, dtype=dtype)
        want = jvideo.video_to_frames(path, n_steps=FRAMES, dtype=dtype)
        assert got.shape == (1, FRAMES, 224, 224, 3) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if dtype == "float32":
            assert -1.0 <= got.min() and got.max() <= 1.0

    def test_short_and_unreadable_clips(self, videos, tmp_path):
        short = str(videos / "class_a" / "short.mp4")
        np.testing.assert_array_equal(tvideo.video_to_frames(short, n_steps=FRAMES),
                                      jvideo.video_to_frames(short, n_steps=FRAMES))
        missing = str(tmp_path / "nowhere.mp4")
        assert tvideo.video_to_frames(missing) is None is jvideo.video_to_frames(missing)

    def test_resize_and_crop_equal_the_jax_helpers(self):
        image = np.random.default_rng(42).integers(0, 255, (50, 70, 3), dtype=np.uint8)
        got = tvideo.resize_min_side(image, 64)
        np.testing.assert_array_equal(got, jvideo.resize_min_side(image, 64))
        np.testing.assert_array_equal(tvideo.crop_center(got, 32), jvideo.crop_center(got, 32))

    def test_flow_and_missing_cv2_raise(self, videos, monkeypatch):
        # the flow runs on the card unless device="cpu" is given
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvideo.video_to_frames(str(videos / "class_a" / "a1.mp4"), flow=True)
        monkeypatch.setattr(tvideo, "_HAS_CV2", False)
        with pytest.raises(RuntimeError, match="cv2 unavailable"):
            tvideo.video_to_frames(str(videos / "class_a" / "a1.mp4"))
        with pytest.raises(RuntimeError, match="cv2 unavailable"):
            tvideo.resize_min_side(np.zeros((4, 4, 3), np.uint8))


# ---------------- the float schema ----------------

class TestFloatSchema:
    def test_record_bytes_and_parse_equal_jax(self):
        clip = np.random.default_rng(43).uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
        rec = ttfr.make_float_example(clip, 5)
        assert rec == jtfr.make_float_example(clip, 5)
        got, label = ttfr.parse_example_float(rec, height=8, width=8)
        want, jlabel = jtfr.parse_example_float(rec, height=8, width=8)
        assert label == jlabel == 5 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, clip)
        with pytest.raises(ValueError, match="expected float"):
            ttfr.parse_example_float(ttfr.make_uint8_example(np.zeros((1, 8, 8, 3)), 0),
                                     height=8, width=8)

    def test_packed_and_repeated_float_lists_decode_as_jax(self):
        """A FloatList is written packed; the repeated (fixed32) form other
        writers may emit decodes to the same values."""
        values = np.array([0.5, -1.25, 3.0], np.float32)
        packed = tproto.encode_example({"x": ("float", values), "n": ("int64", [1, -2])})
        assert packed == jproto.encode_example({"x": ("float", values), "n": ("int64", [1, -2])})
        inner = b"".join(b"\x0d" + struct.pack("<f", v) for v in values)  # field 1, fixed32
        feature = b"\x12" + bytes([len(inner)]) + inner                     # FloatList
        entry = b"\x0a\x01x" + b"\x12" + bytes([len(feature)]) + feature
        repeated = b"\x0a" + bytes([len(entry) + 2]) + b"\x0a" + bytes([len(entry)]) + entry
        for rec in (packed, repeated):
            got, want = tproto.decode_example(rec), jproto.decode_example(rec)
            assert got["x"][0] == want["x"][0] == "float"
            np.testing.assert_array_equal(got["x"][1], want["x"][1])
            np.testing.assert_array_equal(got["x"][1], values)

    @pytest.mark.parametrize("frames,drop", [(None, True), (2, False)])
    def test_batches_equal_jax(self, tmp_path, frames, drop):
        rng = np.random.default_rng(44)
        path = str(tmp_path / "f.tfrecords")
        with ttfr.TFRecordWriter(path) as w:
            for i in range(5):
                w.write(ttfr.make_float_example(
                    rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32), i))
        kw = dict(frames=frames, drop_remainder=drop, height=8, width=8, schema="float")
        got = list(ttfr.tfrecord_batches([path], 2, use_native=False, **kw))
        want = list(jtfr.tfrecord_batches([path], 2, **kw))
        assert len(got) == len(want) == (2 if drop else 3)
        for g, w_ in zip(got, want):
            assert g["video"].dtype == np.float32
            np.testing.assert_array_equal(g["video"], w_["video"])
            np.testing.assert_array_equal(g["labels"], w_["labels"])

    def test_pinned_float_batches_and_refusals(self, tmp_path, monkeypatch):
        path = str(tmp_path / "f.tfrecords")
        clip = np.ones((2, 4, 4, 3), np.float32) * 0.25
        with ttfr.TFRecordWriter(path) as w:
            w.write(ttfr.make_float_example(clip, 3))
        pinned = []
        real_empty = torch.empty

        def empty(*a, pin_memory=False, **kw):  # no CUDA here: record the request
            pinned.append(pin_memory)
            return real_empty(*a, **kw)

        monkeypatch.setattr(ttfr.torch, "empty", empty)
        (b,) = ttfr.tfrecord_batches([path], 1, schema="float", use_native=False, height=4,
                                     width=4, pin_memory=True)
        assert pinned == [True] and b["video"].dtype == torch.float32
        np.testing.assert_array_equal(b["video"].numpy(), clip[None])
        for kw in (dict(), dict(use_native=False, prepack=True, frames=2)):
            with pytest.raises(ValueError, match="float schema"):
                next(ttfr.tfrecord_batches([path], 1, schema="float", **kw))
        with pytest.raises(ValueError, match="schema"):
            next(ttfr.tfrecord_batches([path], 1, schema="f16"))


# ---------------- the shard writers ----------------

class TestShardWriters:
    def test_class_shards_byte_equal(self, videos, tmp_path):
        kw = dict(frames=FRAMES, per_shard=1)
        got = twrite.write_class_shards(str(videos / "class_a"), 7, str(tmp_path / "t"), **kw)
        want = jwrite.write_class_shards(str(videos / "class_a"), 7, str(tmp_path / "j"), **kw)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert len(got) == 2  # the short clip is skipped
        assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")
        video, label = ttfr.parse_example_uint8(next(ttfr.read_records(got[0])))
        assert label == 7 and video.shape == (FRAMES, 224, 224, 3)

    def test_shuffled_shards_byte_equal(self, videos, tmp_path):
        kw = dict(frames=FRAMES, per_shard=2, seed=3)
        got = twrite.write_shuffled_shards(str(videos), str(tmp_path / "t"), CLASSES, **kw)
        want = jwrite.write_shuffled_shards(str(videos), str(tmp_path / "j"), CLASSES, **kw)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert len(got) == 2 and _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")

    def test_split_list_float_shard_byte_equal(self, videos, tmp_path):
        split = tmp_path / "testlist.txt"
        split.write_text("class_a/class_a/a1.mp4\nclass_b/class_b/b1.mp4\n"
                         "class_a/class_a/short.mp4\n")
        kw = dict(frames=FRAMES)
        n = twrite.write_split_list_shard(str(split), str(videos), str(tmp_path / "t.tfrecords"),
                                          CLASSES, **kw)
        assert n == jwrite.write_split_list_shard(str(split), str(videos),
                                                  str(tmp_path / "j.tfrecords"), CLASSES, **kw)
        assert n == 2
        assert (tmp_path / "t.tfrecords").read_bytes() == (tmp_path / "j.tfrecords").read_bytes()
        video, label = ttfr.parse_example_float(
            next(ttfr.read_records(str(tmp_path / "t.tfrecords"))))
        assert label == 0 and video.shape == (FRAMES, 224, 224, 3)

    @pytest.mark.parametrize("shuffle", [False, True])
    def test_cli_equals_the_jax_cli(self, videos, tmp_path, capsys, shuffle):
        label_map = tmp_path / "map.txt"
        label_map.write_text("\n".join(CLASSES) + "\n")
        args = ["--videos-dir", str(videos), "--label-map", str(label_map), "--frames",
                str(FRAMES)] + (["--shuffle"] if shuffle else [])
        twrite.main(args + ["--out-dir", str(tmp_path / "t")])
        said = capsys.readouterr().out
        jwrite.main(args + ["--out-dir", str(tmp_path / "j")])
        # a shard a class folder with clips, or one shuffled shard of 50
        assert said == capsys.readouterr().out == f"wrote {1 if shuffle else 2} shards\n"
        assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")


# ---------------- the verified npy set ----------------

class LinearVictim(torch.nn.Module):
    """logits = the clip's mean colour @ w + b: the smallest victim."""

    def __init__(self, w, b):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.asarray(w, np.float32)))
        self.register_buffer("b", torch.from_numpy(np.asarray(b, np.float32)))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w + self.b


class TestVerifiedNpySet:
    def test_same_files_as_jax(self, videos, tmp_path):
        def predict(clip):  # class index 0 ('class a') always
            return np.eye(len(CLASSES))[:1]

        kw = dict(n_frames=FRAMES, num_of_vid=3, predict_fn=predict, class_names=CLASSES,
                  seed=5)
        got = tnpy.build_verified_npy_set(str(videos), dest_folder=str(tmp_path / "t"), **kw)
        want = jnpy.build_verified_npy_set(str(videos), dest_folder=str(tmp_path / "j"), **kw)
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert len(got) == 1 and tnpy.parse_label_from_filename(got[0]) == "class a"
        assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")
        assert tnpy.load_npy_clip(got[0]).shape == (1, FRAMES, 224, 224, 3)

    def test_with_the_ports_inference_model(self, videos, tmp_path):
        """predict_fn is the port's InferenceModel on the CPU (a linear
        victim): a class folder's clip is kept when the victim predicts its
        class, and the same predictions through the JAX function's loop
        keep the same files."""
        w = np.full((3, len(CLASSES)), 0.1, np.float32)
        # a mean colour lies in [-1, 1]: class index 1 ('class b') wins
        engine = AttackEngine(LinearVictim(w, [0.0, 1.0, 0.0]), FlickerSpec(FRAMES))
        predict = InferenceModel(engine)
        clip = tvideo.video_to_frames(str(videos / "class_b" / "b1.mp4"), n_steps=FRAMES)
        assert predict(clip).shape == (1, len(CLASSES)) and int(predict(clip).argmax()) == 1
        kw = dict(n_frames=FRAMES, num_of_vid=3, predict_fn=predict, class_names=CLASSES)
        got = tnpy.build_verified_npy_set(str(videos), dest_folder=str(tmp_path / "t"), **kw)
        want = jnpy.build_verified_npy_set(str(videos), dest_folder=str(tmp_path / "j"), **kw)
        assert [os.path.basename(p) for p in got] == ["rgb_b1@class_b.npy"]
        assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")


# ---------------- the Kinetics downloader, offline ----------------

class FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class TestDownloaderOffline:
    def test_csv_and_report_summary(self, tmp_path):
        csv_path = tmp_path / "ann.csv"
        csv_path.write_text("label,youtube_id,time_start,time_end,split\n"
                            "juggling balls,abc123,0,10,val\n")
        assert tkd.read_kinetics_csv(str(csv_path)) == jkd.read_kinetics_csv(str(csv_path))
        rp = tmp_path / "report.json"
        rp.write_text(json.dumps({"a": "ok", "b": "Video unavailable", "c": "timeout",
                                  "d": "weird", "e": "missing yt-dlp/ffmpeg",
                                  "f": "Copyright claim"}))
        assert tkd.summarize_report(str(rp)) == jkd.summarize_report(str(rp)) == {
            "ok": 1, "unavailable": 1, "timeout": 1, "other": 1, "missing tools": 1,
            "copyright": 1}

    def test_annotation_samples_and_manifest_equal_jax(self):
        assert tkd.ANNOTATION_MANIFEST == jkd.ANNOTATION_MANIFEST
        assert tkd.FFMPEG_FILTER == jkd.FFMPEG_FILTER
        for name in tkd.ANNOTATION_MANIFEST:
            path = tkd.annotation_sample_path(name)
            assert path.startswith(os.path.dirname(tkd.__file__))
            with open(path, "rb") as a, open(jkd.annotation_sample_path(name), "rb") as b:
                assert a.read() == b.read()
            assert len(tkd.read_kinetics_csv(path)) == 100
        with pytest.raises(KeyError):
            tkd.annotation_sample_path("kinetics-700_val")

    def test_resolve_annotation_prefers_a_verified_full_csv(self, tmp_path, monkeypatch):
        name = "kinetics-400_val"
        assert tkd.resolve_annotation_csv(name) == tkd.annotation_sample_path(name)
        full = tmp_path / f"{name}.csv"
        full.write_text("label,youtube_id,time_start,time_end,split\n")
        assert tkd.resolve_annotation_csv(name, str(tmp_path)) == tkd.annotation_sample_path(
            name)  # wrong checksum: the sample
        entry = dict(tkd.ANNOTATION_MANIFEST[name], sha256=hashlib.sha256(
            full.read_bytes()).hexdigest())
        monkeypatch.setitem(tkd.ANNOTATION_MANIFEST, name, entry)
        assert tkd.resolve_annotation_csv(name, str(tmp_path)) == str(full)
        assert tkd.resolve_annotation_csv(str(full)) == str(full)
        with pytest.raises(FileNotFoundError):
            tkd.resolve_annotation_csv("not-a-manifest-name")

    def test_fetch_annotation_verifies_checksum(self, tmp_path, monkeypatch):
        name = "kinetics-600_val"
        good = b"label,youtube_id,time_start,time_end,split\na,b,0,1,val\n"
        entry = dict(tkd.ANNOTATION_MANIFEST[name], sha256=hashlib.sha256(good).hexdigest())
        monkeypatch.setitem(tkd.ANNOTATION_MANIFEST, name, entry)
        calls = []

        def fake_urlopen(url, timeout=0):
            calls.append(url)
            return FakeResponse(good)

        monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
        dest = tkd.fetch_annotation(name, str(tmp_path))
        assert dest.endswith(f"{name}.csv") and calls == [entry["url"]]
        assert tkd.fetch_annotation(name, str(tmp_path)) == dest and len(calls) == 1
        monkeypatch.setattr("urllib.request.urlopen",
                            lambda url, timeout=0: FakeResponse(good + b"tampered"))
        os.remove(dest)
        with pytest.raises(ValueError, match="checksum mismatch"):
            tkd.fetch_annotation(name, str(tmp_path))

    def test_cli_runs_from_the_sample_to_the_downloader(self, tmp_path, monkeypatch, capsys):
        """No yt-dlp: every row of the packaged sample is reported missing
        the tools, the report is written and summarized, nothing fetched."""
        monkeypatch.setattr(tkd, "_downloader_binary", lambda: None)
        monkeypatch.setattr("subprocess.run", lambda *a, **kw: pytest.fail("ran a binary"))
        out = tmp_path / "out"
        tkd.main(["kinetics-400_val", str(out), "--limit", "5", "--jobs", "2"])
        report = json.loads((out / "download_report.json").read_text())
        assert len(report) == 5 and set(report.values()) == {"missing yt-dlp/ffmpeg"}
        assert json.loads(capsys.readouterr().out) == {"missing tools": 5}
        rows = tkd.read_kinetics_csv(tkd.annotation_sample_path("kinetics-400_val"))[:5]
        assert all((out / r["label"].replace(" ", "_")).is_dir() for r in rows)
