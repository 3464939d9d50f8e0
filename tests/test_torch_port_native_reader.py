"""The port's native TFRecord reader (``csrc/host/tfrecord_reader.cc`` through
``data/native_reader.py``) and ``data.tfrecord.tfrecord_batches`` on it,
held bit for bit against the port's Python codec and against the JAX
package's Python and native readers.

Shards are written with the JAX package's ``TFRecordWriter`` at 8 frames of
16x16: clips of frames - 1 (skipped), frames and frames + 3 frames, spread
over three shards so that batches span shard ends.  The library is built
with the host's g++ here, as on the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.data import native_reader as jnative
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu_torch.data import native_reader as tnative
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.runners import common as tcommon

FRAMES, SIZE = 8, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# clip lengths a shard: frames - 1 is skipped, frames + 3 cropped to its last 8
LENGTHS = ([8, 7, 11, 8], [8, 8, 7], [11, 8, 8, 8, 8])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(11)
    for i, lengths in enumerate(LENGTHS):
        with jtfr.TFRecordWriter(str(root / f"s{i}.tfrecords")) as w:
            for n in lengths:
                clip = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
                w.write(jtfr.make_uint8_example(clip, int(rng.integers(0, 400))))
    return jtfr.list_shards(str(root))


def _key(prepack):
    return "video_packed" if prepack else "video"


def _assert_same(got, want, key):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {key, "labels"}
        assert g[key].dtype == np.uint8 and g["labels"].dtype == np.int64
        np.testing.assert_array_equal(g[key], w[key])
        np.testing.assert_array_equal(g["labels"], w["labels"])


class TestSameBatches:
    @pytest.mark.parametrize("repeat", [1, 2])
    @pytest.mark.parametrize("drop_remainder", [True, False])
    @pytest.mark.parametrize("prepack", [False, True])
    def test_four_readers_agree(self, shards, prepack, drop_remainder, repeat):
        """The port's native and Python paths, the JAX package's Python path
        and its native reader: the same batches, bit for bit."""
        kw = dict(frames=FRAMES, height=SIZE, width=SIZE, prepack=prepack,
                  drop_remainder=drop_remainder, repeat=repeat)
        native = list(ttfr.tfrecord_batches(shards, 3, **kw))
        key = _key(prepack)
        # 10 clips of at least 8 frames a pass; the second batch spans s0 and s1
        n = 10 * repeat
        assert [len(b["labels"]) for b in native] == [3] * (n // 3) + (
            [] if drop_remainder else [n % 3])
        _assert_same(native, list(ttfr.tfrecord_batches(shards, 3, use_native=False, **kw)), key)
        _assert_same(native, list(jtfr.tfrecord_batches(shards, 3, use_native=False, **kw)), key)
        _assert_same(native, list(jtfr.tfrecord_batches(shards, 3, use_native=True, **kw)), key)

    @pytest.mark.parametrize("drop_remainder", [True, False])
    def test_batch_across_a_shard_end_and_a_remainder(self, shards, drop_remainder):
        """Batches of 4 over 10 clips: the first spans s0 and s1, the
        remainder of two clips is kept or dropped."""
        kw = dict(frames=FRAMES, height=SIZE, width=SIZE, prepack=True,
                  drop_remainder=drop_remainder)
        native = list(ttfr.tfrecord_batches(shards, 4, **kw))
        assert [len(b["labels"]) for b in native] == ([4, 4] if drop_remainder else [4, 4, 2])
        _assert_same(native, list(jtfr.tfrecord_batches(shards, 4, use_native=False, **kw)),
                     "video_packed")

    def test_unfixed_frames_reads_whole_clips(self, shards):
        """frames=None: each record whole, one clip a batch (clips of
        different lengths cannot stack)."""
        kw = dict(height=SIZE, width=SIZE)
        native = list(ttfr.tfrecord_batches(shards[:1], 1, **kw))
        assert [b["video"].shape[1] for b in native] == LENGTHS[0]
        _assert_same(native, list(jtfr.tfrecord_batches(shards[:1], 1, use_native=False, **kw)),
                     "video")

    def test_reader_methods_equal_the_jax_readers(self, shards):
        t = tnative.NativeTFRecordReader(height=SIZE, width=SIZE)
        j = jnative.NativeTFRecordReader(height=SIZE, width=SIZE)
        for shard in shards:
            for (tv, tl), (jv, jl) in zip(t.read_parsed(shard), j.read_parsed(shard), strict=True):
                np.testing.assert_array_equal(tv, jv)
                assert tl == jl
            for (tv, tl), (jv, jl) in zip(t.read_parsed_packed(shard, FRAMES),
                                          j.read_parsed_packed(shard, FRAMES), strict=True):
                np.testing.assert_array_equal(tv, jv)
                assert tl == jl
            for name in ("read_batch_into", "read_batch_packed"):
                for count in (2, 10):
                    tv, tl = getattr(t, name)(shard, FRAMES, count)
                    jv, jl = getattr(j, name)(shard, FRAMES, count)
                    np.testing.assert_array_equal(tv, jv)
                    np.testing.assert_array_equal(tl, jl)


class TestErrors:
    def _corrupt(self, shards, tmp_path):
        """A copy of s0 with one video byte of its first record flipped."""
        data = bytearray(open(shards[0], "rb").read())
        data[12 + 200] ^= 0x5A
        path = tmp_path / "bad.tfrecords"
        path.write_bytes(bytes(data))
        return str(path)

    def test_corrupted_record_raises_under_verify_crc(self, shards, tmp_path):
        bad = self._corrupt(shards, tmp_path)
        strict = tnative.NativeTFRecordReader(height=SIZE, width=SIZE, verify_crc=True)
        with pytest.raises(IOError, match="crc mismatch"):
            strict.read_batch_packed(bad, FRAMES, 4)
        with pytest.raises(IOError, match="crc mismatch"):
            list(strict.read_parsed(bad))
        # without the check the record reads, with the flipped byte in it
        loose = tnative.NativeTFRecordReader(height=SIZE, width=SIZE)
        got, _ = loose.read_batch_into(bad, FRAMES, 4)
        want, _ = loose.read_batch_into(shards[0], FRAMES, 4)
        assert (got != want).sum() == 1
        # the intact shard passes the check
        strict.read_batch_packed(shards[0], FRAMES, 4)

    def test_truncated_shard_raises(self, shards, tmp_path):
        data = open(shards[0], "rb").read()
        path = tmp_path / "cut.tfrecords"
        path.write_bytes(data[: len(data) - 100])
        with pytest.raises(IOError, match="truncated"):
            list(ttfr.tfrecord_batches([str(path)], 2, frames=FRAMES, height=SIZE, width=SIZE))

    def test_a_failed_build_raises(self, monkeypatch, tmp_path, shards):
        """No quiet fallback to the Python reader: a compiler that fails
        makes the default pipeline raise."""
        monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
        monkeypatch.setattr(tnative, "CXX", "false")
        tnative.library.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="building the native tfrecord reader failed"):
                list(ttfr.tfrecord_batches(shards, 2, frames=FRAMES, height=SIZE, width=SIZE))
            assert not list((tmp_path / "build").rglob("*.so*"))
            # the Python reader is there only when asked for
            assert list(ttfr.tfrecord_batches(shards, 2, frames=FRAMES, height=SIZE, width=SIZE,
                                               use_native=False))
        finally:
            tnative.library.cache_clear()

    def test_build_is_keyed_by_source_and_flags(self, monkeypatch):
        digest = tnative.source_digest()
        monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-march=native",))
        assert tnative.source_digest() != digest

    def test_processes_building_at_once(self, tmp_path):
        """Three processes build into one empty directory together: each
        gets a loadable library (temporary names, then a rename)."""
        code = ("import sys; sys.path.insert(0, sys.argv[1]); from pathlib import Path;"
                "from flickering_adversarial_video_tpu_torch.data import native_reader as n;"
                "n.BUILD_ROOT = Path(sys.argv[2]); n.library(); print('ok')")
        procs = [subprocess.Popen([sys.executable, "-c", code, REPO, str(tmp_path)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for _ in range(3)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert all(p.returncode == 0 and out.strip().endswith("ok") for p, out in zip(procs, outs)), outs
        assert [p.name for p in tmp_path.rglob("*.so*")] == [tnative.LIB_NAME]


def test_runner_pipeline_reads_natively_and_pins_only_on_cuda(monkeypatch):
    """make_shard_batches hands the runners' pipeline no use_native (the
    native default holds) and pins only for a CUDA engine."""
    seen = {}

    class Eng:
        device = torch.device("cpu")
        mesh = None  # one process

        def _packed_supported(self):
            return True

    def fake(shards, bs, **kw):
        seen.update(kw)
        return iter(())

    batches, _ = tcommon.make_shard_batches({}, Eng(), fake, frames=FRAMES, size=SIZE,
                                            batch_size=2)
    batches(["x"])
    assert "use_native" not in seen and seen["pin_memory"] is False
