"""The port's record-index loaders (``data/grain_pipeline.py``, on
``torch.utils.data``) and ``tfrecord.make_tf_dataset`` held against the JAX
package's on the CPU.

The shards are written with the port's ``TFRecordWriter`` (records of
[2,224,224,3]: ``make_tf_dataset`` reshapes to 224x224x3 as the JAX one
does).  The record index, the source's items and the unshuffled batches are
equal to the JAX package's; a shuffled epoch cannot be (the port draws a
``torch.Generator`` permutation, grain its own), so shuffled epochs are
compared as multisets of (label, video bytes).  The JAX loaders run with no
grain workers: a spawned grain worker imports jax again.
"""

import hashlib

import numpy as np
import pytest

from flickering_adversarial_video_tpu.data import grain_pipeline as jgrain
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu_torch.data import grain_pipeline as tgrain
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr

N_SHARDS, PER_SHARD, FRAMES = 2, 5, 2
N = N_SHARDS * PER_SHARD


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(21)
    paths = []
    for s in range(N_SHARDS):
        path = str(root / f"shard{s}.tfrecords")
        with ttfr.TFRecordWriter(path) as w:
            for _ in range(PER_SHARD):
                clip = rng.integers(0, 256, (FRAMES, 224, 224, 3), dtype=np.uint8)
                w.write(ttfr.make_uint8_example(clip, int(rng.integers(0, 400))))
        paths.append(path)
    return paths


def _keys(batches):
    """(label, digest of the video) of every record, in order."""
    return [(int(label), hashlib.sha1(video.tobytes()).hexdigest())
            for b in batches for video, label in zip(b["video"], b["labels"])]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["video"], np.asarray(w["video"]))
        np.testing.assert_array_equal(g["labels"], np.asarray(w["labels"]))
        assert g["labels"].dtype == np.int64


class TestRecordIndex:
    def test_index_and_items_equal_jax(self, shards):
        index = tgrain.build_record_index(shards)
        assert index == jgrain.build_record_index(shards)
        assert len(index) == N
        tsrc = tgrain.TFRecordRandomAccessSource(shards, frames=1)
        jsrc = jgrain.TFRecordRandomAccessSource(shards, frames=1)
        assert len(tsrc) == len(jsrc) == N
        for i in range(N):
            got, want = tsrc[i], jsrc[i]
            np.testing.assert_array_equal(got["video"], want["video"])
            assert got["video"].shape == (1, 224, 224, 3)
            assert got["label"] == want["label"] and type(got["label"]) is np.int64


class TestGrainBatches:
    @pytest.mark.parametrize("batch_size,drop_remainder", [(3, True), (4, False)])
    def test_unshuffled_equal_jax(self, shards, batch_size, drop_remainder):
        kw = dict(shuffle=False, worker_count=0, drop_remainder=drop_remainder)
        got = list(tgrain.grain_batches(shards, batch_size, **kw))
        want = list(jgrain.grain_batches(shards, batch_size, **kw))
        _assert_batches_equal(got, want)
        assert sum(len(b["labels"]) for b in got) == (9 if drop_remainder else N)

    def test_shuffled_epochs_equal_as_multisets(self, shards):
        kw = dict(shuffle=True, seed=3, num_epochs=2, worker_count=0)
        got = _keys(tgrain.grain_batches(shards, 5, **kw))
        want = _keys(jgrain.grain_batches(shards, 5, **kw))
        unshuffled = _keys(tgrain.grain_batches(shards, 5, shuffle=False))
        for epoch in range(2):
            part = slice(epoch * N, (epoch + 1) * N)
            assert sorted(got[part]) == sorted(want[part]) == sorted(unshuffled)
        assert got[:N] != unshuffled  # shuffled
        assert got == _keys(tgrain.grain_batches(shards, 5, **kw))  # seeded
        assert got != _keys(tgrain.grain_batches(shards, 5, **{**kw, "seed": 4}))

    def test_worker_share_below_a_batch_raises_in_both(self, shards):
        # 10 records over 4 workers: at most 3 a worker < a batch of 4
        for loader in (tgrain.grain_batches, jgrain.grain_batches):
            with pytest.raises(ValueError, match="drop its partial batch"):
                next(loader(shards, 4, worker_count=4))

    def test_stream_crosses_epochs(self, shards):
        stream = tgrain.grain_stream(shards, 4, worker_count=0, seed=5)
        got = _keys(next(stream) for _ in range(6))  # 24 records: 2.4 epochs
        all_records = sorted(_keys(tgrain.grain_batches(shards, 5, shuffle=False)))
        assert sorted(got[:N]) == sorted(got[N:2 * N]) == all_records
        assert got[:N] == _keys(tgrain.grain_batches(shards, N, seed=5))


class TestEpochLoader:
    def test_two_workers_keep_exact_boundaries(self, shards):
        """2 spawned workers over 2 epochs: every epoch is one permutation of
        the records, in the order the same loader gives without workers."""
        kw = dict(epochs=2, seed=7, drop_remainder=False)
        with_workers = tgrain.GrainEpochLoader(shards, 3, worker_count=2, **kw)
        in_process = tgrain.GrainEpochLoader(shards, 3, worker_count=0, **kw)
        all_records = sorted(_keys(tgrain.grain_batches(shards, 5, shuffle=False)))
        epochs = []
        for _ in range(2):
            got = list(with_workers.epoch_batches())
            assert [len(b["labels"]) for b in got] == [3, 3, 3, 1]
            _assert_batches_equal(got, list(in_process.epoch_batches()))
            assert sorted(_keys(got)) == all_records
            epochs.append(_keys(got))
        assert epochs[0] != epochs[1]  # a permutation an epoch
        with pytest.raises(RuntimeError, match="exhausted"):
            next(with_workers.epoch_batches())


class TestTfData:
    def test_make_tf_dataset_equal_jax(self, shards):
        pytest.importorskip("tensorflow")
        kw = dict(num_parallel_reads=1)
        got = [(v.numpy(), l.numpy()) for v, l in ttfr.make_tf_dataset(shards, 3, **kw)]
        want = [(v.numpy(), l.numpy()) for v, l in jtfr.make_tf_dataset(shards, 3, **kw)]
        assert len(got) == len(want) == 3
        for (gv, gl), (wv, wl) in zip(got, want):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gl, wl)
            assert gv.dtype == np.uint8 and gv.shape == (3, FRAMES, 224, 224, 3)

    def test_make_tf_dataset_names_tensorflow_when_absent(self, shards, monkeypatch):
        import sys

        monkeypatch.setitem(sys.modules, "tensorflow", None)
        with pytest.raises(ImportError, match="TensorFlow"):
            ttfr.make_tf_dataset(shards, 3)
