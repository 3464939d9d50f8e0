"""Record-index loaders on ``torch.utils.data`` (the JAX package's grain pipeline).

The port's own copy of the JAX package's ``data/grain_pipeline.py``, built
on ``torch.utils.data`` and never on grain (``import grain.python`` loads
jax).  An index of (shard, offset, length) record positions is built once
per shard set by scanning the TFRecord framing (lengths only, no payload
parse), so random access into shards is O(1) seeks; a ``DataLoader`` over a
map-style source decodes records, in ``worker_count`` spawned processes when
it is above 0, and delivers them in the sampler's order, and the parent
batches them.

Yields the same {'video': uint8 [B,T,H,W,C], 'labels': int64 [B]} batches
the attack loops consume.

The seeded shuffle is a ``torch.Generator`` permutation for each epoch (the
generator seeded once with ``seed``, one ``randperm`` an epoch); it cannot
equal grain's order (ROADMAP.md queue C).  Because records arrive in the
sampler's order whatever the worker count, every loader here has exact
epoch boundaries: the record at global position p belongs to epoch p // N.
"""

from __future__ import annotations

import multiprocessing
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from .tfrecord import parse_example_uint8


def build_record_index(shards: Sequence[str]) -> List[Tuple[str, int, int]]:
    """[(path, byte_offset, record_len)] for every record in the shard set."""
    index = []
    for path in shards:
        with open(path, "rb") as f:
            offset = 0
            while True:
                header = f.read(12)
                if len(header) < 12:
                    break
                (length,) = struct.unpack("<Q", header[:8])
                index.append((path, offset + 12, length))
                f.seek(length + 4, 1)
                offset += 12 + length + 4
    return index


class TFRecordRandomAccessSource(Dataset):
    """Map-style dataset over a tfrecord record index."""

    def __init__(
        self,
        shards: Sequence[str],
        frames: Optional[int] = None,
        height: int = 224,
        width: int = 224,
    ):
        self._index = build_record_index(shards)
        self._frames = frames
        self._height = height
        self._width = width

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int):
        path, offset, length = self._index[int(i)]
        with open(path, "rb") as f:
            f.seek(offset)
            record = f.read(length)
        video, label = parse_example_uint8(record, height=self._height, width=self._width)
        if self._frames is not None:
            video = video[-self._frames :]
        return {"video": video, "label": np.int64(label)}


def _epoch_order(n: int, shuffle: bool, seed: int, num_epochs: Optional[int]) -> Iterator[int]:
    """Record indices for `num_epochs` epochs (None: forever), each epoch a
    permutation of range(n) drawn from one generator seeded with `seed`, or
    range(n) itself without shuffling."""
    gen = torch.Generator().manual_seed(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        yield from (torch.randperm(n, generator=gen).tolist() if shuffle else range(n))
        epoch += 1


def _item(item):
    return item


def _records(source: TFRecordRandomAccessSource, order, worker_count: int):
    """The source's items in `order`, decoded in `worker_count` spawned
    processes (in the parent when 0).  One iterator: its workers live until
    it is exhausted or dropped."""
    if worker_count == 0:
        return (source[i] for i in order)
    return iter(DataLoader(
        source, batch_size=None, sampler=order, num_workers=worker_count, collate_fn=_item,
        multiprocessing_context=multiprocessing.get_context("spawn"),
    ))


def _batch(items) -> dict:
    return {"video": np.stack([r["video"] for r in items]),
            "labels": np.asarray([r["label"] for r in items], np.int64)}


def grain_batches(
    shards: Sequence[str],
    batch_size: int,
    *,
    frames: Optional[int] = None,
    height: int = 224,
    width: int = 224,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: Optional[int] = 1,
    worker_count: int = 0,
    drop_remainder: bool = True,
):
    """Attack-loop batches over `num_epochs` epochs (ONE-SHOT loader): the
    records of all epochs as one stream, batched in the parent (a batch may
    span an epoch boundary; with drop_remainder the stream's last partial
    batch is dropped).

    worker_count > 0 decodes records in parallel child processes (the
    reference's num_workers=16 DataLoader role, common/gpu.py:57-67).  The
    JAX package's grain loader batches each worker's share of the index on
    its own, so a share below a batch yields nothing there; that
    configuration raises here too, so that one package refuses what the
    other does."""
    source = TFRecordRandomAccessSource(shards, frames, height, width)
    if worker_count > 0 and drop_remainder:
        largest_share = -(-len(source) // max(worker_count, 1))
        if largest_share < batch_size:
            raise ValueError(
                f"{len(source)} records over {worker_count} workers gives at "
                f"most {largest_share}/worker < batch_size={batch_size}: "
                "every worker would drop its partial batch and the loader "
                "would yield nothing; lower worker_count/batch_size or pass "
                "drop_remainder=False"
            )
    order = _epoch_order(len(source), shuffle, seed, num_epochs)
    buf = []
    for rec in _records(source, order, worker_count):
        buf.append(rec)
        if len(buf) == batch_size:
            yield _batch(buf)
            buf = []
    if buf and not drop_remainder:
        yield _batch(buf)


class GrainEpochLoader:
    """Persistent-worker EPOCH-mode pipeline, the pairing for
    ``engine.epoch_fit.fit_universal_epochs``.

    ONE DataLoader (workers spawned once, kept for the whole fit) over
    `epochs` sampler epochs; records arrive in the sampler's global order,
    so epoch boundaries are EXACT: the record at global position p belongs
    to epoch p // N.  Batches are stacked in the parent.

    Usage:
        loader = GrainEpochLoader(shards, batch_size=8, epochs=E)
        fit_universal_epochs(engine, loader.epoch_batches, valid_fn, ...)
    """

    def __init__(
        self,
        shards: Sequence[str],
        batch_size: int,
        *,
        epochs: int,
        frames: Optional[int] = None,
        height: int = 224,
        width: int = 224,
        shuffle: bool = True,
        seed: int = 0,
        worker_count: int = 4,
        drop_remainder: bool = True,
    ):
        source = TFRecordRandomAccessSource(shards, frames, height, width)
        self.records_per_epoch = len(source)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.epochs = epochs
        self.epochs_consumed = 0
        self._it = _records(source, list(_epoch_order(len(source), shuffle, seed, epochs)),
                            worker_count)

    def epoch_batches(self):
        """Yield exactly one epoch's batches (N records, exact boundary)."""
        if self.epochs_consumed >= self.epochs:
            raise RuntimeError(
                f"GrainEpochLoader exhausted: {self.epochs} epochs consumed "
                "(construct with a larger `epochs`)"
            )
        self.epochs_consumed += 1
        buf = []
        for _ in range(self.records_per_epoch):
            buf.append(next(self._it))
            if len(buf) == self.batch_size:
                yield _batch(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield _batch(buf)


def grain_stream(
    shards: Sequence[str],
    batch_size: int,
    *,
    frames: Optional[int] = None,
    height: int = 224,
    width: int = 224,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: Optional[int] = None,
    worker_count: int = 4,
    drop_remainder: bool = True,
):
    """Persistent mode for the step-driven universal attack: ONE worker spawn
    for the whole attack, batches streamed across epoch boundaries.
    num_epochs=None streams forever (the estimator input_fn's .repeat role,
    i3d_adversarial_main_universal.py:238-243)."""
    yield from grain_batches(
        shards,
        batch_size,
        frames=frames,
        height=height,
        width=width,
        shuffle=shuffle,
        seed=seed,
        num_epochs=num_epochs,
        worker_count=worker_count,
        drop_remainder=drop_remainder,
    )
