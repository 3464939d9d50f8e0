"""Read a TensorFlow V2 checkpoint (a tensor bundle) without TensorFlow.

The port's counterpart of ``tf.train.load_checkpoint`` for the checkpoints a
``tf.train.Saver`` writes: ``<prefix>.index`` and
``<prefix>.data-<k>-of-<n>``.

The index is an SSTable (LevelDB's table format, as TensorFlow's
``core/lib/io/table`` writes it):
- a 48-byte footer at the end: the metaindex and index blocks' handles
  (varint offset, varint size), zero padding, and the magic number
  ``0xdb4775248b80fb57`` (little-endian u64);
- each block is followed by a type byte (0: stored, 1: snappy) and the
  masked crc32c of the block and its type byte;
- a block holds prefix-compressed entries (varint shared, varint unshared,
  varint value length, the key's unshared bytes, the value), then its
  restart offsets (u32 each) and their count (u32);
- the index block maps a key to the handle of the data block holding it.

Its entries: under the key ``""`` a ``BundleHeaderProto`` (num_shards = 1,
endianness = 2, version = 3), under each variable's name a
``BundleEntryProto`` (dtype = 1, shape = 2, shard_id = 3, offset = 4,
size = 5, crc32c = 6 as a masked fixed32, slices = 7).  A tensor is its
``size`` raw little-endian bytes at ``offset`` of data file ``shard_id``.

Raises on a compressed block, a big-endian bundle, a sliced (partitioned)
variable, a dtype it does not know, a bad magic number and a crc mismatch.
The protobuf wire parser is ``data.example_proto``'s, the crc32c
``data.tfrecord``'s.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..data.example_proto import _iter_fields, _read_varint
from ..data.tfrecord import masked_crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
# tensorflow/core/framework/types.proto DataType -> numpy (little-endian)
DTYPES = {
    1: "<f4", 2: "<f8", 3: "<i4", 4: "u1", 5: "<i2", 6: "i1", 9: "<i8", 10: "?",
    17: "<u2", 19: "<f2", 22: "<u4", 23: "<u8",
}


class BundleError(ValueError):
    """The file is not a tensor bundle this reader can read."""


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _handle(buf: memoryview, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def _block(data: bytes, handle: Tuple[int, int], path: str) -> memoryview:
    offset, size = handle
    if offset + size + 5 > len(data):
        raise BundleError(f"{path}: a block handle points past the end of the file")
    body = data[offset: offset + size + 1]
    kind = body[-1]
    (expect,) = struct.unpack("<I", data[offset + size + 1: offset + size + 5])
    if masked_crc32c(body) != expect:
        raise BundleError(f"{path}: crc mismatch in the block at offset {offset}")
    if kind != 0:
        raise BundleError(f"{path}: block at offset {offset} is compressed (type {kind})")
    return memoryview(body)[:-1]


def _entries(block: memoryview, path: str) -> Iterator[Tuple[bytes, memoryview]]:
    if len(block) < 4:
        raise BundleError(f"{path}: a block of {len(block)} bytes")
    (n_restarts,) = struct.unpack("<I", block[-4:])
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise BundleError(f"{path}: a block's restart array overruns it")
    key, pos = b"", 0
    while pos < end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        n_value, pos = _read_varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > end:
            raise BundleError(f"{path}: a malformed block entry")
        key = key[:shared] + bytes(block[pos: pos + unshared])
        pos += unshared
        yield key, block[pos: pos + n_value]
        pos += n_value


def _table(path: str) -> Iterator[Tuple[bytes, memoryview]]:
    """Every (key, value) of an SSTable, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise BundleError(f"{path}: {len(data)} bytes, shorter than a table footer")
    footer = memoryview(data)[-FOOTER_BYTES:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != TABLE_MAGIC:
        raise BundleError(f"{path}: bad magic number {magic:#x}, not a TensorFlow table")
    _, pos = _handle(footer, 0)  # the metaindex: a bundle keeps nothing there
    index, _ = _handle(footer, pos)
    for _, value in _entries(_block(data, index, path), path):
        handle, _ = _handle(value, 0)
        yield from _entries(_block(data, handle, path), path)


class BundleEntry:
    """One variable's BundleEntryProto."""

    def __init__(self, name: str, value: memoryview):
        self.name = name
        self.dtype, self.shape, self.shard_id = 1, (), 0
        self.offset = self.size = 0
        self.crc = None
        self.sliced = False
        for field, v in _iter_fields(value):
            if field == 1:
                self.dtype = v
            elif field == 2:
                self.shape = tuple(_signed(d) for f, dim in _iter_fields(v) if f == 2
                                   for g, d in _iter_fields(dim) if g == 1)
            elif field == 3:
                self.shard_id = v
            elif field == 4:
                self.offset = v
            elif field == 5:
                self.size = v
            elif field == 6:
                (self.crc,) = struct.unpack("<I", v)
            elif field == 7:
                self.sliced = True


class BundleReader:
    """``tf.train.load_checkpoint``'s reader for a V2 checkpoint at `prefix`:
    ``names()``, ``entries[name]`` (dtype, shape, ...) and ``tensor(name)``.  The index is read
    when the reader is made, a tensor's bytes when it is asked for."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = prefix + ".index"
        self.num_shards = 1
        self.entries: Dict[str, BundleEntry] = {}
        for key, value in _table(index):
            if key == b"":
                for field, v in _iter_fields(value):
                    if field == 1:
                        self.num_shards = v
                    elif field == 2 and v != 0:
                        raise BundleError(f"{index}: a big-endian bundle")
                continue
            name = key.decode()
            self.entries[name] = BundleEntry(name, value)

    def names(self) -> List[str]:
        return sorted(self.entries)

    def data_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"

    def tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e.sliced:
            raise BundleError(f"{name}: a sliced (partitioned) variable")
        if e.dtype not in DTYPES:
            raise BundleError(f"{name}: dtype {e.dtype} (tensorflow DataType) is not supported")
        dtype = np.dtype(DTYPES[e.dtype])
        if e.size != int(np.prod(e.shape, dtype=np.int64)) * dtype.itemsize:
            raise BundleError(f"{name}: {e.size} bytes for shape {e.shape} of {dtype}")
        with open(self.data_path(e.shard_id), "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        if len(raw) != e.size:
            raise BundleError(f"{name}: the data file ends inside the tensor")
        if e.crc is not None and masked_crc32c(raw) != e.crc:
            raise BundleError(f"{name}: crc mismatch in {self.data_path(e.shard_id)}")
        return np.frombuffer(raw, dtype).reshape(e.shape).astype(dtype.newbyteorder("="))


def read_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """{variable name: ndarray} of every variable in the checkpoint."""
    reader = BundleReader(prefix)
    return {name: reader.tensor(name) for name in reader.names()}
