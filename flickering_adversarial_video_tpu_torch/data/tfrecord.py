"""TFRecord reading/writing + batched host pipeline.

The port's own copy of the JAX package's ``data/tfrecord.py``, cut to what
the runners and the shard writers use.  Schema parity with the reference
writers: 'train/label' int64, 'train/video' bytes (raw uint8 [T,224,224,3];
the parser yields uint8 and the normalization (x/128-1) happens on the
device inside the attack step), or, in the float schema, a FloatList of the
clip's f32 values (``make_float_example``, ``parse_example_float``;
``tfrecord_batches(schema="float")``).  Files are binary-compatible with
TensorFlow's and with the JAX package's.

TFRecord framing: {u64 length, u32 masked-crc32c(length), bytes data,
u32 masked-crc32c(data)}.

``tfrecord_batches`` reads through the native C++ reader
(``data/native_reader.py``) by default, as the JAX package does; unlike the
JAX package, a reader that fails to build raises, and ``use_native=False``
is the only way onto the Python codec below.  The native reader and the
host prepack take the uint8 schema only: the float schema needs
``use_native=False`` and raises otherwise (the JAX package quietly takes
its Python codec there).

``make_tf_dataset`` is the same tf.data pipeline as the JAX package's; it
imports TensorFlow when called (a host tool: the card's machine has none).
Not ported: ``prepack="view"`` (a TPU layout).
"""

from __future__ import annotations

import glob
import os
import struct
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import example_proto
from .packing import pack_video_np

# ---------------- crc32c (Castagnoli), for record framing ----------------

_POLY = 0x82F63B78
_CHUNK = 256          # bytes per lane of the vectorized crc
_SHORT = 2048         # below this the byte loop is as fast


@lru_cache(maxsize=None)
def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[i] = c
    return table


try:  # C-accelerated crc32c where the package is installed
    from google_crc32c import value as _crc32c_fast
except ImportError:
    _crc32c_fast = None


def crc32c_bytewise(data: bytes) -> int:
    """The table walk, one byte per Python iteration (~1 MB/s): the
    reference the vectorized version is tested against."""
    table = _crc_table().tolist()
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _byte_tables(cols: np.ndarray) -> np.ndarray:
    """A GF(2) 32x32 operator given by its 32 columns (cols[k] = image of
    bit k) as four 256-entry tables, one per input byte."""
    idx = np.arange(256, dtype=np.uint32)
    tables = np.zeros((4, 256), np.uint32)
    for k in range(32):
        tables[k // 8] ^= np.where((idx >> (k % 8)) & 1, cols[k], 0).astype(np.uint32)
    return tables


def _apply(tables: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (tables[0][v & 0xFF] ^ tables[1][(v >> 8) & 0xFF]
            ^ tables[2][(v >> 16) & 0xFF] ^ tables[3][v >> 24])


@lru_cache(maxsize=8)
def _shift_tables(length: int, levels: int) -> Tuple[np.ndarray, ...]:
    """Byte tables of the operators 'append length * 2^i zero bytes to the
    crc register', i = 0..levels-1 (what zlib's crc32_combine applies)."""
    table = _crc_table()
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    one = (basis >> 8) ^ table[basis & 0xFF]          # one zero byte
    op, power, n = None, one, length
    while n:                                           # op = one ** length
        if n & 1:
            op = power if op is None else _apply(_byte_tables(power), op)
        n >>= 1
        if n:
            power = _apply(_byte_tables(power), power)
    out = []
    for _ in range(levels):
        t = _byte_tables(op)
        out.append(t)
        op = _apply(t, op)                             # square: twice the length
    return tuple(out)


def crc32c_numpy(data: bytes) -> int:
    """crc32c without a C extension at numpy speed: the message is cut into
    2^k lanes of equal length whose registers advance together (one table
    lookup per byte position over all lanes), and the lanes' crcs are folded
    pairwise with the GF(2) shift operator, as zlib's crc32_combine folds two.

    Uses that a crc with a zero initial register ignores leading zero bytes,
    and that the standard 0xFFFFFFFF initial register equals complementing
    the message's first four bytes."""
    n = len(data)
    if n < _SHORT:
        return crc32c_bytewise(data)
    lanes = 1 << max(0, (n // _CHUNK - 1).bit_length())
    length = -(-n // lanes)
    buf = np.zeros(lanes * length, np.uint8)
    buf[lanes * length - n:] = np.frombuffer(data, np.uint8)
    buf[lanes * length - n: lanes * length - n + 4] ^= 0xFF
    cols = np.ascontiguousarray(buf.reshape(lanes, length).T)   # [length, lanes]
    table = _crc_table()
    crc = np.zeros(lanes, np.uint32)
    for i in range(length):
        crc = (crc >> 8) ^ table[(crc ^ cols[i]) & 0xFF]
    for t in _shift_tables(length, lanes.bit_length() - 1):
        crc = _apply(t, crc[0::2]) ^ crc[1::2]
    return int(crc[0]) ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    if _crc32c_fast is not None:
        return _crc32c_fast(bytes(data))
    return crc32c_numpy(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------- framing ----------------

def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate raw serialized Examples from one tfrecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                return  # truncated shard: stop like tf.data would error-stop
            if verify_crc:
                (expect,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != expect:
                    raise IOError(f"crc mismatch in {path}")
            yield data


class TFRecordWriter:
    """Minimal tfrecord writer (framing + masked crc32c)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------- schema ----------------

LABEL_KEY = "train/label"
VIDEO_KEY = "train/video"


def make_uint8_example(video: np.ndarray, label: int) -> bytes:
    """uint8 schema record (the reference writers' layout)."""
    video = np.ascontiguousarray(video, np.uint8)
    return example_proto.encode_example(
        {
            LABEL_KEY: ("int64", int(label)),
            VIDEO_KEY: ("bytes", video.tobytes()),
        }
    )


def make_float_example(video: np.ndarray, label: int) -> bytes:
    """float schema record (the reference's pre_process_rgb_flow.py layout):
    the clip's values as one packed FloatList."""
    return example_proto.encode_example(
        {
            LABEL_KEY: ("int64", int(label)),
            VIDEO_KEY: ("float", np.asarray(video, np.float32).reshape(-1)),
        }
    )


def parse_example_uint8(
    record: bytes, height: int = 224, width: int = 224, channels: int = 3
) -> Tuple[np.ndarray, int]:
    """-> (uint8 video [T, H, W, C], label).  The reference's cast/128-1 is
    deferred to the device."""
    feats = example_proto.decode_example(record)
    kind, raw = feats[VIDEO_KEY]
    if kind != "bytes":
        raise ValueError(f"'{VIDEO_KEY}' is a {kind} feature, expected bytes")
    video = np.frombuffer(raw[0], np.uint8).reshape(-1, height, width, channels)
    label = int(feats[LABEL_KEY][1][0])
    return video, label


def parse_example_float(
    record: bytes, height: int = 224, width: int = 224, channels: int = 3
) -> Tuple[np.ndarray, int]:
    """-> (f32 video [T, H, W, C], label) of a float schema record."""
    feats = example_proto.decode_example(record)
    kind, values = feats[VIDEO_KEY]
    if kind != "float":
        raise ValueError(f"'{VIDEO_KEY}' is a {kind} feature, expected float")
    video = np.asarray(values, np.float32).reshape(-1, height, width, channels)
    label = int(feats[LABEL_KEY][1][0])
    return video, label


# ---------------- shard listing & host pipeline ----------------

def list_shards(paths: Sequence[str] | str, limit: Optional[int] = None) -> List[str]:
    """Sorted *.tfrecords under each path, truncated to `limit`: the
    reference's shard-selection convention."""
    if isinstance(paths, str):
        paths = [paths]
    shards: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            shards.append(p)
        else:
            shards += sorted(glob.glob(os.path.join(p, "*.tfrecords")))
    return shards[:limit] if limit else shards


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


def _batch_buffer(n: int, shape, pin_memory: bool, dtype=np.uint8):
    """(buffer, numpy view of it) for n clips of `shape` in `dtype` (uint8
    or float32): a page-locked torch tensor from the CUDA caching host
    allocator when `pin_memory`, else a numpy array (the buffer itself)."""
    if pin_memory:
        buf = torch.empty((n, *shape), dtype=_TORCH_DTYPE[np.dtype(dtype)], pin_memory=True)
        return buf, buf.numpy()
    buf = np.empty((n, *shape), dtype)
    return buf, buf


def _native_batches(reader, shards, batch_size, frames, repeat, drop_remainder, packed,
                    pin_memory, key):
    """Fill each batch buffer in place, record by record, straight from the
    shards: one copy a clip (and the pack inside it), no per-record array
    and no stack.  Records run on across shard ends into one batch."""
    shape = reader.packed_shape(frames) if packed else (
        frames, reader.height, reader.width, reader.channels)
    clip_bytes = reader.record_bytes(frames)

    def new():
        buf, view = _batch_buffer(batch_size, shape, pin_memory)
        return buf, view.ctypes.data, np.empty(batch_size, np.int64)

    buf, addr, labels = new()
    filled = 0
    for _ in range(repeat):
        for shard in shards:
            with reader.open(shard) as handle:
                while True:
                    filled += reader.fill(handle, shard, addr + filled * clip_bytes,
                                          labels[filled:], frames, batch_size - filled, packed)
                    if filled < batch_size:
                        break  # the shard is done
                    yield {key: buf, "labels": labels}
                    buf, addr, labels = new()
                    filled = 0
    if filled and not drop_remainder:
        yield {key: buf[:filled], "labels": labels[:filled]}


def tfrecord_batches(
    shards: Sequence[str],
    batch_size: int,
    *,
    frames: Optional[int] = None,
    repeat: int = 1,
    drop_remainder: bool = True,
    schema: str = "uint8",
    height: int = 224,
    width: int = 224,
    use_native: bool = True,
    prepack: bool = False,
    pin_memory: bool = False,
    host_id: int = 0,
    num_hosts: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {'video': uint8 [B,T,H,W,C], 'labels': int64 [B]} batches
    (f32 videos with ``schema="float"``).

    Over ranks (``parallel/mesh.py``): rank `host_id` of `num_hosts` reads
    ``shards[host_id::num_hosts]``, as each JAX host does, and batches of
    its own records; the global batch is the ranks' batches in rank order.

    `frames` crops to the trailing `frames` frames and skips clips that are
    shorter, whatever `prepack` says, so that toggling PREPACK_INPUT never
    changes the dataset's composition.  Records run on across shard ends
    into one batch; `repeat` passes over the shards, and the last partial
    batch is kept unless `drop_remainder`.

    prepack=True yields {'video_packed': [B,T/2,H/2,W/2,8C] uint8} instead:
    the space-to-depth layout of the attack step's input head
    (ops/packed_apply.py), packed on the host (in C++ inside the native
    reader's record copy, or by data.packing.pack_video_np on the Python
    path).  Requires `frames` and even geometry.

    use_native=True (the default) reads through the native C++ reader, and
    raises if it cannot be built; False is the Python codec.  Both give the
    same batches.  The float schema takes the Python codec only
    (use_native=False) and no prepack; asked for either, it raises.

    pin_memory=True puts each batch's video in page-locked memory, a torch
    tensor filled in place, so that the move to the card needs no staging
    copy.  Every batch gets a new buffer from the CUDA caching host
    allocator, which hands a freed buffer out again only after the
    non-blocking copies that read it have completed.
    """
    if prepack not in (False, True):
        raise ValueError(f"prepack={prepack!r}: only False and True are ported")
    if schema not in ("uint8", "float"):
        raise ValueError(f"schema={schema!r}: 'uint8' or 'float'")
    if schema == "float" and (prepack or use_native):
        raise ValueError("the float schema takes neither prepack nor the native reader: pass "
                         "prepack=False, use_native=False")
    if prepack:
        if frames is None:
            raise ValueError("prepack needs fixed `frames`")
        if frames % 2 or height % 2 or width % 2:
            raise ValueError("prepack needs even frames/height/width")
    key = "video_packed" if prepack else "video"
    shards = list(shards)[host_id::num_hosts]

    if use_native:
        from .native_reader import NativeTFRecordReader

        reader = NativeTFRecordReader(height=height, width=width)
        if frames is not None:
            yield from _native_batches(reader, shards, batch_size, frames, repeat,
                                       drop_remainder, prepack, pin_memory, key)
            return
        records = (r for _ in range(repeat) for s in shards for r in reader.read_parsed(s))
    else:
        parse = parse_example_uint8 if schema == "uint8" else parse_example_float
        records = (parse(rec, height=height, width=width)
                   for _ in range(repeat) for s in shards for rec in read_records(s))

    def emit(videos, labels):
        buf, view = _batch_buffer(len(videos), videos[0].shape, pin_memory, videos[0].dtype)
        np.stack(videos, out=view)
        return {key: buf, "labels": np.asarray(labels, np.int64)}

    videos, labels = [], []
    for video, label in records:
        if frames is not None:
            if video.shape[0] < frames:
                continue
            video = video[-frames:]
        if prepack:
            video = pack_video_np(video)
        videos.append(video)
        labels.append(label)
        if len(videos) == batch_size:
            yield emit(videos, labels)
            videos, labels = [], []
    if videos and not drop_remainder:
        yield emit(videos, labels)


def make_tf_dataset(
    shards: Sequence[str],
    batch_size: int,
    *,
    repeat: Optional[int] = None,
    shuffle: int = 0,
    num_parallel_reads: Optional[int] = None,
):
    """tf.data pipeline yielding (uint8 video, int64 label) batches, mirroring
    the estimator input_fn (i3d_adversarial_main_universal.py:231-248) but
    WITHOUT the on-host float conversion; prefetch overlaps with device steps.
    Raises ImportError naming TensorFlow where it is not installed."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("make_tf_dataset needs TensorFlow (tf.data), which is not "
                          "installed; tfrecord_batches reads the same shards without it") from e

    ds = tf.data.TFRecordDataset(
        list(shards), num_parallel_reads=num_parallel_reads or os.cpu_count()
    )
    if shuffle:
        ds = ds.shuffle(shuffle)
    if repeat:
        ds = ds.repeat(repeat)
    ds = ds.batch(batch_size, drop_remainder=True)

    def _parse(serialized):
        feats = tf.io.parse_example(
            serialized,
            {
                LABEL_KEY: tf.io.FixedLenFeature((), tf.int64),
                VIDEO_KEY: tf.io.FixedLenFeature([], tf.string),
            },
        )
        video = tf.io.decode_raw(feats[VIDEO_KEY], tf.uint8)
        video = tf.reshape(video, [tf.shape(serialized)[0], -1, 224, 224, 3])
        return video, feats[LABEL_KEY]

    ds = ds.map(_parse, num_parallel_calls=tf.data.AUTOTUNE)
    return ds.prefetch(tf.data.AUTOTUNE)
