"""ctypes bindings for the port's native TFRecord reader
(``csrc/host/tfrecord_reader.cc``).

The fast host path of the input pipeline: the TFRecord framing and the
Example proto are parsed in C++, and each record's uint8 video is copied
once, straight into the caller's buffer (space-to-depth packed during that
copy in the packed reads).  The port's counterpart of the JAX package's
``data/native_reader.py``, less ``batch_to_view`` (the TPU's batch-in-lanes
layout).

The library is built with the host's ``g++`` at first use, into
``build/torch_kernels/host/<hash of the source and flags>/`` at the root of
the checkout (to a temporary name, then renamed, so that processes building
at the same moment do not collide), and loaded with ``ctypes``.  A build or
load that fails raises: nothing falls back to the Python reader, which only
``tfrecord_batches(use_native=False)`` selects.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from contextlib import contextmanager
from functools import lru_cache
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "tfrecord_reader.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels" / "host"
CXX = "g++"
# no -march=native: it read no faster, and would tie the library to the CPU
# that built it
CXX_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")
LIB_NAME = "libfav_tfrecord_reader.so"
ERRORS = {-1: "truncated record", -2: "crc mismatch", -3: "not a uint8-schema Example"}

_build_lock = threading.Lock()
_P, _L = ctypes.c_void_p, ctypes.c_long


def source_digest() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the reader (once per source and flags); raise if g++ fails."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    with _build_lock:
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}"
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build the native tfrecord reader: {e}") from e
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native tfrecord reader failed ({' '.join(cmd)}; exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tfr_open.restype = _P
    lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.tfr_close.restype = None
    lib.tfr_close.argtypes = [_P]
    lib.tfr_error.restype = _L
    lib.tfr_error.argtypes = [_P]
    lib.tfr_next.restype = _L
    lib.tfr_next.argtypes = [
        _P, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(_L),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    # handle, dst, record_bytes, labels, count
    lib.tfr_read_batch.restype = _L
    lib.tfr_read_batch.argtypes = [_P, _P, _L, _P, _L]
    # handle, dst, frames, height, width, channels, labels, count
    lib.tfr_read_batch_packed.restype = _L
    lib.tfr_read_batch_packed.argtypes = [_P, _P, _L, _L, _L, _L, _P, _L]
    return lib


class NativeTFRecordReader:
    """Streaming reader over uint8-schema shards.  Every read raises
    ``IOError`` at a truncated or malformed record, and at a crc mismatch
    when `verify_crc` is on."""

    def __init__(self, height: int = 224, width: int = 224, channels: int = 3,
                 verify_crc: bool = False):
        self.lib = library()
        self.height = height
        self.width = width
        self.channels = channels
        self.verify_crc = verify_crc

    @contextmanager
    def open(self, path: str):
        handle = self.lib.tfr_open(os.fsencode(path), int(self.verify_crc))
        if not handle:
            raise IOError(f"cannot open {path}")
        try:
            yield handle
        finally:
            self.lib.tfr_close(handle)

    def _raise_on_error(self, handle, path: str) -> None:
        rc = self.lib.tfr_error(handle)
        if rc:
            raise IOError(f"tfrecord {ERRORS.get(rc, f'error {rc}')} in {path}")

    def record_bytes(self, frames: int) -> int:
        return frames * self.height * self.width * self.channels

    def packed_shape(self, frames: int) -> Tuple[int, int, int, int]:
        if frames % 2 or self.height % 2 or self.width % 2:
            raise ValueError("packed read needs even frames/height/width")
        return frames // 2, self.height // 2, self.width // 2, 8 * self.channels

    def fill(self, handle, path: str, dst: int, labels: np.ndarray, frames: int, count: int,
             packed: bool) -> int:
        """Read up to `count` records of `frames` trailing frames from an
        open shard into the buffer at address `dst` (count * record_bytes)
        and `labels` (int64), skipping shorter clips; packed: space-to-depth
        in the copy.  Returns the number filled, fewer than `count` only at
        the end of the shard."""
        if labels.dtype != np.int64 or not labels.flags.c_contiguous or len(labels) < count:
            raise ValueError("labels must be a contiguous int64 array of at least `count`")
        if packed:
            self.packed_shape(frames)
            n = self.lib.tfr_read_batch_packed(
                handle, dst, frames, self.height, self.width, self.channels,
                labels.ctypes.data, count)
        else:
            n = self.lib.tfr_read_batch(
                handle, dst, self.record_bytes(frames), labels.ctypes.data, count)
        self._raise_on_error(handle, path)
        return n

    def read_parsed(self, path: str) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (uint8 video [T,H,W,C], label) per record."""
        frame_bytes = self.record_bytes(1)
        video_p = ctypes.POINTER(ctypes.c_uint8)()
        video_len = _L()
        label = ctypes.c_longlong()
        with self.open(path) as handle:
            while True:
                rc = self.lib.tfr_next(
                    handle, ctypes.byref(video_p), ctypes.byref(video_len), ctypes.byref(label))
                if rc == 0:
                    return
                if rc < 0:
                    raise IOError(f"tfrecord {ERRORS.get(rc, f'error {rc}')} in {path}")
                n = video_len.value
                if n % frame_bytes:
                    raise IOError(f"a video of {n} bytes is no whole number of "
                                  f"{self.height}x{self.width}x{self.channels} frames in {path}")
                arr = np.ctypeslib.as_array(video_p, shape=(n,)) if n else np.empty(0, np.uint8)
                yield (arr.reshape(n // frame_bytes, self.height, self.width, self.channels).copy(),
                       int(label.value))

    def read_parsed_packed(self, path: str, frames: int) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (packed uint8 video [T/2,H/2,W/2,8C], label) per record of
        at least `frames` frames, packed in C++ during the record copy."""
        shape = self.packed_shape(frames)
        label = np.empty(1, np.int64)
        with self.open(path) as handle:
            while True:
                video = np.empty(shape, np.uint8)
                if not self.fill(handle, path, video.ctypes.data, label, frames, 1, packed=True):
                    return
                yield video, int(label[0])

    def _read_batch(self, path: str, frames: int, count: int, packed: bool):
        shape = self.packed_shape(frames) if packed else (
            frames, self.height, self.width, self.channels)
        videos = np.empty((count, *shape), np.uint8)
        labels = np.empty(count, np.int64)
        with self.open(path) as handle:
            n = self.fill(handle, path, videos.ctypes.data, labels, frames, count, packed)
        return videos[:n], labels[:n]

    def read_batch_into(self, path: str, frames: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """Up to `count` clips of `frames` trailing frames from the start of
        `path`: (uint8 [n,T,H,W,C], int64 [n]), one memcpy a clip."""
        return self._read_batch(path, frames, count, packed=False)

    def read_batch_packed(self, path: str, frames: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """As :meth:`read_batch_into`, space-to-depth packed in C++ during the
        copy: (uint8 [n, T/2, H/2, W/2, 8C], int64 [n]), the layout of the
        attack step's packed input head (ops/packed_apply.py)."""
        return self._read_batch(path, frames, count, packed=True)
