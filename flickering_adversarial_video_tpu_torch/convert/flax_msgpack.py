"""flax's ``msgpack_serialize`` / ``msgpack_restore`` format in pure Python.

The JAX package stores Flax variables as ``.msgpack`` files
(``convert/cli.py:22-33`` there: ``flax.serialization.msgpack_serialize``).
The card's machine has neither flax nor the ``msgpack`` package, so the port
reads and writes the format itself:

* msgpack maps, arrays, str, bin, nil, booleans, ints and floats (every
  format of the msgpack spec);
* ExtType 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
  bytes)``, and ExtType 3, a numpy scalar (the same, of shape ()); a
  ``bfloat16`` array, which numpy cannot hold, is read as a
  ``torch.bfloat16`` tensor (and not written);
* flax's chunked arrays: an array of more than ``MAX_CHUNK_SIZE`` bytes is
  written as the map ``{'__msgpack_chunked_array__': True, 'shape': {'0':
  ..}, 'chunks': {'0': flat chunk, ..}}``, the chunks each of
  ``MAX_CHUNK_SIZE // itemsize`` elements, and read back as one array, as
  flax's ``_chunk`` / ``_unchunk`` do.

``restore(serialize(tree))`` gives the tree back; ``serialize`` writes the
bytes flax writes (map keys sorted, as flax's copy of the tree has them), and
``restore`` reads what flax reads.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---- decoding -----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self.unpack(">b"), n)
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self.unpack(">" + "BHI"[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value(raw) for _ in range(self.unpack(">" + "HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self._map(self.unpack(">" + "HI"[b - 0xDE]), raw)
        raise ValueError(f"msgpack byte 0x{b:02x} is not a type (0xc1 is never used)")

    def _str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def _map(self, n: int, raw: bool) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError(f"msgpack ExtType {code} is not one flax writes for arrays")


def _ndarray_from_bytes(payload: bytes):
    r = _Reader(payload)
    shape, name, buf = r.value(raw=True)  # flax packs these with use_bin_type, reads raw
    if r.pos != len(payload):
        raise ValueError("trailing bytes after an ndarray payload")
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        import torch

        n = int(np.prod(shape, dtype=np.int64))
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16, count=n).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: the tree of dicts (str keys) with
    numpy array leaves."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after the msgpack object")
    return _unchunk(tree)


# ---- encoding -----------------------------------------------------------------

def _len_header(n: int, fix: int, fix_max: int, codes: str, out: bytearray) -> None:
    """A length header: the fixed form below fix_max, else the 8/16/32-bit
    codes (a space-separated triple; '-' where the form does not exist)."""
    if n < fix_max and fix >= 0:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes.split(), "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code != "-" and n < limit:
            out.append(int(code, 16))
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _ext_header(code: int, n: int, out: bytearray) -> None:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    else:
        _len_header(n, -1, 0, "c7 c8 c9", out)
    out += struct.pack(">b", code)


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, dict):
        _len_header(len(x), 0x80, 16, "- de df", out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _len_header(len(x), 0x90, 16, "- dc dd", out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, str):
        s = x.encode("utf-8")
        _len_header(len(s), 0xA0, 32, "d9 da db", out)
        out += s
    elif isinstance(x, (bytes, bytearray, memoryview)):
        s = bytes(x)
        _len_header(len(s), -1, 0, "c4 c5 c6", out)
        out += s
    elif isinstance(x, np.ndarray):
        payload = _ndarray_to_bytes(x)
        _ext_header(EXT_NDARRAY, len(payload), out)
        out += payload
    elif isinstance(x, np.generic):
        payload = _ndarray_to_bytes(np.asarray(x))
        _ext_header(EXT_NPSCALAR, len(payload), out)
        out += payload
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} in flax's msgpack format")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    forms = ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16), (0xCE, ">I", 0, 1 << 32),
             (0xCF, ">Q", 0, 1 << 64)) if n >= 0 else (
        (0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0), (0xD2, ">i", -(1 << 31), 0),
        (0xD3, ">q", -(1 << 63), 0))
    for code, fmt, lo, hi in forms:
        if lo <= n < hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    out = bytearray()
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], out)
    return bytes(out)


def _chunk(tree: Any) -> Any:
    if isinstance(tree, dict):  # keys sorted, as flax's copy of the tree has them
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {
            _CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in enumerate(range(0, flat.size, size))},
        }
    return tree


def serialize(tree: Any) -> bytes:
    """flax.serialization.msgpack_serialize of a tree of dicts with numpy
    array and Python-scalar leaves."""
    out = bytearray()
    _pack(_chunk(tree), out)
    return bytes(out)
