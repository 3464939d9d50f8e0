"""Minimal tf.train.Example wire codec — no TensorFlow dependency.

The port's own copy of the JAX package's ``data/example_proto.py``.  The
reference's tfrecord schemas use two features per record:
    'train/label' : Int64List (one element)
    'train/video' : BytesList (raw uint8 [T,224,224,3] bytes), or, in the
                    float schema, FloatList (the clip's f32 values)

This module encodes/decodes exactly that subset of the Example proto wire
format (proto3 encoding rules), byte-compatible with records produced by the
reference writers and by the JAX package's codec.  A FloatList is written
packed and read packed or repeated.

Wire format recap:
    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }       (repeated k/v entry)
    Feature  { BytesList bytes_list = 1 | FloatList float_list = 2 |
               Int64List int64_list = 3; }
    BytesList{ repeated bytes value = 1; }
    FloatList{ repeated float value = 1 [packed]; }
    Int64List{ repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

FeatureValue = Union[bytes, int, list]


# ---------------- varint ----------------

def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _tag(field: int, wire_type: int) -> int:
    return (field << 3) | wire_type


# ---------------- encoding ----------------

def _encode_length_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


def _encode_bytes_list(values) -> bytes:
    out = bytearray()
    for v in values:
        _encode_length_delimited(out, 1, bytes(v))
    return bytes(out)


def _encode_float_list(values: np.ndarray) -> bytes:
    out = bytearray()
    payload = np.asarray(values, "<f4").tobytes()
    _encode_length_delimited(out, 1, payload)  # packed
    return bytes(out)


def _encode_int64_list(values) -> bytes:
    inner = bytearray()
    for v in values:
        _write_varint(inner, int(v) & 0xFFFFFFFFFFFFFFFF)
    out = bytearray()
    _encode_length_delimited(out, 1, bytes(inner))  # packed
    return bytes(out)


def encode_example(features: Dict[str, Tuple[str, FeatureValue]]) -> bytes:
    """features: {name: (kind, value)}, kind in {'bytes','float','int64'}."""
    feats = bytearray()
    for name, (kind, value) in features.items():
        feature = bytearray()
        if kind == "bytes":
            values = [value] if isinstance(value, (bytes, bytearray)) else value
            _encode_length_delimited(feature, 1, _encode_bytes_list(values))
        elif kind == "float":
            _encode_length_delimited(feature, 2, _encode_float_list(value))
        elif kind == "int64":
            values = [value] if isinstance(value, (int, np.integer)) else value
            _encode_length_delimited(feature, 3, _encode_int64_list(values))
        else:
            raise ValueError(kind)
        entry = bytearray()
        _encode_length_delimited(entry, 1, name.encode())
        _encode_length_delimited(entry, 2, bytes(feature))
        feats_entry = bytearray()
        _encode_length_delimited(feats_entry, 1, bytes(entry))
        feats += feats_entry
    example = bytearray()
    _encode_length_delimited(example, 1, bytes(feats))
    return bytes(example)


# ---------------- decoding ----------------

def _iter_fields(buf: memoryview):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 2:
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos : pos + length]
            pos += length
        elif wire_type == 0:
            value, pos = _read_varint(buf, pos)
            yield field, value
        elif wire_type == 5:
            yield field, buf[pos : pos + 4]
            pos += 4
        elif wire_type == 1:
            yield field, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")


def _decode_feature(buf: memoryview):
    for field, payload in _iter_fields(buf):
        if field == 1:  # BytesList
            values = [bytes(v) for f, v in _iter_fields(payload) if f == 1]
            return ("bytes", values)
        if field == 2:  # FloatList (packed, or repeated fixed32)
            floats = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    floats.append(np.frombuffer(bytes(v), "<f4"))
            return ("float", np.concatenate(floats) if floats else np.zeros(0, "f4"))
        if field == 3:  # Int64List
            ints = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    mv = memoryview(bytes(v))
                    pos = 0
                    while pos < len(mv):
                        val, pos = _read_varint(mv, pos)
                        if val >= 1 << 63:
                            val -= 1 << 64
                        ints.append(val)
            return ("int64", ints)
    return ("bytes", [])


def decode_example(data: bytes) -> Dict[str, Tuple[str, FeatureValue]]:
    """Inverse of encode_example: {name: (kind, value)}."""
    out: Dict[str, Tuple[str, FeatureValue]] = {}
    buf = memoryview(data)
    for field, features_buf in _iter_fields(buf):
        if field != 1:
            continue
        for f2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            name = None
            feature = None
            for f3, v in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v).decode()
                elif f3 == 2:
                    feature = _decode_feature(v)
            if name is not None and feature is not None:
                out[name] = feature
    return out
