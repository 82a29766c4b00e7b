"""Minimal ``tf.train.Example`` wire-format codec (protobuf-free).

The reference parses ImageNet records with ``parse_single_example`` inside
the TF graph (SURVEY.md §3.4 line 3).  The schema is three tiny protobuf
messages; implementing the wire format directly (~100 lines) removes both
the TensorFlow and protobuf runtime dependencies from the ingest path:

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature  { oneof { BytesList = 1; FloatList = 2; Int64List = 3; } }
    BytesList{ repeated bytes value = 1; }
    FloatList{ repeated float value = 1 [packed]; }
    Int64List{ repeated int64 value = 1 [packed]; }

Parsed features come back as ``dict[str, list[bytes] | list[float] |
list[int]]``.  Round-trip compatibility with TF's own serialization is
pinned by test (tests/test_data.py) using TF 2.21 as an oracle.
"""

from __future__ import annotations

import struct
from typing import Mapping, Sequence, Union

FeatureValue = Union[Sequence[bytes], Sequence[float], Sequence[int]]

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto convention
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire == _WIRE_I64:
        pos += 8
    elif wire == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == _WIRE_I32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + n]
            pos += n
        elif wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        else:
            start = pos
            pos = _skip_field(buf, pos, wire)
            yield field, wire, buf[start:pos]


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, wire, payload in _iter_fields(buf):
        if field == 1:  # BytesList
            return [p for f, _, p in _iter_fields(payload) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            values: list[float] = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == _WIRE_LEN:
                    values.extend(
                        struct.unpack(f"<{len(p) // 4}f", p)
                    )
                else:  # unpacked fixed32 slice
                    values.append(struct.unpack("<f", p)[0])
            return values
        if field == 3:  # Int64List (packed or repeated)
            ints: list[int] = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == _WIRE_LEN:
                    pos = 0
                    while pos < len(p):
                        v, pos = _read_varint(p, pos)
                        ints.append(v - (1 << 64) if v >= 1 << 63 else v)
                else:
                    v = p
                    ints.append(v - (1 << 64) if v >= 1 << 63 else v)
            return ints
    return []


def parse_example(serialized: bytes) -> dict[str, FeatureValue]:
    """Parse one serialized Example into ``{name: values}``."""
    features: dict[str, FeatureValue] = {}
    for field, _, payload in _iter_fields(serialized):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(payload):
            if f2 != 1:  # Features.feature map entry
                continue
            key = b""
            value: FeatureValue = []
            for f3, _, p3 in _iter_fields(entry):
                if f3 == 1:
                    key = p3
                elif f3 == 2:
                    value = _parse_feature(p3)
            features[key.decode("utf-8")] = value
    return features


def _encode_len_field(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | _WIRE_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(values: FeatureValue) -> bytes:
    import numbers

    inner = bytearray()
    out = bytearray()
    values = list(values)
    if values and isinstance(values[0], (bytes, str)):
        for v in values:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _encode_len_field(inner, 1, v)
        _encode_len_field(out, 1, bytes(inner))
    elif values and (
        # numpy float32/float64 are not Python floats but must encode as
        # FloatList — Real-but-not-Integral covers both.
        isinstance(values[0], float)
        or (
            isinstance(values[0], numbers.Real)
            and not isinstance(values[0], numbers.Integral)
        )
    ):
        packed = struct.pack(f"<{len(values)}f", *values)
        _encode_len_field(inner, 1, packed)
        _encode_len_field(out, 2, bytes(inner))
    else:  # ints (or empty -> Int64List, TF's convention for empty)
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v))
        _encode_len_field(inner, 1, bytes(packed))
        _encode_len_field(out, 3, bytes(inner))
    return bytes(out)


def build_example(features: Mapping[str, FeatureValue]) -> bytes:
    """Serialize ``{name: values}`` as a tf.train.Example.

    Feature type is inferred from the first element: bytes/str → BytesList,
    float → FloatList, int → Int64List.  Maps are serialized in sorted key
    order for determinism (TF's own serialization order is unspecified).
    """
    feats = bytearray()
    for key in sorted(features):
        entry = bytearray()
        _encode_len_field(entry, 1, key.encode("utf-8"))
        _encode_len_field(entry, 2, _encode_feature(features[key]))
        _encode_len_field(feats, 1, bytes(entry))
    out = bytearray()
    _encode_len_field(out, 1, bytes(feats))
    return bytes(out)
