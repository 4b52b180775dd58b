"""Flagged datum codec (ref: pkg/util/codec/codec.go EncodeValue/EncodeKey).

Keys use comparable encodings (flag + big-endian/memcomparable payload) so
byte order == datum order; values may use compact varint/compact-bytes forms.
Flags per codec.go:41-53 / rowcodec/common.go:42-53.

Copy of `tidb_tpu/codec/datum_codec.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from ..types import Datum, DatumKind, FieldType, MyDecimal, MyTime
from . import number
from .decimal_bin import decode_decimal, encode_decimal

NIL_FLAG = 0
BYTES_FLAG = 1
COMPACT_BYTES_FLAG = 2
INT_FLAG = 3
UINT_FLAG = 4
FLOAT_FLAG = 5
DECIMAL_FLAG = 6
DURATION_FLAG = 7
VARINT_FLAG = 8
VARUINT_FLAG = 9
JSON_FLAG = 10
MAX_FLAG = 250


def encode_datum(d: Datum, comparable: bool = True) -> bytes:
    """Encode one datum (ref: codec.go encode)."""
    k = d.kind
    if k == DatumKind.Null:
        return bytes([NIL_FLAG])
    if k == DatumKind.Int64:
        if comparable:
            return bytes([INT_FLAG]) + number.encode_int_cmp(d.val)
        return bytes([VARINT_FLAG]) + number.encode_varint(d.val)
    if k in (DatumKind.Uint64, DatumKind.MysqlEnum, DatumKind.MysqlSet, DatumKind.MysqlBit):
        if comparable:
            return bytes([UINT_FLAG]) + number.encode_uint_cmp(d.val)
        return bytes([VARUINT_FLAG]) + number.encode_uvarint(d.val)
    if k in (DatumKind.Float32, DatumKind.Float64):
        return bytes([FLOAT_FLAG]) + number.encode_float_cmp(float(d.val))
    if k in (DatumKind.String, DatumKind.Bytes):
        b = d.val.encode() if isinstance(d.val, str) else bytes(d.val)
        if comparable:
            return bytes([BYTES_FLAG]) + number.encode_bytes_cmp(b)
        return bytes([COMPACT_BYTES_FLAG]) + number.encode_compact_bytes(b)
    if k == DatumKind.MysqlDecimal:
        return bytes([DECIMAL_FLAG]) + encode_decimal(d.val)
    if k == DatumKind.MysqlTime:
        packed = d.val.packed if isinstance(d.val, MyTime) else int(d.val)
        if comparable:
            return bytes([UINT_FLAG]) + number.encode_uint_cmp(packed)
        return bytes([VARUINT_FLAG]) + number.encode_uvarint(packed)
    if k == DatumKind.MysqlDuration:
        return bytes([DURATION_FLAG]) + number.encode_int_cmp(d.val)
    if k == DatumKind.MaxValue:
        return bytes([MAX_FLAG])
    raise ValueError(f"cannot encode datum kind {k}")


def encode_datums(ds: list[Datum], comparable: bool = True) -> bytes:
    return b"".join(encode_datum(d, comparable) for d in ds)


def decode_datum(b: bytes, pos: int = 0, ft: FieldType | None = None) -> tuple[Datum, int]:
    """Decode one datum; ft refines time/duration interpretation."""
    flag = b[pos]
    pos += 1
    if flag == NIL_FLAG:
        return Datum.NULL, pos
    if flag == INT_FLAG:
        v, pos = number.decode_int_cmp(b, pos)
        return Datum.i64(v), pos
    if flag == UINT_FLAG:
        v, pos = number.decode_uint_cmp(b, pos)
        if ft is not None and ft.is_time():
            return Datum.time(MyTime(v, max(ft.decimal, 0))), pos
        return Datum.u64(v), pos
    if flag == VARINT_FLAG:
        v, pos = number.decode_varint(b, pos)
        return Datum.i64(v), pos
    if flag == VARUINT_FLAG:
        v, pos = number.decode_uvarint(b, pos)
        if ft is not None and ft.is_time():
            return Datum.time(MyTime(v, max(ft.decimal, 0))), pos
        return Datum.u64(v), pos
    if flag == FLOAT_FLAG:
        v, pos = number.decode_float_cmp(b, pos)
        return Datum.f64(v), pos
    if flag == BYTES_FLAG:
        v, pos = number.decode_bytes_cmp(b, pos)
        return _bytes_datum(v, ft), pos
    if flag == COMPACT_BYTES_FLAG:
        v, pos = number.decode_compact_bytes(b, pos)
        return _bytes_datum(v, ft), pos
    if flag == DECIMAL_FLAG:
        v, pos = decode_decimal(b, pos)
        return Datum.dec(v), pos
    if flag == DURATION_FLAG:
        v, pos = number.decode_int_cmp(b, pos)
        return Datum.duration(v), pos
    if flag == MAX_FLAG:
        return Datum(DatumKind.MaxValue), pos
    raise ValueError(f"invalid encoded datum flag {flag}")


def _bytes_datum(v: bytes, ft: FieldType | None) -> Datum:
    if ft is not None and ft.is_string() and ft.charset != "binary":
        return Datum.string(v.decode("utf-8", "surrogateescape"))
    return Datum.bytes_(v)


def decode_datums(b: bytes, fts: list[FieldType] | None = None) -> list[Datum]:
    out, pos, i = [], 0, 0
    while pos < len(b):
        ft = fts[i] if fts and i < len(fts) else None
        d, pos = decode_datum(b, pos, ft)
        out.append(d)
        i += 1
    return out
