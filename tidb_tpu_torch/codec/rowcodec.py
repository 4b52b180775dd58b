"""Row format v2 (ref: pkg/util/rowcodec/row.go:36-70 layout diagram).

    [VER=128][FLAGS][NOT_NULL_CNT u16][NULL_CNT u16]
    [not-null col ids][null col ids][not-null value end-offsets][values]

small row: ids u8, offsets u16; large row (max col id > 255 or data > 64KiB):
ids u32, offsets u32. Ids sorted ascending within each group. Value encodings
per rowcodec/encoder.go encodeValueDatum: compact LE ints/uints, comparable
float64, raw bytes for strings, packed uint for times, EncodeDecimal for
decimals, int64 nanos for durations.

Copy of `tidb_tpu/codec/rowcodec.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import struct

from ..types import Datum, DatumKind, FieldType, MyDecimal, MyTime, TypeCode
from . import number
from .decimal_bin import decode_decimal, encode_decimal

CODEC_VER = 128
FLAG_LARGE = 1


class RowEncoder:
    """Encode (col_id -> Datum) into row format v2."""

    def encode(self, col_ids: list[int], datums: list[Datum]) -> bytes:
        pairs = sorted(zip(col_ids, datums), key=lambda p: p[0])
        notnull = [(cid, d) for cid, d in pairs if not d.is_null()]
        null_ids = [cid for cid, d in pairs if d.is_null()]
        values = [encode_row_value(d) for _, d in notnull]
        data = b"".join(values)
        large = (max(col_ids) if col_ids else 0) > 255 or len(data) > 0xFFFF
        flags = FLAG_LARGE if large else 0
        out = bytearray([CODEC_VER, flags])
        out += struct.pack("<HH", len(notnull), len(null_ids))
        id_fmt, off_fmt = ("<I", "<I") if large else ("<B", "<H")
        for cid, _ in notnull:
            out += struct.pack(id_fmt, cid)
        for cid in null_ids:
            out += struct.pack(id_fmt, cid)
        off = 0
        for v in values:
            off += len(v)
            out += struct.pack(off_fmt, off)
        out += data
        return bytes(out)


def encode_row_value(d: Datum) -> bytes:
    """(ref: rowcodec/encoder.go:173 encodeValueDatum)."""
    k = d.kind
    if k == DatumKind.Int64:
        return number.encode_int_value(d.val)
    if k in (DatumKind.Uint64, DatumKind.MysqlEnum, DatumKind.MysqlSet, DatumKind.MysqlBit):
        return number.encode_uint_value(int(d.val))
    if k in (DatumKind.String, DatumKind.Bytes):
        return d.val.encode() if isinstance(d.val, str) else bytes(d.val)
    if k == DatumKind.MysqlTime:
        packed = d.val.packed if isinstance(d.val, MyTime) else int(d.val)
        return number.encode_uint_value(packed)
    if k == DatumKind.MysqlDuration:
        return number.encode_int_value(d.val)
    if k in (DatumKind.Float32, DatumKind.Float64):
        return number.encode_float_cmp(float(d.val))
    if k == DatumKind.MysqlDecimal:
        return encode_decimal(d.val)
    if k == DatumKind.MysqlJSON:
        return bytes(d.val)
    raise ValueError(f"unsupported row value kind {k}")


def decode_row_value(b: bytes, ft: FieldType) -> Datum:
    """Inverse of encode_row_value, driven by the column's FieldType
    (ref: rowcodec/decoder.go decodeColData)."""
    if ft.is_int():
        if ft.is_unsigned():
            return Datum.u64(number.decode_uint_value(b))
        return Datum.i64(number.decode_int_value(b))
    if ft.is_float():
        v, _ = number.decode_float_cmp(b)
        return Datum.f64(v) if ft.tp.name == "Double" else Datum(DatumKind.Float32, v)
    if ft.is_string():
        if ft.charset == "binary":
            return Datum.bytes_(bytes(b))
        return Datum.string(bytes(b).decode("utf-8", "surrogateescape"))
    if ft.is_decimal():
        v, _ = decode_decimal(b)
        return Datum.dec(v)
    if ft.is_time():
        return Datum.time(MyTime(number.decode_uint_value(b), max(ft.decimal, 0)))
    if ft.is_duration():
        return Datum.duration(number.decode_int_value(b))
    if ft.tp == TypeCode.JSON:
        return Datum.json(bytes(b))
    if ft.tp == TypeCode.Enum:
        return Datum.enum_from(ft.elems, number.decode_uint_value(b))
    if ft.tp == TypeCode.Set:
        return Datum.set_from(ft.elems, number.decode_uint_value(b))
    # Bit lands as uint
    return Datum.u64(number.decode_uint_value(b))


class RowReader:
    """Zero-copy view over an encoded row."""

    __slots__ = ("b", "large", "n_notnull", "n_null", "ids_off", "offs_off", "data_off")

    def __init__(self, b: bytes):
        if b[0] != CODEC_VER:
            raise ValueError(f"invalid rowcodec version {b[0]}")
        self.b = b
        self.large = bool(b[1] & FLAG_LARGE)
        self.n_notnull, self.n_null = struct.unpack_from("<HH", b, 2)
        id_sz = 4 if self.large else 1
        off_sz = 4 if self.large else 2
        self.ids_off = 6
        self.offs_off = self.ids_off + (self.n_notnull + self.n_null) * id_sz
        self.data_off = self.offs_off + self.n_notnull * off_sz

    def _id_at(self, i: int) -> int:
        if self.large:
            return struct.unpack_from("<I", self.b, self.ids_off + 4 * i)[0]
        return self.b[self.ids_off + i]

    def _end_off(self, i: int) -> int:
        if self.large:
            return struct.unpack_from("<I", self.b, self.offs_off + 4 * i)[0]
        return struct.unpack_from("<H", self.b, self.offs_off + 2 * i)[0]

    def value_bytes(self, col_id: int) -> bytes | None:
        """Raw value bytes for col_id; None if the column is NULL or absent.

        Returns b"" only for genuinely empty values (empty string).
        """
        lo, hi = 0, self.n_notnull
        while lo < hi:
            mid = (lo + hi) // 2
            cid = self._id_at(mid)
            if cid < col_id:
                lo = mid + 1
            elif cid > col_id:
                hi = mid
            else:
                start = self._end_off(mid - 1) if mid else 0
                return self.b[self.data_off + start : self.data_off + self._end_off(mid)]
        return None

    def is_null(self, col_id: int) -> bool:
        lo, hi = self.n_notnull, self.n_notnull + self.n_null
        while lo < hi:
            mid = (lo + hi) // 2
            cid = self._id_at(mid)
            if cid < col_id:
                lo = mid + 1
            elif cid > col_id:
                hi = mid
            else:
                return True
        return False


def fill_origin_default(row_bytes: bytes, col_id: int, default, decoded: Datum) -> Datum:
    """Pre-ADD-COLUMN rows carry no bytes for the column: fill the origin
    default unless the row explicitly stored NULL (ref: rowcodec
    ChunkDecoder default fill; shared by the scan and point-read paths)."""
    if default is None or not decoded.is_null():
        return decoded
    if RowReader(row_bytes).is_null(col_id):
        return decoded
    return default


def decode_row_to_datum_map(b: bytes, fts_by_id: dict[int, FieldType]) -> dict[int, Datum]:
    r = RowReader(b)
    out = {}
    for cid, ft in fts_by_id.items():
        vb = r.value_bytes(cid)
        if vb is None:
            out[cid] = Datum.NULL
        else:
            out[cid] = decode_row_value(vb, ft)
    return out
