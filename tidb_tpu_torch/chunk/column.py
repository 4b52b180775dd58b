"""Host columnar column (ref: pkg/util/chunk/column.go:73).

The reference Column is Arrow-flavored: nullBitmap + offsets + data + elemBuf.
Here the host form is numpy-native:

  - fixed-width types: `data` is a numpy array (int64/uint64/float64/float32),
    one slot per row; NULL rows hold a zero value and are flagged in `null`.
  - varlen types (strings/bytes/json): `offsets` (int64, n+1) into a `blob`
    uint8 buffer — same layout the reference uses, which also makes the
    chunk wire codec (codec.py) a couple of memcpys.

Decimals are held as *scaled int64* (value * 10^ft.decimal) — the device
representation — with the scale carried by the FieldType. MyDecimal objects
appear only at the edges (types/mydecimal.py).
"""

from __future__ import annotations

import numpy as np

from ..types import FieldType, TypeCode, Datum, DatumKind, MyDecimal, MyTime


def numpy_dtype_for(ft: FieldType):
    if ft.is_int():
        return np.uint64 if ft.is_unsigned() else np.int64
    if ft.tp == TypeCode.Float:
        return np.float32
    if ft.tp == TypeCode.Double:
        return np.float64
    if ft.is_decimal():
        return np.int64  # scaled by 10^ft.decimal
    if ft.is_time():
        return np.uint64  # packed datetime (mytime.py)
    if ft.is_duration():
        return np.int64  # nanoseconds
    if ft.tp in (TypeCode.Enum, TypeCode.Set, TypeCode.Bit):
        return np.uint64
    return None  # varlen


class Column:
    __slots__ = ("ft", "data", "null", "offsets", "blob")

    def __init__(self, ft: FieldType, data=None, null=None, offsets=None, blob=None):
        self.ft = ft
        self.data = data
        self.null = null
        self.offsets = offsets
        self.blob = blob

    # ---- construction -----------------------------------------------------
    @classmethod
    def empty(cls, ft: FieldType) -> "Column":
        dt = numpy_dtype_for(ft)
        if dt is None:
            return cls(ft, None, np.zeros(0, bool), np.zeros(1, np.int64), np.zeros(0, np.uint8))
        return cls(ft, np.zeros(0, dt), np.zeros(0, bool))

    @classmethod
    def from_numpy(cls, ft: FieldType, data: np.ndarray, null: np.ndarray | None = None) -> "Column":
        if null is None:
            null = np.zeros(len(data), bool)
        return cls(ft, data, null)

    @classmethod
    def from_datums(cls, ft: FieldType, datums: list[Datum]) -> "Column":
        n = len(datums)
        null = np.array([d.is_null() for d in datums], bool)
        dt = numpy_dtype_for(ft)
        if dt is None:
            parts, offs = [], np.zeros(n + 1, np.int64)
            for i, d in enumerate(datums):
                b = b""
                if not d.is_null():
                    b = d.val.encode() if isinstance(d.val, str) else bytes(d.val)
                parts.append(b)
                offs[i + 1] = offs[i] + len(b)
            blob = np.frombuffer(b"".join(parts), np.uint8).copy() if offs[-1] else np.zeros(0, np.uint8)
            return cls(ft, None, null, offs, blob)
        vals = np.zeros(n, dt)
        for i, d in enumerate(datums):
            if d.is_null():
                continue
            if ft.is_decimal():
                dec = d.val if isinstance(d.val, MyDecimal) else MyDecimal(d.val)
                vals[i] = dec.to_scaled_int(max(ft.decimal, 0))
            elif ft.is_time():
                vals[i] = d.val.packed if isinstance(d.val, MyTime) else int(d.val)
            else:
                vals[i] = d.val
        return cls(ft, vals, null)

    # ---- access ------------------------------------------------------------
    def __len__(self) -> int:
        if self.data is not None:
            return len(self.data)
        return len(self.offsets) - 1

    def is_varlen(self) -> bool:
        return self.data is None

    def get_bytes(self, i: int) -> bytes:
        return self.blob[self.offsets[i]: self.offsets[i + 1]].tobytes()

    def get_datum(self, i: int) -> Datum:
        if self.null[i]:
            return Datum.NULL
        ft = self.ft
        if self.is_varlen():
            b = self.get_bytes(i)
            if ft.tp == TypeCode.JSON:
                return Datum(DatumKind.MysqlJSON, b)
            if ft.charset == "binary":
                return Datum.bytes_(b)
            return Datum.string(b.decode("utf-8", "surrogateescape"))
        v = self.data[i]
        if ft.is_int():
            return Datum.u64(int(v)) if ft.is_unsigned() else Datum.i64(int(v))
        if ft.is_float():
            return Datum.f64(float(v)) if ft.tp == TypeCode.Double else Datum(DatumKind.Float32, float(v))
        if ft.is_decimal():
            return Datum.dec(MyDecimal.from_scaled_int(int(v), max(ft.decimal, 0)))
        if ft.is_time():
            return Datum.time(MyTime(int(v), max(ft.decimal, 0)))
        if ft.is_duration():
            return Datum.duration(int(v))
        if ft.tp == TypeCode.Enum:
            return Datum.enum_from(ft.elems, int(v))
        if ft.tp == TypeCode.Set:
            return Datum.set_from(ft.elems, int(v))
        return Datum.u64(int(v))

    def take(self, idx: np.ndarray) -> "Column":
        null = self.null[idx]
        if not self.is_varlen():
            return Column(self.ft, self.data[idx], null)
        lens = (self.offsets[1:] - self.offsets[:-1])[idx]
        offs = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        blob = np.zeros(int(offs[-1]), np.uint8)
        for j, i in enumerate(idx):
            blob[offs[j]: offs[j + 1]] = self.blob[self.offsets[i]: self.offsets[i + 1]]
        return Column(self.ft, None, null, offs, blob)

    @classmethod
    def concat(cls, cols: list["Column"]) -> "Column":
        ft = cols[0].ft
        null = np.concatenate([c.null for c in cols])
        if not cols[0].is_varlen():
            return cls(ft, np.concatenate([c.data for c in cols]), null)
        blobs = [c.blob for c in cols]
        sizes = np.array([0] + [len(c.blob) for c in cols], np.int64).cumsum()
        offs_parts = [cols[0].offsets]
        for k, c in enumerate(cols[1:], 1):
            offs_parts.append(c.offsets[1:] + sizes[k])
        return cls(ft, None, null, np.concatenate(offs_parts), np.concatenate(blobs) if blobs else np.zeros(0, np.uint8))
