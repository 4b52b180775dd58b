"""A vectorized encoder of TiDB's row format v2, for bulk loads.

It writes, for whole columns at once, the bytes that the port's
`codec.RowEncoder` writes one row at a time (layout: TiDB
pkg/util/rowcodec/row.go; value encodings: rowcodec/encoder.go
encodeValueDatum). It covers the small row form (column ids below 256,
values below 64 KiB) with every column NOT NULL, which is what the
benchmark's tables need; `encode_table` refuses anything else.

Column values come as numpy arrays in the forms the generators make:
    int      int64
    decimal  int64, the value times 10**frac (the column's scale)
    date     int64 days since 1970-01-01
    string   Text: a (rows, width) uint8 matrix and the length of each row

The set-up holds a seeded sample of rows against RowEncoder byte for byte
before anything is loaded (`harness.deploy.check_encoder`).
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

CODEC_VER = 128
DIG2BYTES = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 4], np.int64)
_DECIMAL = re.compile(r"DECIMAL\((\d+),\s*(\d+)\)")
_STRING = re.compile(r"(CHAR|VARCHAR)\((\d+)\)")


@dataclass
class Text:
    """Strings as a padded byte matrix and the length of each row."""

    mat: np.ndarray  # (rows, width) uint8
    lens: np.ndarray  # (rows,) int64

    def __len__(self) -> int:
        return len(self.lens)

    def take(self, idx) -> "Text":
        return Text(self.mat[idx], self.lens[idx])

    def get(self, i: int) -> str:
        return bytes(self.mat[i, : self.lens[i]]).decode()


def kind_of(sql_type: str) -> tuple[str, int]:
    """(kind, frac or width) of a column's declared SQL type."""
    t = sql_type.upper()
    if t in ("BIGINT", "INT", "INTEGER"):
        return "int", 0
    if t == "DATE":
        return "date", 0
    m = _DECIMAL.fullmatch(t)
    if m:
        return "decimal", int(m.group(2))
    m = _STRING.fullmatch(t)
    if m:
        return "string", int(m.group(2))
    raise ValueError(f"no encoder for the column type {sql_type!r}")


def packed_date(days: np.ndarray) -> np.ndarray:
    """MySQL's packed DATE (uint64) of days since 1970-01-01."""
    d = np.asarray(days, "datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return (((y * 13 + m) << 5) | day).astype(np.uint64) << np.uint64(41)


def _le_bytes(v: np.ndarray, signed: bool) -> tuple[np.ndarray, np.ndarray]:
    """Compact little-endian ints: 1, 2, 4 or 8 bytes by the value's range
    (rowcodec/common.go encodeInt / encodeUint). Returns the 8 bytes of
    each value and the mask of those written."""
    if signed:
        v = np.asarray(v, np.int64)
        w = np.where((v >= -(1 << 7)) & (v < 1 << 7), 1,
                     np.where((v >= -(1 << 15)) & (v < 1 << 15), 2,
                              np.where((v >= -(1 << 31)) & (v < 1 << 31), 4, 8)))
        mat = v.astype("<i8").view(np.uint8).reshape(-1, 8)
    else:
        v = np.asarray(v, np.uint64)
        w = np.where(v < 1 << 8, 1, np.where(v < 1 << 16, 2, np.where(v < np.uint64(1 << 32), 4, 8)))
        mat = v.astype("<u8").view(np.uint8).reshape(-1, 8)
    return mat, np.arange(8)[None, :] < w[:, None]


def _ndigits(a: np.ndarray) -> np.ndarray:
    """Decimal digits of non-negative int64 values (0 has 1)."""
    n = np.ones(len(a), np.int64)
    p = 10
    for _ in range(18):
        n += a >= p
        p *= 10
    return n


def _be4(v: np.ndarray) -> np.ndarray:
    """Each value below 2**32 as 4 big-endian bytes."""
    return np.asarray(v, np.int64).astype(">u4").view(np.uint8).reshape(-1, 4)


def _decimal_bytes(scaled: np.ndarray, frac: int) -> tuple[np.ndarray, np.ndarray]:
    """EncodeDecimal of each value with the precision RowEncoder gives it:
    [prec][frac] + the binary form (pkg/types/mydecimal.go WriteBin), prec
    being the value's own digit count, at least frac + 1. The integer part
    is a leading word of (int digits mod 9) digits and up to two words of 9;
    the fraction one word of `frac` digits. Each word is laid out in 4
    big-endian slots of which the mask keeps its last DIG2BYTES bytes."""
    s = np.asarray(scaled, np.int64)
    if frac > 9:
        raise ValueError("decimal outside the encoder's range")
    neg = s < 0
    a = np.abs(s)
    prec = np.maximum(_ndigits(a), frac + 1)
    int_digits = prec - frac
    ipart, fpart = a // 10 ** frac, a % 10 ** frac
    full = int_digits // 9
    if int(full.max(initial=0)) > 2:
        raise ValueError("decimal outside the encoder's range")
    e9 = 10 ** 9
    lead_val = ipart // np.where(full >= 1, e9, 1) // np.where(full >= 2, e9, 1)
    words = [
        (lead_val, DIG2BYTES[int_digits % 9]),
        (np.where(full == 2, (ipart // e9) % e9, ipart % e9), 4 * (full >= 1)),
        (ipart % e9, 4 * (full >= 2)),
        (fpart, np.full(len(s), DIG2BYTES[frac % 9] + 4 * (frac // 9))),
    ]
    n = len(s)
    mat = np.empty((n, 18), np.uint8)
    mask = np.ones((n, 18), bool)
    mat[:, 0] = prec
    mat[:, 1] = frac
    for j, (val, nb) in enumerate(words):
        mat[:, 2 + 4 * j: 6 + 4 * j] = _be4(val)
        mask[:, 2 + 4 * j: 6 + 4 * j] = np.arange(4)[None, :] >= (4 - nb)[:, None]
    # negative values: every body byte inverted; then the sign bit of the
    # first body byte flipped
    mat[:, 2:] ^= np.where(neg, 0xFF, 0).astype(np.uint8)[:, None]
    first = 2 + np.argmax(mask[:, 2:], axis=1)
    mat[np.arange(n), first] ^= 0x80
    return mat, mask


def _column_bytes(kind: str, values) -> tuple[np.ndarray, np.ndarray]:
    if kind == "int":
        return _le_bytes(values, True)
    if kind == "date":
        return _le_bytes(packed_date(values), False)
    if kind == "decimal":
        return _decimal_bytes(values[0], values[1])
    if kind == "string":
        return values.mat, np.arange(values.mat.shape[1])[None, :] < values.lens[:, None]
    raise ValueError(kind)


def column_bytes(kind: str, values) -> tuple[np.ndarray, np.ndarray]:
    """(bytes matrix, mask of the bytes written) of one column's values. A
    numeric column whose values span fewer than 2**16 is encoded once per
    value in its range and looked up."""
    if kind != "string":
        v = values[0] if kind == "decimal" else values
        v = np.asarray(v, np.int64)
        if len(v) > 1 << 16:
            lo, hi = int(v.min()), int(v.max())
            if hi - lo < 1 << 16:
                span = np.arange(lo, hi + 1, dtype=np.int64)
                mat, mask = _column_bytes(kind, (span, values[1]) if kind == "decimal" else span)
                i = v - lo
                return mat[i], mask[i]
    return _column_bytes(kind, values)


def _take(kind: str, values, lo: int, hi: int):
    if kind == "decimal":
        return values[0][lo:hi], values[1]
    if kind == "string":
        return Text(values.mat[lo:hi], values.lens[lo:hi])
    return values[lo:hi]


BLOCK_ROWS = 1 << 17


def encode_table(kinds: list, columns: list, col_ids: list, workers: int = 4) -> tuple[bytes, np.ndarray]:
    """Row values of a table whose columns are all NOT NULL.

    kinds[i] is "int", "date", "decimal" or "string"; columns[i] is its
    array (a decimal's is (scaled int64, frac)); col_ids ascend. Returns
    the rows' bytes back to back and the (rows + 1) offsets between them.
    Each block of rows is laid out as one byte matrix (header, value
    end-offsets, then each column's slots) whose mask keeps the bytes
    written: the masked bytes in row-major order are the rows. Blocks
    run on `workers` threads (numpy releases the GIL)."""
    n_cols = len(col_ids)
    if list(col_ids) != sorted(col_ids) or max(col_ids) > 255:
        raise ValueError("column ids must ascend and stay below 256 (the small row form)")
    n = len(columns[0][0]) if kinds[0] == "decimal" else len(columns[0])
    fixed = np.array([CODEC_VER, 0, n_cols & 0xFF, n_cols >> 8, 0, 0] + list(col_ids), np.uint8)

    def block(lo: int):
        hi = min(lo + BLOCK_ROWS, n)
        parts = [column_bytes(k, _take(k, c, lo, hi)) for k, c in zip(kinds, columns)]
        ends = np.cumsum(np.stack([m.sum(axis=1) for _v, m in parts], axis=1), axis=1)
        if int(ends[:, -1].max(initial=0)) > 0xFFFF:
            raise ValueError("a row's values pass 64 KiB (the large row form)")
        mats = [np.broadcast_to(fixed, (hi - lo, len(fixed))),
                ends.astype("<u2").view(np.uint8).reshape(hi - lo, 2 * n_cols)] + [v for v, _m in parts]
        masks = [np.ones((hi - lo, len(fixed) + 2 * n_cols), bool)] + [m for _v, m in parts]
        return np.concatenate(mats, axis=1)[np.concatenate(masks, axis=1)], len(fixed) + 2 * n_cols + ends[:, -1]

    with ThreadPoolExecutor(max_workers=workers) as pool:
        done = list(pool.map(block, range(0, n, BLOCK_ROWS)))
    blobs, lens = [b for b, _l in done], [ln for _b, ln in done]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.concatenate(lens), out=offs[1:])
    return np.concatenate(blobs).tobytes(), offs


def row_keys(table_id: int, handles: np.ndarray) -> tuple[bytes, int]:
    """Record keys t{table_id}_r{handle} back to back (19 bytes each,
    tablecodec.EncodeRowKeyWithHandle: comparable int64s)."""
    sign = np.uint64(1 << 63)
    tid = np.array([np.uint64(table_id) ^ sign], ">u8").tobytes()
    prefix = np.frombuffer(b"t" + tid + b"_r", np.uint8)
    h = (np.asarray(handles, np.int64).astype(np.uint64) ^ sign).astype(">u8").view(np.uint8).reshape(-1, 8)
    out = np.empty((len(h), 19), np.uint8)
    out[:, :11] = prefix
    out[:, 11:] = h
    return out.tobytes(), 19


def items(keys: tuple[bytes, int], values: tuple[bytes, np.ndarray]) -> list:
    """(key, value) pairs as bytes objects, for TPUStore.bulk_ingest."""
    kb, kw = keys
    vb, offs = values
    o = offs.tolist()
    return [(kb[i * kw:(i + 1) * kw], vb[o[i]:o[i + 1]]) for i in range(len(o) - 1)]
