"""Table key layout (ref: pkg/tablecodec/tablecodec.go:50-51,103).

    record key: t{tableID}_r{handle}   -> 't' + cmp-int64 + "_r" + cmp-int64
    index  key: t{tableID}_i{indexID}{encoded index datums}

tableID/handle/indexID use the comparable int64 encoding without a flag byte,
so keys sort by (tableID, handle).

Copy of `tidb_tpu/codec/tablecodec.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from ..types import Datum
from .datum_codec import encode_datums
from .number import decode_int_cmp, encode_int_cmp

TABLE_PREFIX = b"t"
RECORD_SEP = b"_r"
INDEX_SEP = b"_i"
RECORD_ROW_KEY_LEN = 1 + 8 + 2 + 8


def record_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + encode_int_cmp(table_id) + RECORD_SEP


def table_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + encode_int_cmp(table_id)


def encode_row_key(table_id: int, handle: int) -> bytes:
    return record_prefix(table_id) + encode_int_cmp(handle)


def decode_row_key(key: bytes) -> tuple[int, int]:
    if len(key) < RECORD_ROW_KEY_LEN or key[:1] != TABLE_PREFIX or key[9:11] != RECORD_SEP:
        raise ValueError(f"not a record key: {key!r}")
    tid, _ = decode_int_cmp(key, 1)
    handle, _ = decode_int_cmp(key, 11)
    return tid, handle


def encode_index_key(table_id: int, index_id: int, values: list[Datum]) -> bytes:
    return (
        TABLE_PREFIX
        + encode_int_cmp(table_id)
        + INDEX_SEP
        + encode_int_cmp(index_id)
        + encode_datums(values, comparable=True)
    )


def decode_key_table_id(key: bytes) -> int:
    tid, _ = decode_int_cmp(key, 1)
    return tid
