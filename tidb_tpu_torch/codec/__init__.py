"""Copy of `tidb_tpu/codec/__init__.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu)."""

from . import number, datum_codec, rowcodec, tablecodec
from .rowcodec import RowEncoder, decode_row_to_datum_map
from .tablecodec import encode_row_key, decode_row_key, encode_index_key, record_prefix

__all__ = [
    "number",
    "datum_codec",
    "rowcodec",
    "tablecodec",
    "RowEncoder",
    "decode_row_to_datum_map",
    "encode_row_key",
    "decode_row_key",
    "encode_index_key",
    "record_prefix",
]
