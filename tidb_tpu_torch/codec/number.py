"""Low-level number/bytes codecs (ref: pkg/util/codec/{number,bytes,float}.go).

Two families:
  - *comparable* encodings (big-endian, sign-flipped) used in keys, where
    lexicographic byte order must equal value order;
  - *compact* little-endian / varint encodings used inside row values.

Copy of `tidb_tpu/codec/number.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import struct

SIGN_MASK = 0x8000000000000000
U64 = (1 << 64) - 1


# ---- comparable (key) encodings -------------------------------------------

def encode_int_cmp(v: int) -> bytes:
    """int64 -> 8 bytes, order-preserving (ref: number.go EncodeIntToCmpUint)."""
    return struct.pack(">Q", (v & U64) ^ SIGN_MASK)


def decode_int_cmp(b: bytes, pos: int = 0) -> tuple[int, int]:
    u = struct.unpack_from(">Q", b, pos)[0] ^ SIGN_MASK
    return (u - (1 << 64)) if u & SIGN_MASK else u, pos + 8


def encode_uint_cmp(v: int) -> bytes:
    return struct.pack(">Q", v & U64)


def decode_uint_cmp(b: bytes, pos: int = 0) -> tuple[int, int]:
    return struct.unpack_from(">Q", b, pos)[0], pos + 8


def encode_float_cmp(v: float) -> bytes:
    """(ref: float.go encodeFloatToCmpUint64)."""
    u = struct.unpack(">Q", struct.pack(">d", v))[0]
    if u & SIGN_MASK:
        u = (~u) & U64
    else:
        u |= SIGN_MASK
    return struct.pack(">Q", u)


def decode_float_cmp(b: bytes, pos: int = 0) -> tuple[float, int]:
    u = struct.unpack_from(">Q", b, pos)[0]
    if u & SIGN_MASK:
        u &= ~SIGN_MASK & U64
    else:
        u = (~u) & U64
    return struct.unpack(">d", struct.pack(">Q", u))[0], pos + 8


ENC_GROUP_SIZE = 8
ENC_MARKER = 0xFF
ENC_PAD = 0x00


def encode_bytes_cmp(data: bytes) -> bytes:
    """Memcomparable bytes: 8-byte groups + pad-count marker
    (ref: bytes.go EncodeBytes)."""
    out = bytearray()
    for i in range(0, len(data) + 1, ENC_GROUP_SIZE):
        group = data[i : i + ENC_GROUP_SIZE]
        pad = ENC_GROUP_SIZE - len(group)
        out += group + bytes([ENC_PAD]) * pad
        out.append(ENC_MARKER - pad)
    return bytes(out)


def decode_bytes_cmp(b: bytes, pos: int = 0) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        group = b[pos : pos + ENC_GROUP_SIZE]
        marker = b[pos + ENC_GROUP_SIZE]
        pos += ENC_GROUP_SIZE + 1
        pad = ENC_MARKER - marker
        if pad == 0:
            out += group
        else:
            out += group[: ENC_GROUP_SIZE - pad]
            break
    return bytes(out), pos


# ---- compact (value) encodings --------------------------------------------

def encode_varint(v: int) -> bytes:
    """Zigzag varint (ref: binary.PutVarint)."""
    u = ((v << 1) ^ (v >> 63)) & U64  # python >> is arithmetic for negatives
    return encode_uvarint(u)


def decode_varint(b: bytes, pos: int = 0) -> tuple[int, int]:
    u, pos = decode_uvarint(b, pos)
    v = u >> 1
    if u & 1:
        v = ~v
    return v, pos


def encode_uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_uvarint(b: bytes, pos: int = 0) -> tuple[int, int]:
    v = shift = 0
    while True:
        x = b[pos]
        pos += 1
        v |= (x & 0x7F) << shift
        if x < 0x80:
            return v, pos
        shift += 7


def encode_compact_bytes(data: bytes) -> bytes:
    """(ref: bytes.go EncodeCompactBytes: varint length + raw)."""
    return encode_varint(len(data)) + data


def decode_compact_bytes(b: bytes, pos: int = 0) -> tuple[bytes, int]:
    n, pos = decode_varint(b, pos)
    return b[pos : pos + n], pos + n


def encode_int_value(v: int) -> bytes:
    """Variable-width little-endian int used inside rowcodec values
    (ref: rowcodec/common.go encodeInt)."""
    if -(1 << 7) <= v < (1 << 7):
        return struct.pack("<b", v)
    if -(1 << 15) <= v < (1 << 15):
        return struct.pack("<h", v)
    if -(1 << 31) <= v < (1 << 31):
        return struct.pack("<i", v)
    return struct.pack("<q", v)


def decode_int_value(b: bytes) -> int:
    n = len(b)
    if n == 1:
        return struct.unpack("<b", b)[0]
    if n == 2:
        return struct.unpack("<h", b)[0]
    if n == 4:
        return struct.unpack("<i", b)[0]
    return struct.unpack("<q", b)[0]


def encode_uint_value(v: int) -> bytes:
    if v < (1 << 8):
        return struct.pack("<B", v)
    if v < (1 << 16):
        return struct.pack("<H", v)
    if v < (1 << 32):
        return struct.pack("<I", v)
    return struct.pack("<Q", v)


def decode_uint_value(b: bytes) -> int:
    n = len(b)
    if n == 1:
        return b[0]
    if n == 2:
        return struct.unpack("<H", b)[0]
    if n == 4:
        return struct.unpack("<I", b)[0]
    return struct.unpack("<Q", b)[0]
