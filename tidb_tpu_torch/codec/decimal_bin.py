"""MySQL decimal binary (memcomparable) format.

(ref: pkg/types/mydecimal.go WriteBin/FromBin and pkg/util/codec/decimal.go
EncodeDecimal — precision byte + frac byte + packed base-10^9 words with the
sign bit of the first byte flipped, all bytes inverted for negatives, making
the encoding lexicographically ordered.)

Copy of `tidb_tpu/codec/decimal_bin.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from ..types import MyDecimal

DIGITS_PER_WORD = 9
WORD_SIZE = 4
# bytes needed for a partial word of n leading/trailing digits
DIG2BYTES = [0, 1, 1, 2, 2, 3, 3, 4, 4, 4]


def _digits_of(d: MyDecimal, prec: int, frac: int) -> tuple[bool, str, str]:
    neg = d.d < 0
    q = d.round(frac)  # enforce target scale
    s = format(abs(q.d), "f")
    if "." in s:
        int_part, frac_part = s.split(".")
    else:
        int_part, frac_part = s, ""
    frac_part = frac_part.ljust(frac, "0")[:frac]
    int_digits = prec - frac
    int_part = int_part.lstrip("0") or ""
    if len(int_part) > int_digits:
        raise ValueError(f"decimal overflow: {s} does not fit precision {prec},{frac}")
    int_part = int_part.rjust(int_digits, "0")
    return neg, int_part, frac_part


def encode_bin(d: MyDecimal, prec: int, frac: int) -> bytes:
    neg, int_part, frac_part = _digits_of(d, prec, frac)
    int_digits = prec - frac
    leading = int_digits % DIGITS_PER_WORD
    trailing = frac % DIGITS_PER_WORD
    out = bytearray()

    def put_word(digit_str: str, nbytes: int):
        v = int(digit_str) if digit_str else 0
        out.extend(v.to_bytes(nbytes, "big"))

    pos = 0
    if leading:
        put_word(int_part[:leading], DIG2BYTES[leading])
        pos = leading
    while pos < int_digits:
        put_word(int_part[pos : pos + DIGITS_PER_WORD], WORD_SIZE)
        pos += DIGITS_PER_WORD
    pos = 0
    while pos + DIGITS_PER_WORD <= frac:
        put_word(frac_part[pos : pos + DIGITS_PER_WORD], WORD_SIZE)
        pos += DIGITS_PER_WORD
    if trailing:
        put_word(frac_part[pos:], DIG2BYTES[trailing])

    if neg:
        for i in range(len(out)):
            out[i] ^= 0xFF
    out[0] ^= 0x80
    return bytes(out)


def decode_bin(b: bytes, prec: int, frac: int, pos: int = 0) -> tuple[MyDecimal, int]:
    int_digits = prec - frac
    leading = int_digits % DIGITS_PER_WORD
    trailing = frac % DIGITS_PER_WORD
    size = (
        DIG2BYTES[leading]
        + (int_digits // DIGITS_PER_WORD) * WORD_SIZE
        + (frac // DIGITS_PER_WORD) * WORD_SIZE
        + DIG2BYTES[trailing]
    )
    buf = bytearray(b[pos : pos + size])
    neg = not (buf[0] & 0x80)
    buf[0] ^= 0x80
    if neg:
        for i in range(len(buf)):
            buf[i] ^= 0xFF

    digits = []
    cur = 0
    if leading:
        n = DIG2BYTES[leading]
        digits.append(str(int.from_bytes(buf[cur : cur + n], "big")).rjust(leading, "0"))
        cur += n
    for _ in range(int_digits // DIGITS_PER_WORD):
        digits.append(str(int.from_bytes(buf[cur : cur + WORD_SIZE], "big")).rjust(9, "0"))
        cur += WORD_SIZE
    int_str = "".join(digits) or "0"
    digits = []
    for _ in range(frac // DIGITS_PER_WORD):
        digits.append(str(int.from_bytes(buf[cur : cur + WORD_SIZE], "big")).rjust(9, "0"))
        cur += WORD_SIZE
    if trailing:
        n = DIG2BYTES[trailing]
        digits.append(str(int.from_bytes(buf[cur : cur + n], "big")).rjust(trailing, "0"))
        cur += n
    frac_str = "".join(digits)
    s = (("-" if neg else "") + (int_str.lstrip("0") or "0") + ("." + frac_str if frac_str else ""))
    return MyDecimal(s, frac), pos + size


def encode_decimal(d: MyDecimal, prec: int | None = None, frac: int | None = None) -> bytes:
    """(ref: codec/decimal.go EncodeDecimal: [prec][frac][bin])."""
    if prec is None or prec < 0:
        frac = d.scale
        digits = len(format(abs(d.d), "f").replace(".", "").lstrip("0")) or 1
        prec = max(digits, frac + 1)
    return bytes([prec, frac]) + encode_bin(d, prec, frac)


def decode_decimal(b: bytes, pos: int = 0) -> tuple[MyDecimal, int]:
    prec, frac = b[pos], b[pos + 1]
    return decode_bin(b, prec, frac, pos + 2)
