"""What the reference's templates share: exact decimals from scaled
integers, their float and int32 counterparts for the controls, and
text and date helpers over the generated columns."""

from __future__ import annotations

from decimal import Decimal

import numpy as np

FLOATS = {"float64": np.float64, "float32": np.float32}


def dec(scaled: int, scale: int) -> Decimal:
    """The exact decimal of an integer at `scale` digits."""
    return Decimal(int(scaled)).scaleb(-scale)


def day(s: str) -> int:
    """A 'YYYY-MM-DD' literal as days since 1970-01-01."""
    return int(np.datetime64(s, "D").astype(np.int64))


def iso(days: int) -> str:
    return str(np.datetime64(int(days), "D"))


def text_is(t, s: str) -> np.ndarray:
    """Rows of a Text column equal to s."""
    b = np.frombuffer(s.encode(), np.uint8)
    if t.mat.shape[1] < len(b):
        return np.zeros(len(t), bool)
    return (t.lens == len(b)) & (t.mat[:, : len(b)] == b[None, :]).all(axis=1)


def as_float(values, scale: int, precision: str) -> np.ndarray:
    """Decimal columns (value / 10**scale) in the control's float type."""
    f = FLOATS[precision]
    return np.asarray(values, f) / f(10.0 ** scale)


def float_sum(values: np.ndarray, out_scale: int) -> Decimal:
    """A sum taken in the values' own float type, rounded to the result's
    scale: the control's arithmetic."""
    total = float(np.sum(values, dtype=values.dtype))
    return Decimal(repr(total)).quantize(Decimal(1).scaleb(-out_scale))


def float_avg(values: np.ndarray, out_scale: int) -> Decimal:
    """A mean taken in the values' own float type, rounded to the result's scale."""
    mean = float(np.mean(values, dtype=values.dtype))
    return Decimal(repr(mean)).quantize(Decimal(1).scaleb(-out_scale))


def int32_sum(values: np.ndarray) -> int:
    """A sum accumulated in 32-bit integers (wrapping): the control's."""
    return int(np.sum(np.asarray(values, np.int64).astype(np.int32), dtype=np.int32))
