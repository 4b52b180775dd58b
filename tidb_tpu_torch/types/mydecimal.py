"""MySQL DECIMAL semantics on host.

The reference implements a word-based fixed-point decimal
(ref: pkg/types/mydecimal.go — int32 words of 9 digits). We need bit-exact
*semantics* (precision/scale propagation, rounding, division precision
increment), not the word layout, so this wraps python `decimal` with MySQL's
rules:

  - max precision 65, max scale 30 (ref: pkg/types/mydecimal.go:32-38)
  - add/sub result scale  = max(s1, s2)
  - mul result scale      = min(s1 + s2, 30)
  - div result scale      = min(s1 + DivFracIncr, 30), DivFracIncr = 4
    (ref: pkg/expression/builtin_arithmetic.go, `types.DivFracIncr`;
     cophandler applies the same at cop_handler.go:350-354)
  - rounding: half away from zero ("round half up" in MySQL docs)

On device, decimals travel as scaled int64 (value * 10^scale) when the scale
is known and small enough — see chunk/device.py; this class is the host-side
edge (parsing, final merge, result encoding).
"""

from __future__ import annotations

import decimal
from decimal import Decimal

MAX_PRECISION = 65
MAX_SCALE = 30
DIV_FRAC_INCR = 4

_CTX = decimal.Context(prec=MAX_PRECISION + 10, rounding=decimal.ROUND_HALF_UP)


class MyDecimal:
    """Immutable fixed-point decimal with an explicit scale ("frac")."""

    __slots__ = ("d", "scale")

    def __init__(self, value, scale: int | None = None):
        if isinstance(value, MyDecimal):
            d = value.d
            scale = value.scale if scale is None else scale
        elif isinstance(value, Decimal):
            d = value
        elif isinstance(value, float):
            # MySQL converts float via its shortest decimal repr.
            d = Decimal(repr(value))
        else:
            d = Decimal(str(value))
        if scale is None:
            scale = max(0, -d.as_tuple().exponent)
        scale = min(scale, MAX_SCALE)
        self.scale = scale
        self.d = d.quantize(Decimal(1).scaleb(-scale), context=_CTX)

    # ---- arithmetic -------------------------------------------------------
    def __add__(self, other: "MyDecimal") -> "MyDecimal":
        s = max(self.scale, other.scale)
        return MyDecimal(_CTX.add(self.d, other.d), s)

    def __sub__(self, other: "MyDecimal") -> "MyDecimal":
        s = max(self.scale, other.scale)
        return MyDecimal(_CTX.subtract(self.d, other.d), s)

    def __mul__(self, other: "MyDecimal") -> "MyDecimal":
        s = min(self.scale + other.scale, MAX_SCALE)
        return MyDecimal(_CTX.multiply(self.d, other.d), s)

    def div(self, other: "MyDecimal", frac_incr: int = DIV_FRAC_INCR) -> "MyDecimal | None":
        """MySQL division; returns None for division by zero (-> SQL NULL)."""
        if other.d == 0:
            return None
        s = min(self.scale + frac_incr, MAX_SCALE)
        q = _CTX.divide(self.d, other.d)
        return MyDecimal(q, s)

    def __neg__(self) -> "MyDecimal":
        return MyDecimal(-self.d, self.scale)

    # ---- comparison (scale-insensitive, like the reference Compare) -------
    def __eq__(self, other) -> bool:
        return isinstance(other, MyDecimal) and self.d == other.d

    def __lt__(self, other: "MyDecimal") -> bool:
        return self.d < other.d

    def __le__(self, other: "MyDecimal") -> bool:
        return self.d <= other.d

    def __hash__(self):
        return hash(self.d)

    # ---- conversions ------------------------------------------------------
    def round(self, scale: int) -> "MyDecimal":
        return MyDecimal(self.d, scale)

    def to_float(self) -> float:
        return float(self.d)

    def to_int(self) -> int:
        """Round to integer, half away from zero (ref mydecimal ToInt)."""
        return int(self.d.quantize(Decimal(1), context=_CTX))

    def to_scaled_int(self, scale: int | None = None) -> int:
        """value * 10^scale as a python int — the device representation."""
        s = self.scale if scale is None else scale
        return int(self.d.scaleb(s).quantize(Decimal(1), context=_CTX))

    @classmethod
    def from_scaled_int(cls, v: int, scale: int) -> "MyDecimal":
        return cls(Decimal(v).scaleb(-scale), scale)

    def __str__(self) -> str:
        # MySQL prints with exactly `scale` fractional digits.
        return str(self.d)

    def __repr__(self) -> str:
        return f"MyDecimal({self.d}, scale={self.scale})"
