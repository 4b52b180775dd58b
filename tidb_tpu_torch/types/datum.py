"""Host-side dynamic value (ref: pkg/types/datum.go `Datum`).

Used at the edges only — codec round-trips, constant folding, final result
rendering, the row-at-a-time parity evaluator. The hot path never touches
Datums; it runs on columnar device arrays.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, ClassVar

from .mydecimal import MyDecimal
from .mytime import MyTime


class DatumKind(enum.IntEnum):
    """(ref: pkg/types/datum.go:48-70 Kind* constants)."""

    Null = 0
    Int64 = 1
    Uint64 = 2
    Float32 = 3
    Float64 = 4
    String = 5
    Bytes = 6
    BinaryLiteral = 7
    MysqlDecimal = 8
    MysqlDuration = 9
    MysqlEnum = 10
    MysqlBit = 11
    MysqlSet = 12
    MysqlTime = 13
    Interface = 14
    MinNotNull = 15
    MaxValue = 16
    Raw = 17
    MysqlJSON = 18


class EnumVal:
    """ENUM value: 1-based member number + resolved name (ref:
    pkg/types/enum.go). Compares and stores by number; renders as name."""

    __slots__ = ("number", "name")

    def __init__(self, number: int, name: str):
        self.number = int(number)
        self.name = name

    def __int__(self):
        return self.number

    __index__ = __int__

    def __str__(self):
        return self.name

    def __eq__(self, other):
        return isinstance(other, EnumVal) and other.number == self.number

    def __hash__(self):
        return hash(("enum", self.number))

    def __repr__(self):
        return f"EnumVal({self.number}, {self.name!r})"


class SetVal:
    """SET value: member bitmask + resolved names (ref: pkg/types/set.go)."""

    __slots__ = ("number", "names")

    def __init__(self, number: int, names: tuple):
        self.number = int(number)
        self.names = tuple(names)

    def __int__(self):
        return self.number

    __index__ = __int__

    def __str__(self):
        return ",".join(self.names)

    def __eq__(self, other):
        return isinstance(other, SetVal) and other.number == self.number

    def __hash__(self):
        return hash(("set", self.number))

    def __repr__(self):
        return f"SetVal({self.number}, {self.names!r})"


@dataclass(frozen=True)
class Datum:
    kind: DatumKind
    val: Any = None

    NULL: ClassVar["Datum"]  # set below

    @classmethod
    def i64(cls, v: int) -> "Datum":
        # int subclasses pass through intact (bools still normalize): the
        # plan cache's slot-tagged literals ride Datums through lowering
        return cls(DatumKind.Int64,
                   v if (isinstance(v, int) and not isinstance(v, bool)) else int(v))

    @classmethod
    def u64(cls, v: int) -> "Datum":
        return cls(DatumKind.Uint64, int(v))

    @classmethod
    def f64(cls, v: float) -> "Datum":
        return cls(DatumKind.Float64, float(v))

    @classmethod
    def string(cls, v: str) -> "Datum":
        return cls(DatumKind.String, v)

    @classmethod
    def bytes_(cls, v: bytes) -> "Datum":
        return cls(DatumKind.Bytes, v)

    @classmethod
    def dec(cls, v, scale: int | None = None) -> "Datum":
        return cls(DatumKind.MysqlDecimal, v if isinstance(v, MyDecimal) else MyDecimal(v, scale))

    @classmethod
    def time(cls, v: MyTime) -> "Datum":
        return cls(DatumKind.MysqlTime, v)

    @classmethod
    def json(cls, binary: bytes) -> "Datum":
        """JSON datum over the BINARY encoding (types/json_binary.py) —
        the canonical in-engine representation, decoded lazily."""
        return cls(DatumKind.MysqlJSON, bytes(binary))

    @classmethod
    def enum(cls, number: int, name: str) -> "Datum":
        return cls(DatumKind.MysqlEnum, EnumVal(number, name))

    @classmethod
    def set_val(cls, number: int, names: tuple) -> "Datum":
        return cls(DatumKind.MysqlSet, SetVal(number, names))

    @classmethod
    def enum_from(cls, elems: tuple, number: int) -> "Datum":
        """Member number -> ENUM datum (name resolved; THE one place the
        out-of-range rule lives)."""
        name = elems[number - 1] if 0 < number <= len(elems) else ""
        return cls(DatumKind.MysqlEnum, EnumVal(number, name))

    @classmethod
    def set_from(cls, elems: tuple, mask: int) -> "Datum":
        names = tuple(e for i, e in enumerate(elems) if mask >> i & 1)
        return cls(DatumKind.MysqlSet, SetVal(mask, names))

    @classmethod
    def duration(cls, nanos: int) -> "Datum":
        # fsp (fractional rendering width) lives on the FieldType, not the value
        return cls(DatumKind.MysqlDuration, int(nanos))

    def is_null(self) -> bool:
        return self.kind == DatumKind.Null

    def __repr__(self):
        if self.kind == DatumKind.Null:
            return "NULL"
        return f"{self.kind.name}({self.val!r})"


Datum.NULL = Datum(DatumKind.Null)
