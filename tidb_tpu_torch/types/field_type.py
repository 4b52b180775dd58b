"""MySQL field types, flags and collations.

Reimplements the type metadata the reference carries on every column and
expression (ref: pkg/parser/mysql/type.go, pkg/parser/types/field_type.go).
Only metadata lives here; evaluation semantics live in expr/ and ops/.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TypeCode(enum.IntEnum):
    """MySQL column type codes (ref: pkg/parser/mysql/type.go:17-51)."""

    Decimal = 0
    Tiny = 1
    Short = 2
    Long = 3
    Float = 4
    Double = 5
    Null = 6
    Timestamp = 7
    LongLong = 8
    Int24 = 9
    Date = 10
    Duration = 11
    Datetime = 12
    Year = 13
    NewDate = 14
    Varchar = 15
    Bit = 16
    JSON = 0xF5
    NewDecimal = 0xF6
    Enum = 0xF7
    Set = 0xF8
    TinyBlob = 0xF9
    MediumBlob = 0xFA
    LongBlob = 0xFB
    Blob = 0xFC
    VarString = 0xFD
    String = 0xFE
    Geometry = 0xFF


class Flag(enum.IntFlag):
    """Column flags (ref: pkg/parser/mysql/type.go:56-78)."""

    NotNull = 1
    PriKey = 2
    UniqueKey = 4
    MultipleKey = 8
    Blob = 16
    Unsigned = 32
    Zerofill = 64
    Binary = 128
    Enum = 256
    AutoIncrement = 512
    Timestamp = 1024
    Set = 2048


class Collation(enum.IntEnum):
    """The collation subset the engine understands (ref: pkg/util/collate).

    Negative IDs are what TiDB sends over the wire when new collation is
    enabled (RewriteNewCollationIDIfNeeded); we store positive IDs and handle
    the sign at the protocol edge.
    """

    Binary = 63
    Utf8GeneralCI = 33
    Utf8MB4Bin = 46
    Utf8MB4GeneralCI = 45
    Utf8MB4UnicodeCI = 224
    Utf8MB4_0900AICI = 255
    Latin1Bin = 47
    ASCIIBin = 65


INT_TYPES = frozenset(
    {TypeCode.Tiny, TypeCode.Short, TypeCode.Int24, TypeCode.Long, TypeCode.LongLong, TypeCode.Year}
)
FLOAT_TYPES = frozenset({TypeCode.Float, TypeCode.Double})
STRING_TYPES = frozenset(
    {
        TypeCode.Varchar,
        TypeCode.VarString,
        TypeCode.String,
        TypeCode.TinyBlob,
        TypeCode.MediumBlob,
        TypeCode.LongBlob,
        TypeCode.Blob,
    }
)
TIME_TYPES = frozenset({TypeCode.Date, TypeCode.Datetime, TypeCode.Timestamp, TypeCode.NewDate})

UNSPECIFIED_LENGTH = -1


@dataclass
class FieldType:
    """Column/expression result type (ref: pkg/parser/types/field_type.go:40).

    flen/decimal carry display width & fractional digits; for NewDecimal they
    are the precision/scale that drive MyDecimal arithmetic parity.
    """

    tp: TypeCode = TypeCode.LongLong
    flag: Flag = Flag(0)
    flen: int = UNSPECIFIED_LENGTH
    decimal: int = UNSPECIFIED_LENGTH
    charset: str = "binary"
    collate: Collation = Collation.Binary
    elems: tuple = field(default_factory=tuple)  # Enum/Set members

    # ---- predicates -------------------------------------------------------
    def is_unsigned(self) -> bool:
        return bool(self.flag & Flag.Unsigned)

    def is_int(self) -> bool:
        return self.tp in INT_TYPES

    def is_float(self) -> bool:
        return self.tp in FLOAT_TYPES

    def is_decimal(self) -> bool:
        return self.tp in (TypeCode.NewDecimal, TypeCode.Decimal)

    def is_string(self) -> bool:
        return self.tp in STRING_TYPES

    def is_time(self) -> bool:
        return self.tp in TIME_TYPES

    def is_duration(self) -> bool:
        return self.tp == TypeCode.Duration

    def not_null(self) -> bool:
        return bool(self.flag & Flag.NotNull)

    def is_ci(self) -> bool:
        """Case/accent-insensitive collation (ref: pkg/util/collate):
        weight-based on the oracle path (types/collate.py); the device
        ASCII-folds and refuses non-ASCII CI data (oracle fallback)."""
        return self.collate in (
            Collation.Utf8GeneralCI,
            Collation.Utf8MB4GeneralCI,
            Collation.Utf8MB4UnicodeCI,
            Collation.Utf8MB4_0900AICI,
        )

    # ---- evaluation class (ref: pkg/types/field_type.go EvalType) ---------
    def eval_type(self) -> str:
        if self.is_int():
            return "int"
        if self.is_float():
            return "real"
        if self.is_decimal():
            return "decimal"
        if self.is_time():
            return "time"
        if self.is_duration():
            return "duration"
        if self.tp == TypeCode.JSON:
            return "json"
        if self.tp in (TypeCode.Enum, TypeCode.Set, TypeCode.Bit):
            return "int"  # device compare/order by member number
        return "string"

    def clone(self) -> "FieldType":
        return FieldType(self.tp, self.flag, self.flen, self.decimal, self.charset, self.collate, self.elems)

    def clone_nullable(self) -> "FieldType":
        """Copy with NotNull dropped (outer-join null extension)."""
        return FieldType(self.tp, self.flag & ~Flag.NotNull, self.flen, self.decimal, self.charset, self.collate, self.elems)

    def __hash__(self):
        return hash((self.tp, int(self.flag), self.flen, self.decimal, self.collate))


# ---- constructors mirroring types.NewFieldType defaults -------------------

def new_longlong(unsigned: bool = False, notnull: bool = False) -> FieldType:
    fl = Flag.Binary
    if unsigned:
        fl |= Flag.Unsigned
    if notnull:
        fl |= Flag.NotNull
    return FieldType(TypeCode.LongLong, fl, flen=20 if unsigned else 21, decimal=0)


def new_double() -> FieldType:
    return FieldType(TypeCode.Double, Flag.Binary, flen=22, decimal=UNSPECIFIED_LENGTH)


def new_float() -> FieldType:
    return FieldType(TypeCode.Float, Flag.Binary, flen=12, decimal=UNSPECIFIED_LENGTH)


def new_decimal(precision: int = 11, scale: int = 0) -> FieldType:
    return FieldType(TypeCode.NewDecimal, Flag.Binary, flen=precision, decimal=scale)


def new_varchar(flen: int = UNSPECIFIED_LENGTH, collate: Collation = Collation.Utf8MB4Bin) -> FieldType:
    return FieldType(TypeCode.Varchar, Flag(0), flen=flen, decimal=0, charset="utf8mb4", collate=collate)


def new_date() -> FieldType:
    return FieldType(TypeCode.Date, Flag.Binary, flen=10, decimal=0)


def new_json() -> FieldType:
    return FieldType(TypeCode.JSON, Flag(0), UNSPECIFIED_LENGTH, 0)


def new_enum(elems: tuple, notnull: bool = False) -> FieldType:
    return FieldType(TypeCode.Enum, Flag.NotNull if notnull else Flag(0), UNSPECIFIED_LENGTH, 0, elems=tuple(elems))


def new_set(elems: tuple, notnull: bool = False) -> FieldType:
    return FieldType(TypeCode.Set, Flag.NotNull if notnull else Flag(0), UNSPECIFIED_LENGTH, 0, elems=tuple(elems))


def new_datetime(fsp: int = 0) -> FieldType:
    return FieldType(TypeCode.Datetime, Flag.Binary, flen=19 + (fsp + 1 if fsp else 0), decimal=fsp)
