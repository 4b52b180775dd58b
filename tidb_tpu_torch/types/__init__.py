from .field_type import (
    new_json,
    new_enum,
    new_set,
    FieldType,
    TypeCode,
    Flag,
    Collation,
    UNSPECIFIED_LENGTH,
    new_longlong,
    new_double,
    new_float,
    new_decimal,
    new_varchar,
    new_date,
    new_datetime,
)
from .datum import EnumVal, SetVal, Datum, DatumKind
from .mydecimal import MyDecimal, DIV_FRAC_INCR
from .mytime import MyTime, pack_datetime, unpack_datetime

__all__ = [
    "FieldType",
    "TypeCode",
    "Flag",
    "Collation",
    "UNSPECIFIED_LENGTH",
    "Datum",
    "DatumKind",
    "MyDecimal",
    "DIV_FRAC_INCR",
    "MyTime",
    "pack_datetime",
    "unpack_datetime",
    "new_longlong",
    "new_double",
    "new_float",
    "new_decimal",
    "new_varchar",
    "new_date",
    "new_datetime",
]
