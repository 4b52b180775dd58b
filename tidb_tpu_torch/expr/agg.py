"""Aggregate function descriptors (ref: pkg/expression/aggregation).

An AggDesc mirrors `AggFuncDesc`: function name, argument expressions, mode.
Modes (ref: aggregation/aggregation.go AggFunctionMode):

  Complete  raw rows in  -> final value out
  Partial1  raw rows in  -> partial state out      (device, per region)
  Partial2  partials in  -> merged partial out     (psum over mesh / host)
  Final     partials in  -> final value out        (root merge)

Partial-state schemas (what crosses regions and what psum reduces):

  count      [count int64]                    merge: +
  sum        [sum  argclass]                  merge: +   (NULL if no rows)
  avg        [count int64, sum argclass]      merge: +,+ (ref: aggfuncs avg)
  min / max  [val argclass]                   merge: min/max with null drop
  first_row  [has int64, val argclass]        merge: first state with has>0
             (has distinguishes "region saw no rows" from "first row's
              value is NULL" — the value itself may legitimately be NULL)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..types import FieldType, TypeCode, new_longlong
from .ir import Expr

AGG_FUNCS = frozenset({
    "count", "sum", "avg", "min", "max", "first_row", "bit_and", "bit_or", "bit_xor",
    # moment-based: states [count, sum, sum_sq] are additive -> mesh-mergeable
    "stddev_pop", "stddev_samp", "var_pop", "var_samp",
    # host-only (varlen accumulation): planned at root, oracle-evaluated
    "group_concat",
})


class AggMode(enum.IntEnum):
    Complete = 0
    Partial1 = 1
    Partial2 = 2
    Final = 3


@dataclass(frozen=True)
class AggDesc:
    name: str
    args: tuple  # tuple[Expr, ...]
    mode: AggMode = AggMode.Complete
    distinct: bool = False
    ft: FieldType | None = None  # result type (final); inferred if None
    extra: str | None = None  # group_concat SEPARATOR

    def __post_init__(self):
        if self.name not in AGG_FUNCS:
            raise ValueError(f"unknown aggregate {self.name!r}")
        if self.ft is None:
            object.__setattr__(self, "ft", self.infer_ft())

    def infer_ft(self) -> FieldType:
        """Result FieldType (ref: aggregation type inference in planner)."""
        if self.name == "count":
            return new_longlong(notnull=True)
        # In merge modes (Final/Partial2) args are partial-state columns:
        # [count, sum] for avg, [sum] for sum — the value column is last.
        arg_ft = self.args[-1].ft if self.args else new_longlong()
        if self.mode in (AggMode.Final, AggMode.Partial2):
            if self.name == "sum":
                return arg_ft.clone()
            if self.name == "avg":
                if arg_ft.eval_type() == "real":
                    return FieldType(TypeCode.Double)
                return FieldType(
                    TypeCode.NewDecimal,
                    flen=(arg_ft.flen or 20) + 4,
                    decimal=min(max(arg_ft.decimal, 0) + 4, 30),
                )
        if self.name == "first_row" and self.mode in (AggMode.Final, AggMode.Partial2) and len(self.args) > 1:
            # merge-mode first_row args are the [has, value] state columns;
            # the result type is the value column's, not the has flag's
            return self.args[-1].ft.clone()
        arg_ft = self.args[0].ft if self.args else new_longlong()
        if self.name in ("min", "max", "first_row"):
            return arg_ft.clone()
        if self.name in ("bit_and", "bit_or", "bit_xor"):
            return new_longlong(unsigned=True)
        if self.name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            return FieldType(TypeCode.Double)  # always DOUBLE (MySQL)
        if self.name == "group_concat":
            from ..types import new_varchar

            return new_varchar(1024)
        et = arg_ft.eval_type()
        if self.name == "sum":
            if et == "real":
                return FieldType(TypeCode.Double)
            # SUM over int/decimal returns DECIMAL (MySQL)
            return FieldType(TypeCode.NewDecimal, flen=arg_ft.flen + 10, decimal=max(arg_ft.decimal, 0))
        if self.name == "avg":
            if et == "real":
                return FieldType(TypeCode.Double)
            # AVG scale = arg scale + 4 (div frac increment)
            return FieldType(TypeCode.NewDecimal, flen=arg_ft.flen + 4, decimal=min(max(arg_ft.decimal, 0) + 4, 30))
        raise AssertionError(self.name)

    def partial_fts(self) -> list[FieldType]:
        """Schema of this aggregate's partial state columns."""
        if self.mode in (AggMode.Final, AggMode.Partial2) and self.args:
            # args already ARE the state columns
            return [a.ft.clone() for a in self.args]
        if self.name == "count":
            return [new_longlong(notnull=True)]
        arg_ft = self.args[0].ft
        et = arg_ft.eval_type()
        if self.name == "sum":
            return [self._sum_ft(arg_ft)]
        if self.name == "avg":
            return [new_longlong(notnull=True), self._sum_ft(arg_ft)]
        if self.name in ("min", "max"):
            return [arg_ft.clone()]
        if self.name == "first_row":
            return [new_longlong(notnull=True), arg_ft.clone()]
        if self.name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            # additive moment states (ref: aggfuncs varPop partial results)
            return [new_longlong(notnull=True), FieldType(TypeCode.Double), FieldType(TypeCode.Double)]
        if self.name == "group_concat":
            return [self.infer_ft() if self.ft is None else self.ft.clone()]
        return [new_longlong(unsigned=True)]

    @staticmethod
    def _sum_ft(arg_ft: FieldType) -> FieldType:
        if arg_ft.eval_type() == "real":
            return FieldType(TypeCode.Double)
        return FieldType(TypeCode.NewDecimal, flen=(arg_ft.flen or 20) + 10, decimal=max(arg_ft.decimal, 0))

    def fingerprint(self) -> tuple:
        return (
            "agg",
            self.name,
            int(self.mode),
            self.distinct,
            self.extra,
            self.ft.tp,
            self.ft.decimal,
        ) + tuple(a.fingerprint() for a in self.args)
