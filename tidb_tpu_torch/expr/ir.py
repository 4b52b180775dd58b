"""Expression IR — the engine's analog of `tipb.Expr` trees.

The reference serializes planner expressions to protobuf (ref:
pkg/expression/expr_to_pb.go:37 ExpressionsToPBList) and rebuilds them on the
coprocessor side (ref: pkg/expression/distsql_builtin.go). Here the IR *is*
the wire/plan form: immutable, hashable nodes carrying a result FieldType, so
a whole DAG fingerprints to a cache key for compiled XLA programs
(SURVEY.md §7 layer 4).

Ops use generic names; the eval class of the *arguments* selects the concrete
semantics at compile time, mirroring how tipb ScalarFuncSig variants
(GTInt/GTReal/GTDecimal/...) are chosen by pkg/expression type inference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types import Datum, FieldType

# Canonical op names understood by the compiler (compile.py OP table) and the
# reference evaluator (eval_ref.py). Mirrors the pushdown whitelist idea of
# infer_pushdown.go:160 — anything outside this set cannot be pushed to TPU.
SCALAR_OPS = frozenset(
    {
        # arithmetic
        "plus", "minus", "mul", "div", "intdiv", "mod", "unaryminus", "abs",
        # comparison
        "eq", "ne", "lt", "le", "gt", "ge", "nulleq", "in", "between",
        # logical
        "and", "or", "not", "xor",
        # JSON + regexp (host-only: distsql/root.py HOST_ONLY keeps them
        # at the root oracle; ref: builtin_json_vec.go, builtin_regexp_vec.go)
        "json_extract", "json_unquote", "json_type", "json_valid",
        "json_length", "json_keys", "json_contains", "json_member_of",
        "json_array", "json_object", "json_quote", "regexp", "regexp_like",
        "convert_using",
        # null handling / control
        "isnull", "ifnull", "if", "case", "coalesce",
        # casts (target class from result ft)
        "cast",
        # math
        "ceil", "floor", "round", "sqrt", "exp", "log", "ln", "pow", "sign",
        # string (device subset; packed-word ops)
        "like", "length", "strcmp", "substr",
        "concat", "upper", "lower", "trim", "ltrim", "rtrim", "replace",
        # date/time extraction from packed datetime
        "year", "month", "day", "hour", "minute", "second", "weekday", "to_days", "extract",
        # date arithmetic (unit rides as a const string arg)
        "date_add", "date_sub", "datediff",
        # bit
        "bitand", "bitor", "bitxor", "bitneg", "shiftleft", "shiftright",
    }
)

# host-only custom functions added at runtime by the extension registry
# (ref: pkg/extension custom functions); never device-compiled — the DAG
# splitter pins expressions containing them to the root side
EXTENSION_OPS: set = set()


class Expr:
    """Base expression node. All nodes expose `.ft` and are hashable."""

    __slots__ = ()
    ft: FieldType

    def children(self) -> tuple["Expr", ...]:
        return ()

    def fingerprint(self) -> tuple:
        raise NotImplementedError


@dataclass(frozen=True)
class ColumnRef(Expr):
    """Reference to the i-th column of the child operator's output
    (ref: tipb.Expr ColumnRef with offset payload)."""

    index: int
    ft: FieldType

    def fingerprint(self) -> tuple:
        return ("col", self.index, self.ft.tp, int(self.ft.flag), self.ft.flen, self.ft.decimal)


@dataclass(frozen=True)
class Const(Expr):
    """A literal. The datum participates in the fingerprint so constant
    folding differences recompile (mirrors plan-cache parameterization —
    heavy reuse should parameterize instead; see exec/builder.py)."""

    datum: Datum
    ft: FieldType

    def fingerprint(self) -> tuple:
        v = self.datum.val
        key = str(v) if not isinstance(v, (int, float, str, bytes, type(None))) else v
        return ("const", self.datum.kind, key, self.ft.tp, self.ft.decimal)


@dataclass(frozen=True)
class ScalarFunc(Expr):
    op: str
    args: tuple
    ft: FieldType

    def __post_init__(self):
        if self.op not in SCALAR_OPS and self.op not in EXTENSION_OPS:
            raise ValueError(f"unknown scalar op {self.op!r}")

    def children(self) -> tuple[Expr, ...]:
        return self.args

    def fingerprint(self) -> tuple:
        return ("fn", self.op, self.ft.tp, int(self.ft.flag), self.ft.decimal) + tuple(
            a.fingerprint() for a in self.args
        )


# ---- convenience constructors ---------------------------------------------

def col(index: int, ft: FieldType) -> ColumnRef:
    return ColumnRef(index, ft)


def const(d: Datum, ft: FieldType) -> Const:
    return Const(d, ft)


def lit(v, ft: FieldType) -> Const:
    """Build a Const from a python value using the target FieldType."""
    from ..types import DatumKind, MyDecimal, MyTime

    if v is None:
        return Const(Datum.NULL, ft)
    if ft.is_decimal():
        return Const(Datum.dec(MyDecimal(v, max(ft.decimal, 0))), ft)
    if ft.is_float():
        return Const(Datum.f64(float(v)), ft)
    if ft.is_string():
        # keep str subclasses intact (plan-cache slot tags, plancache.SlotStr)
        return Const(Datum.string(v if isinstance(v, str) else str(v)), ft)
    if ft.is_time():
        t = v if isinstance(v, MyTime) else MyTime.parse(str(v), max(ft.decimal, 0))
        return Const(Datum.time(t), ft)
    if ft.is_unsigned():
        return Const(Datum.u64(int(v)), ft)
    return Const(Datum.i64(int(v)), ft)


def func(op: str, ft: FieldType, *args: Expr) -> ScalarFunc:
    return ScalarFunc(op, tuple(args), ft)
