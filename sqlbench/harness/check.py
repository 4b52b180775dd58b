"""The comparison that decides `correct`: every statement the window
completed, its rows as the program returned them, against the reference's
answer for the same template and parameters (exact: the limit is 0)."""

from __future__ import annotations

import time
from decimal import Decimal

from . import spec


def value(d):
    """A Datum of the program's Result as a plain Python value."""
    kind = d.kind.name
    if kind == "Null":
        return None
    if kind in ("Int64", "Uint64"):
        return int(d.val)
    if kind in ("String", "Bytes"):
        return d.val if isinstance(d.val, str) else bytes(d.val).decode()
    if kind == "MysqlDecimal":
        return Decimal(str(d.val.d))
    if kind == "MysqlTime":
        ymd = d.val.packed >> 41
        ym = ymd >> 5
        return f"{ym // 13:04d}-{ym % 13:02d}-{ymd & 31:02d}"
    if kind in ("Float32", "Float64"):
        return float(d.val)
    raise ValueError(f"no plain value for a {kind} datum")


def rows_of(result) -> list:
    return [tuple(value(d) for d in row) for row in result.rows]


class Checker:
    """Reference answers for the mix's templates, each (template, params)
    worked out once."""

    def __init__(self, mix: dict, tables: dict, precision: str = "exact"):
        self.tables, self.precision = tables, precision
        self.refs = {t["name"]: t["reference"] for t in mix["templates"]}
        self.memo: dict = {}
        self.scratch: dict = {}  # a reference's prepared arrays, by reference
        self.seconds = 0.0

    def want(self, stmt) -> list:
        key = (stmt.template, stmt.params)
        if key not in self.memo:
            t0 = time.perf_counter()
            ref = self.refs[stmt.template]
            self.memo[key] = spec.reference(ref).answer(self.tables, stmt.param_dict(), self.precision,
                                                        self.scratch.setdefault(ref, {}))
            self.seconds += time.perf_counter() - t0
        return self.memo[key]

    def same(self, stmt, got: list) -> bool:
        want = self.want(stmt)
        cmp = getattr(spec.reference(self.refs[stmt.template]), "compare", None)
        return cmp(got, want) if cmp else got == want


def judge(records: list, checker: Checker) -> dict:
    """Counts over the statements: `wrong` (rows differ from the
    reference), `errors` (raised), `checked`; and the first wrong one."""
    wrong = errors = 0
    first = None
    for r in records:
        if r.error is not None:
            errors += 1
            first = first or f"{r.stmt.template} {dict(r.stmt.params)}: {r.error}"
            continue
        if not checker.same(r.stmt, r.rows):
            wrong += 1
            first = first or (f"{r.stmt.template} {dict(r.stmt.params)}: got {r.rows[:3]} want "
                              f"{checker.want(r.stmt)[:3]}")
    return {"checked": len(records), "wrong": wrong, "errors": errors, "first": first}
