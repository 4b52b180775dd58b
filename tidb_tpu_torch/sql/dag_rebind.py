"""Slot rebinding over the immutable DAG IR (plan-cache dag tier).

The executors and expression nodes are frozen dataclasses, so a re-bound
DAG is rebuilt along the changed spines only — untouched subtrees (scan
column tuples, aggregate descriptors, the build pipeline of a join) are
SHARED with the cached template, which is safe because they are
immutable and makes a hit's bind cost proportional to the number of
literal slots, not the plan size.

Copy of `tidb_tpu/sql/dag_rebind.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import dataclasses

from ..expr.ir import Const, Expr
from .plancache import slot_of


def iter_exec_fields(ex):
    """Yield (expr, field_name) for every Expr reachable from an
    executor's fields — the audit's search space."""
    out = []

    def walk(v, name):
        if isinstance(v, Expr):
            out.append((v, name))
            for c in getattr(v, "children", lambda: ())():
                walk(c, name)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x, name)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name), f.name)

    for f in dataclasses.fields(ex):
        walk(getattr(ex, f.name), f.name)
    return out


def rebind_dag(dag, binder, values):
    """Rebuild `dag` with every slot-tagged value replaced: Const nodes
    re-lowered through `binder(slot)`, raw int fields (TopN/Limit counts)
    replaced with the bound value. Returns the original object when
    nothing under it changed."""

    def rb(v):
        if isinstance(v, Const):
            s = slot_of(v.datum.val)
            return binder(s) if s is not None else v
        s = slot_of(v)
        if s is not None:
            return int(values[s]) if isinstance(v, int) else str(values[s])
        if isinstance(v, tuple):
            new = tuple(rb(x) for x in v)
            return new if any(a is not b for a, b in zip(new, v)) else v
        if isinstance(v, list):
            new = [rb(x) for x in v]
            return new if any(a is not b for a, b in zip(new, v)) else v
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            changed = {}
            for f in dataclasses.fields(v):
                old = getattr(v, f.name)
                new = rb(old)
                if new is not old:
                    changed[f.name] = new
            return dataclasses.replace(v, **changed) if changed else v
        return v

    return rb(dag)
