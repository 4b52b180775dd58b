"""The DAG request IR — this framework's `tipb.DAGRequest`.

Mirrors the executor-list shape of the reference wire format
(ref: pingcap/tipb DAGRequest; built by pkg/planner/core/plan_to_pb.go and
consumed by unistore/cophandler/cop_handler.go:319 buildDAG): a scan-first
pipeline of executors plus output offsets and encode options. Everything is
immutable and fingerprintable so compiled XLA programs cache per plan shape
(ref: the coprocessor-cache keying idea, pkg/store/copr/coprocessor_cache.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..expr.agg import AggDesc
from ..expr.ir import Expr
from ..types import FieldType


@dataclass(frozen=True)
class ColumnInfo:
    """(ref: tipb.ColumnInfo — column id + type as the scan emits it;
    `default` mirrors tipb's default_val: rows written before an ADD
    COLUMN have no bytes for the column, and the scan fills this origin
    default instead of NULL)."""

    col_id: int
    ft: FieldType
    default: object = None  # Datum | None

    def fingerprint(self):
        d = None if self.default is None else repr(self.default)
        return (self.col_id, self.ft.tp, int(self.ft.flag), self.ft.flen, self.ft.decimal, d)


@dataclass(frozen=True)
class TableScan:
    """(ref: tipb.TableScan; executor mpp_exec.go:110 tableScanExec)."""

    table_id: int
    columns: tuple  # tuple[ColumnInfo, ...]
    desc: bool = False

    def fingerprint(self):
        return ("scan", self.table_id, self.desc) + tuple(c.fingerprint() for c in self.columns)


@dataclass(frozen=True)
class IndexScan:
    """(ref: tipb.IndexScan; executor mpp_exec.go:255 indexScanExec).

    Reads index entries `t{tid}_i{iid}{vals...}{handle}` instead of rows;
    output schema is the stored entry layout: the indexed columns in index
    order, then the int64 handle (col_id -1). A covering query runs
    entirely off this scan; an index lookup uses it to produce handles for
    a second table read."""

    table_id: int
    index_id: int
    columns: tuple  # tuple[ColumnInfo, ...] — index cols then handle(-1)
    desc: bool = False

    def fingerprint(self):
        return ("iscan", self.table_id, self.index_id, self.desc) + tuple(
            c.fingerprint() for c in self.columns
        )


@dataclass(frozen=True)
class Selection:
    """(ref: tipb.Selection; mpp_exec.go:1121 selExec)."""

    conditions: tuple  # tuple[Expr, ...]

    def fingerprint(self):
        return ("sel",) + tuple(c.fingerprint() for c in self.conditions)


@dataclass(frozen=True)
class Projection:
    """(ref: tipb.Projection; mpp_exec.go:1157 projExec)."""

    exprs: tuple

    def fingerprint(self):
        return ("proj",) + tuple(e.fingerprint() for e in self.exprs)


@dataclass(frozen=True)
class Aggregation:
    """(ref: tipb.Aggregation; mpp_exec.go:999 aggExec). Output schema is
    [agg results..., group-by keys...] matching the reference's layout.

    `stream` marks input already sorted by group keys (StreamAgg): the
    boundary-scan kernel runs — no sort, no hash (ops/aggregate.py
    _group_aggregate_stream; ref: agg_stream_executor.go).
    `partial` True emits partial states instead of finalized values.
    """

    group_by: tuple  # tuple[Expr, ...]
    aggs: tuple  # tuple[AggDesc, ...]
    stream: bool = False
    partial: bool = False
    merge: bool = False  # input rows are partial states (Final/Partial2)

    def fingerprint(self):
        return (
            ("agg", self.stream, self.partial, self.merge)
            + tuple(g.fingerprint() for g in self.group_by)
            + tuple(a.fingerprint() for a in self.aggs)
        )

    def output_fts(self) -> list[FieldType]:
        out = []
        for a in self.aggs:
            if self.partial:
                out.extend(a.partial_fts())
            else:
                out.append(a.ft)
        out.extend(g.ft for g in self.group_by)
        return out


@dataclass(frozen=True)
class Join:
    """Equi hash join (ref: tipb.Join; unistore/cophandler/mpp_exec.go:844
    joinExec; root-side design pkg/executor/join/hash_join_v2.go:658).

    The enclosing pipeline is the PROBE side (preserved by left_outer, like
    the reference's probe stream); `build` is a scan-first sub-pipeline for
    the build side — its scans consume the request's broadcast aux batches
    (the TiFlash broadcast-exchange analog, mpp_exec.go:669 Broadcast mode).
    Output schema: probe columns ++ build columns (semi/anti: probe only).

    Key expressions must agree in eval class/scale/signedness between the
    two sides — the planner inserts casts, as the reference's hash join
    requires identical key types (join key normalization in planner core).
    """

    build: tuple  # tuple[executor, ...] — scan-first build pipeline
    probe_keys: tuple  # tuple[Expr, ...] over the probe schema
    build_keys: tuple  # tuple[Expr, ...] over the build schema
    join_type: str = "inner"  # inner | left_outer | semi | anti
    # planner-proven: build keys are unique per build row (PK handle or a
    # unique index covering exactly the key columns). The kernel then skips
    # the fan-out expansion pass (output keeps the probe layout); runtime-
    # verified — a fan-out > 1 raises join overflow and the driver retries
    # with the general kernel (ref: hash_join_v2.go one-row-per-key layout).
    build_unique: bool = False

    def __post_init__(self):
        if self.join_type not in ("inner", "left_outer", "semi", "anti"):
            raise ValueError(f"unknown join type {self.join_type!r}")
        if len(self.probe_keys) != len(self.build_keys):
            raise ValueError("join key arity mismatch")

    def fingerprint(self):
        return (
            ("join", self.join_type, self.build_unique)
            + tuple(e.fingerprint() for e in self.build)
            + ("pk",) + tuple(k.fingerprint() for k in self.probe_keys)
            + ("bk",) + tuple(k.fingerprint() for k in self.build_keys)
        )


@dataclass(frozen=True)
class WinDesc:
    """One window function (ref: tipb.WindowFunc within tipb.Window;
    semantics pkg/executor/aggfuncs/func_{rank,row_number,lead_lag,...}.go).

    `offset` carries the static integer parameter: LEAD/LAG offset,
    NTILE bucket count, NTH_VALUE position. `default` is the lowered
    LEAD/LAG default expression (a Const) or None (NULL)."""

    name: str
    args: tuple  # tuple[Expr, ...] — value argument(s)
    ft: FieldType
    offset: int = 1
    default: object = None  # Expr | None

    def fingerprint(self):
        d = self.default.fingerprint() if self.default is not None else None
        return ("win", self.name, self.offset, d) + tuple(a.fingerprint() for a in self.args)


@dataclass(frozen=True)
class Window:
    """(ref: tipb.Window; pkg/executor/window.go WindowExec). Output schema:
    input columns ++ one result column per function — matching the
    reference's appended window result columns (plan_to_pb.go:663)."""

    partition_by: tuple  # tuple[Expr, ...]
    order_by: tuple  # tuple[(Expr, desc: bool), ...]
    funcs: tuple  # tuple[WinDesc, ...]

    def fingerprint(self):
        return (
            ("window",)
            + tuple(e.fingerprint() for e in self.partition_by)
            + ("ord",) + tuple((e.fingerprint(), d) for e, d in self.order_by)
            + ("fn",) + tuple(f.fingerprint() for f in self.funcs)
        )


@dataclass(frozen=True)
class TopN:
    """(ref: tipb.TopN; mpp_exec.go:526 topNExec)."""

    order_by: tuple  # tuple[(Expr, desc: bool), ...]
    limit: int

    def fingerprint(self):
        return ("topn", self.limit) + tuple((e.fingerprint(), d) for e, d in self.order_by)


@dataclass(frozen=True)
class Sort:
    """Full sort, no bound (ref: tipb.Sort with IsPartialSort=false;
    root executor pkg/executor/sortexec/sort.go — the external merge sort).
    Split shape: each region sorts its rows, the root re-sorts the
    concatenation (the k-way merge specialization can land later —
    correctness first: EVERY row comes back, in order)."""

    order_by: tuple  # tuple[(Expr, desc: bool), ...]

    def fingerprint(self):
        return ("sort",) + tuple((e.fingerprint(), d) for e, d in self.order_by)


@dataclass(frozen=True)
class Limit:
    """(ref: tipb.Limit; mpp_exec.go:397 limitExec)."""

    limit: int

    def fingerprint(self):
        return ("limit", self.limit)


@dataclass(frozen=True)
class DAGRequest:
    """Executor pipeline, scan first (ref: tipb.DAGRequest.Executors).

    output_offsets selects/permutes the final executor's columns
    (ref: cop_handler.go output offsets handling :249-267).
    """

    executors: tuple
    output_offsets: tuple
    time_zone: str = "UTC"
    flags: int = 0

    def fingerprint(self):
        return tuple(e.fingerprint() for e in self.executors) + ("out",) + tuple(self.output_offsets)

    def scan(self):
        assert isinstance(self.executors[0], (TableScan, IndexScan))
        return self.executors[0]

    def output_fts(self) -> list[FieldType]:
        fts = current_schema_fts(self.executors)
        return [fts[i] for i in self.output_offsets]


def current_schema_fts(executors) -> list[FieldType]:
    """Schema of the last executor's output."""
    fts: list[FieldType] = []
    for ex in executors:
        if isinstance(ex, (TableScan, IndexScan)):
            fts = [c.ft for c in ex.columns]
        elif isinstance(ex, (Selection, Limit, TopN, Sort)):
            pass  # schema unchanged
        elif isinstance(ex, Projection):
            fts = [e.ft for e in ex.exprs]
        elif isinstance(ex, Aggregation):
            fts = ex.output_fts()
        elif isinstance(ex, Window):
            fts = fts + [f.ft for f in ex.funcs]
        elif isinstance(ex, Join):
            if ex.join_type in ("semi", "anti"):
                pass  # probe schema unchanged
            else:
                build_fts = current_schema_fts(ex.build)
                if ex.join_type == "left_outer":
                    build_fts = [f.clone_nullable() for f in build_fts]
                fts = fts + build_fts
        else:
            raise TypeError(f"unknown executor {ex}")
    return fts


def executor_walk(executors) -> list:
    """Executors flattened in execution-summary order: scan first, a Join's
    build pipeline entries before the Join itself — exactly the order the
    fused program appends per-executor row counts."""
    out = [executors[0]]
    for ex in executors[1:]:
        if isinstance(ex, Join):
            out.extend(executor_walk(ex.build))
        out.append(ex)
    return out


def collect_scans(executors) -> list[TableScan]:
    """All TableScans in canonical order: pipeline order, recursing into a
    Join's build side at the Join's position. Device batches (and oracle
    chunks) are supplied in exactly this order."""
    out: list[TableScan] = []
    for ex in executors:
        if isinstance(ex, (TableScan, IndexScan)):
            out.append(ex)
        elif isinstance(ex, Join):
            out.extend(collect_scans(ex.build))
    return out
