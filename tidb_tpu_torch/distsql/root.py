"""The root's planning half (port of tidb_tpu/distsql/root.py): split a
logical DAG into a per-region pushdown plan and a root merge plan (ref:
pkg/planner/core finishCopTask / PhysicalHashAgg partial-final split).

Split rules (first merge point wins; everything before it is row-local and
pushes verbatim — scans, selections, projections, broadcast joins):

  Aggregation  push Partial1, root runs the Final merge re-group; DISTINCT
               aggregates and group_concat are not decomposable -> the
               whole agg stays at root (ref: AggregationPushDownSolver
               skips distinct)
  TopN         pushed per region AND re-applied at root (global top-k is
               contained in the union of per-region top-k)
  Limit        pushed per region and re-applied at root
  Sort, Window run wholly at root

Executors after the merge point run at root unchanged: the Final merge
reproduces the Complete aggregation's output schema, so HAVING selections,
root TopN/Limit and output offsets apply as written.

`execute_root` joins the two halves: it splits the statement, dispatches
the push half over the store's regions (`dispatch.select`, in the tier the
planner picks), and runs the root DAG over the concatenated per-region
results with `exec.executor.run_dag_on_chunks(..., device=store.device)`,
whose spill and oracle fallback serve a merge that outgrows every capacity
retry. A store made on `cuda` merges on the card, one made with
`device="cpu"` on the host. `low_memory` folds the regions' partial
states one region at a time over `dispatch.select_stream` (Partial2).

Before the split, `execute_root` consults the columnar replica
(columnar/route.py try_columnar_select) when `isolation_engines` allows
`columnar`: an eligible analytical scan runs whole over the replica's
stable batch on the store's device, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..chunk import Chunk
from ..exec.builder import DEFAULT_GROUP_CAPACITY, ProgramCache
from ..exec.dag import (Aggregation, ColumnInfo, DAGRequest, IndexScan, Join, Limit, Projection, Selection, Sort,
                        TableScan, TopN, Window, current_schema_fts)
from ..expr.agg import AggDesc, AggMode
from ..exec.executor import run_dag_on_chunks
from ..expr.ir import EXTENSION_OPS, ScalarFunc, col
from .dispatch import KVRequest, SelectResult, select

# ops evaluated only by the host oracle (the runtime-blocklist analog of
# infer_pushdown.go IsPushDownEnabled): JSON + regexp follow the per-store
# pushdown whitelists (scalarExprSupportedByTiKV)
HOST_ONLY_OPS = frozenset({
    "replace",
    "json_extract", "json_unquote", "json_type", "json_valid",
    "json_length", "json_keys", "json_contains", "json_member_of",
    "json_array", "json_object", "json_quote", "regexp", "regexp_like",
    "convert_using",
})


@dataclass
class RootPlan:
    """The two halves of a split plan. root_dag is None when the pushdown
    result needs no root computation (plain scan shapes) — the per-region
    chunks concatenate in task (range) order, which also serves keep_order."""

    push_dag: DAGRequest
    root_dag: DAGRequest | None


def _merge_aggregation(agg: Aggregation) -> Aggregation:
    """Build the root Final-merge Aggregation over the Partial1 output
    schema [agg states..., group cols...]."""
    merge_descs = []
    idx = 0
    for d in agg.aggs:
        pf = d.partial_fts()
        args = tuple(col(idx + i, pf[i]) for i in range(len(pf)))
        idx += len(pf)
        merge_descs.append(AggDesc(d.name, args, mode=AggMode.Final, distinct=d.distinct, ft=d.ft, extra=d.extra))
    group_refs = tuple(col(idx + i, g.ft) for i, g in enumerate(agg.group_by))
    return Aggregation(group_by=group_refs, aggs=tuple(merge_descs), merge=True)


def host_only_exprs(exprs) -> bool:
    """True if any expression uses an op the device whitelist excludes."""

    def walk(e):
        if isinstance(e, ScalarFunc):
            if e.op in HOST_ONLY_OPS or e.op in EXTENSION_OPS:
                return True
            return any(walk(a) for a in e.args)
        return False

    return any(walk(e) for e in exprs)


def _has_host_only_op(ex) -> bool:
    """Executor-level screen: keep any executor whose expressions use
    host-only ops at root, where the oracle fallback can evaluate them."""
    exprs: list = []
    if isinstance(ex, Selection):
        exprs = list(ex.conditions)
    elif isinstance(ex, Projection):
        exprs = list(ex.exprs)
    elif isinstance(ex, Aggregation):
        exprs = list(ex.group_by)
        for d in ex.aggs:
            exprs.extend(d.args)
    elif isinstance(ex, (TopN, Sort)):
        exprs = [e for e, _ in ex.order_by]
    elif isinstance(ex, Join):
        exprs = list(ex.probe_keys) + list(ex.build_keys)
        if any(_has_host_only_op(b) for b in ex.build):
            return True
    elif isinstance(ex, Window):
        exprs = list(ex.partition_by) + [e for e, _ in ex.order_by]
        for w in ex.funcs:
            exprs.extend(w.args)
    return host_only_exprs(exprs)


def split_dag(dag: DAGRequest) -> RootPlan:
    executors = dag.executors
    push: list = []
    root: list = []
    i = 0
    while i < len(executors):
        ex = executors[i]
        if not isinstance(ex, (TableScan, IndexScan)) and _has_host_only_op(ex):
            root = list(executors[i:])
            break
        if isinstance(ex, (TableScan, IndexScan, Selection, Projection, Join)):
            push.append(ex)
            i += 1
            continue
        if isinstance(ex, Aggregation):
            if any(d.distinct or d.name == "group_concat" for d in ex.aggs):
                # not decomposable: aggregate wholly at root
                root = list(executors[i:])
            else:
                push.append(replace(ex, partial=True))
                root = [_merge_aggregation(ex)] + list(executors[i + 1:])
            break
        if isinstance(ex, (TopN, Limit)):
            push.append(ex)  # per-region pre-prune
            root = list(executors[i:])  # re-apply globally, then the rest
            break
        if isinstance(ex, (Sort, Window)):
            # the root sorts the full concatenation (a per-region pre-sort
            # would be wasted work without a k-way merge); window functions
            # need the full partition
            root = list(executors[i:])
            break
        raise TypeError(f"unknown executor {ex}")
    push_fts = current_schema_fts(push)
    push_dag = DAGRequest(tuple(push), output_offsets=tuple(range(len(push_fts))), time_zone=dag.time_zone,
                          flags=dag.flags)
    if not root:
        # fully pushable: apply the original offsets region-side
        return RootPlan(replace(push_dag, output_offsets=dag.output_offsets), None)
    virtual_scan = TableScan(0, tuple(ColumnInfo(-100 - i, ft) for i, ft in enumerate(push_fts)))
    root_dag = DAGRequest((virtual_scan, *root), output_offsets=dag.output_offsets, time_zone=dag.time_zone,
                          flags=dag.flags)
    return RootPlan(push_dag, root_dag)


def execute_root(
    store,
    dag: DAGRequest,
    ranges: list,
    start_ts: int,
    aux_chunks: list | None = None,
    concurrency: int = 4,
    cache: ProgramCache | None = None,
    group_capacity: int = DEFAULT_GROUP_CAPACITY,
    paging_size: int | None = None,
    batch_cop: bool = False,
    summary_sink: list | None = None,
    tracker=None,
    low_memory: bool = False,
    small_groups: int | None = None,
    checker=None,
    backoff_weight: int = 2,
    replica_read: str = "leader",
    mesh: bool | None = None,
    mesh_min_rows: int = 0,
    isolation_engines: tuple = ("tpu",),
) -> Chunk:
    """Run a logical (Complete-mode) DAG over the store: split, dispatch the
    pushdown half per region, merge at root. The caller-visible result is
    identical to running the whole DAG over all rows at once.

    isolation_engines (tidb_isolation_read_engines) is the engine-routing
    consult (ref: kv.StoreType{TiKV,TiFlash} selection): when it includes
    `columnar` and the plan is an eligible analytical scan, the WHOLE DAG
    runs over the columnar replica's device-resident chunks at the same
    snapshot — no split, no per-region dispatch — with a typed-staleness
    fallback to the row store when the replica's frontier lags.

    mesh (tidb_enable_tpu_mesh) lets the dispatch planner pick the mesh
    tier for eligible partial-agg/TopN pushdowns on >= 2 devices; the
    port's store serves it as its batched tier.

    paging_size applies only when the pushdown half is row-local (the store
    rejects paged aggregation/TopN/Limit); otherwise it is ignored here.
    tracker accounts per-region result bytes; low_memory switches to a
    sequential dispatch with an INCREMENTAL Partial2 fold of per-region agg
    states, so the working set stays O(one region + the group table)
    instead of O(all regions) (ref: util/memory action chain +
    agg_spill.go's bounded-memory intent)."""
    from ..util import tracing

    with tracing.span("distsql.execute_root", n_ranges=len(ranges),
                      start_ts=start_ts, low_memory=low_memory) as sp:
        out = _execute_root(
            store, dag, ranges, start_ts, aux_chunks, concurrency, cache,
            group_capacity, paging_size, batch_cop, summary_sink, tracker,
            low_memory, small_groups, checker, backoff_weight, replica_read,
            mesh, mesh_min_rows, isolation_engines,
        )
        if sp is not None:
            sp.set("rows", out.num_rows())
        return out


def _execute_root(
    store, dag, ranges, start_ts, aux_chunks, concurrency, cache,
    group_capacity, paging_size, batch_cop, summary_sink, tracker,
    low_memory, small_groups, checker, backoff_weight=2,
    replica_read="leader", mesh=None, mesh_min_rows=0,
    isolation_engines=("tpu",),
) -> Chunk:
    if "columnar" in isolation_engines:
        # engine routing: eligible analytical scans ride the columnar
        # replica; None = not ours / frontier lagged after the
        # data_not_ready wait — the row store serves as if never routed
        from ..columnar.route import try_columnar_select

        served = try_columnar_select(
            store, dag, ranges, start_ts, aux_chunks or [], cache=cache,
            group_capacity=group_capacity, small_groups=small_groups,
            backoff_weight=backoff_weight, checker=checker,
        )
        if served is not None:
            if summary_sink is not None:
                # dict entries are dispatch attribution, filtered from the
                # per-task summary lists by EXPLAIN ANALYZE (same contract
                # as batch_stats)
                summary_sink.append({"columnar": {"rows": served.num_rows()}})
            return served
    plan = split_dag(dag)
    if low_memory and plan.root_dag is not None:
        folded = _execute_root_lowmem(store, plan, ranges, start_ts, aux_chunks or [], cache, group_capacity,
                                      tracker)
        if folded is not None:
            return folded
    if paging_size is not None:
        from ..exec.dag import executor_walk

        if any(isinstance(e, (Aggregation, TopN, Limit, Sort)) for e in executor_walk(plan.push_dag.executors)):
            paging_size = None
    res: SelectResult = select(
        store,
        KVRequest(
            plan.push_dag, ranges, start_ts, concurrency=concurrency,
            aux_chunks=aux_chunks or [], paging_size=paging_size,
            batch_cop=batch_cop, small_groups=small_groups, checker=checker,
            backoff_weight=backoff_weight, replica_read=replica_read,
            mesh=mesh, mesh_min_rows=mesh_min_rows,
        ),
    )
    if summary_sink is not None:
        # per-task ExecutorExecutionSummary lists (ref: tipb exec summaries
        # consumed by EXPLAIN ANALYZE, select_result.go:499)
        summary_sink.extend(res.exec_summaries)
        if res.batch_stats is not None:
            # dict entry = batched-dispatch attribution
            summary_sink.append(res.batch_stats)
    if tracker is not None:
        for c in res.chunks:
            if c is not None:
                tracker.consume(c.nbytes())
    merged = res.merged()
    if merged is None:
        merged = Chunk.empty(plan.push_dag.output_fts())
    out = merged
    if plan.root_dag is not None:
        from ..util import tracing

        # run_dag_on_chunks has the oracle fallback — a root merge whose
        # group count outgrows every capacity retry degrades, not crashes
        with tracing.span("distsql.root_merge", in_rows=merged.num_rows()):
            out = run_dag_on_chunks(plan.root_dag, [merged], cache=cache, group_capacity=group_capacity,
                                    small_groups=small_groups, device=store.device)
    if tracker is not None:
        for c in res.chunks:
            if c is not None:
                tracker.consume(-c.nbytes())
    return out


def _partial2_dag(plan: RootPlan) -> DAGRequest | None:
    """Fold DAG for an incremental merge: over the push half's
    partial-state schema, re-aggregate in merge mode EMITTING partial
    states again (Partial2 — associative, so region results fold pairwise;
    ref: pkg/expression/aggregation AggFunctionMode Partial2Mode)."""
    if plan.root_dag is None or len(plan.root_dag.executors) < 2:
        return None
    merge_agg = plan.root_dag.executors[1]
    if not isinstance(merge_agg, Aggregation) or not merge_agg.merge:
        return None
    p2 = replace(merge_agg, partial=True)
    scan = plan.root_dag.executors[0]
    n_out = len(p2.output_fts())
    return DAGRequest((scan, p2), output_offsets=tuple(range(n_out)))


def _execute_root_lowmem(store, plan: RootPlan, ranges, start_ts, aux_chunks, cache, group_capacity,
                         tracker) -> Chunk | None:
    """Sequential region dispatch + pairwise Partial2 fold; None when the
    plan has no foldable merge point (caller uses the normal path)."""
    from .dispatch import select_stream

    p2 = _partial2_dag(plan)
    if p2 is None:
        return None
    # mesh=False: the whole point here is ONE region's result live at a
    # time — a mesh batch would stack every region back into memory
    req = KVRequest(plan.push_dag, ranges, start_ts, concurrency=1,
                    aux_chunks=aux_chunks, mesh=False)
    acc: Chunk | None = None
    for chunk, _sums in select_stream(store, req):
        if tracker is not None:
            tracker.consume(chunk.nbytes())
        if acc is None:
            acc = chunk
        else:
            both = Chunk.concat([acc, chunk])
            folded = run_dag_on_chunks(p2, [both], cache=cache, group_capacity=group_capacity, device=store.device)
            if tracker is not None:
                tracker.consume(-acc.nbytes())
                tracker.consume(-chunk.nbytes())
                tracker.consume(folded.nbytes())
            acc = folded
    if acc is None:
        acc = Chunk.empty(plan.push_dag.output_fts())
    return run_dag_on_chunks(plan.root_dag, [acc], cache=cache, group_capacity=group_capacity, device=store.device)
