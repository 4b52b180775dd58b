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

The root merge runs the root DAG over the concatenated per-region results:
`exec.executor.run_dag_on_chunks(plan.root_dag, [Chunk.concat(partials)])`,
whose spill and oracle fallback serve a merge that outgrows every capacity
retry. The dispatch half — `execute_root`, `_execute_root` and
`_execute_root_lowmem` in the JAX package — needs the region dispatch
loop (`distsql/dispatch.py select`), which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..exec.dag import (Aggregation, ColumnInfo, DAGRequest, IndexScan, Join, Limit, Projection, Selection, Sort,
                        TableScan, TopN, Window, current_schema_fts)
from ..expr.agg import AggDesc, AggMode
from ..expr.ir import EXTENSION_OPS, ScalarFunc, col

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
