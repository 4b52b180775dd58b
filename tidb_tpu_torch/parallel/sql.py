"""SQL -> mesh: route eligible pushdown plans onto the device mesh (port
of tidb_tpu/parallel/sql.py; ref: pkg/planner/core/fragment.go:116
GenerateRootMPPTasks — the reference cuts physical plans at exchange
boundaries into per-node MPP tasks; here the cut is scan + selection
below, grouped aggregation above, with the hash exchange inside
run_sharded_grouped_agg).

The decision mirrors the reference's `useMPPExecution` gate
(pkg/executor/mpp_gather.go:40, sysvar TiDBAllowMPPExecution): the session
asks `try_mesh_select`; a None return (ineligible shape, too few mesh
devices, group overflow) falls back to the per-region path. The mesh is
the store's `mesh_devices`.
"""

from __future__ import annotations

from ..chunk import Chunk
from ..distsql.dispatch import KVRequest, select
from ..exec.dag import Aggregation, DAGRequest, Selection, TableScan

def _agg_mesh_ok(agg) -> bool:
    if not isinstance(agg, Aggregation) or not agg.group_by or agg.merge:
        return False
    # DISTINCT rides the raw-row exchange; group_concat stays root-only
    return not any(d.name == "group_concat" for d in agg.aggs)


def mesh_eligible(dag: DAGRequest) -> str | None:
    """Shape gate (ref: the per-operator CanPushToTiFlash checks). Returns
    the mesh plan kind:

      "agg"  — TableScan [Selection]* Aggregation(GROUP BY)
      "join" — TableScan [Sel]* Join(scan [Sel]*) [Sel]* Aggregation(...)
               (the hash-shuffle repartition join)
      None   — ineligible (host-only exprs, merge mode, group_concat, ...)
    """
    from ..distsql.root import host_only_exprs

    exs = dag.executors
    if len(exs) < 2 or not isinstance(exs[0], TableScan):
        return None
    agg = exs[-1]
    if not _agg_mesh_ok(agg):
        return None
    agg_exprs = list(agg.group_by) + [a for d in agg.aggs for a in d.args]

    if all(isinstance(e, Selection) for e in exs[1:-1]):
        exprs = [c for e in exs[1:-1] for c in e.conditions] + agg_exprs
        # the device ExprCompiler cannot run host-only ops: the per-region
        # path keeps them at root, so the mesh path refuses them
        return None if host_only_exprs(exprs) else "agg"

    from .joinmesh import split_join_dag

    parts = split_join_dag(dag)
    if parts is None:
        return None
    _, pre, stages, _ = parts
    exprs = [c for e in pre for c in e.conditions] + agg_exprs
    for join, post in stages:
        exprs += [c for e in list(join.build[1:]) + post for c in e.conditions]
        exprs += list(join.probe_keys) + list(join.build_keys)
    if host_only_exprs(exprs):
        return None
    return "join"


def try_mesh_select(store, dag: DAGRequest, ranges: list, start_ts: int, group_capacity: int = 1024,
                    min_devices: int = 2, aux_chunks: list | None = None) -> Chunk | None:
    """Execute an eligible plan over the store's mesh; None = not taken.

    Region rows reach the shards through the same scan pushdown (paging /
    retry preserved) as the per-region path; the plan then runs as ONE
    exchange program: Partial1 -> hash exchange -> Final
    (parallel/grouped.py), or the hash-shuffle join feeding the same
    phases (mpp/exchange_op.py). aux_chunks carries the materialized build
    table of a join plan (sliced over the shards)."""
    kind = mesh_eligible(dag)
    if kind is None:
        return None
    if kind == "join" and not aux_chunks:
        return None
    devs = list(store.mesh_devices)
    if len(devs) < min_devices:
        return None
    from ..util import tracing

    with tracing.span("parallel.mesh_select", kind=kind, n_devices=len(devs), n_ranges=len(ranges)) as sp:
        out = _mesh_select(store, dag, ranges, start_ts, group_capacity, aux_chunks, kind, devs)
        if sp is not None and out is not None:
            sp.set("rows", out.num_rows())
        return out


def _mesh_select(store, dag, ranges, start_ts, group_capacity, aux_chunks, kind, devs) -> Chunk | None:
    from ..mpp.dispatch import execute_exchange_plan

    scan = dag.executors[0]
    scan_dag = DAGRequest((scan,), output_offsets=tuple(range(len(scan.columns))))
    res = select(store, KVRequest(scan_dag, ranges, start_ts))
    chunks = [c for c in res.chunks if c is not None and c.num_rows() > 0]
    # the stacking / build slicing / capacity ladder core is shared with
    # the mpp tier (mpp/dispatch.py)
    return execute_exchange_plan(dag, chunks, aux_chunks, kind, devs, group_capacity=group_capacity)
