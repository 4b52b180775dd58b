"""The execution planner of a region request (port of
tidb_tpu/distsql/planner.py's per-request half): pick each request's
execution tier by data size and topology.

  single  one region task (or a paging request on one thread): the
          per-task path with its capacity ladder and retry ladder.
  pool    N region tasks over the dispatch thread pool, one program run
          per region (also the paging path).
  batch   N tasks grouped per store, stacked on a leading region axis and
          served by ONE run of the region-batched program per (store,
          DAG, capacity) bucket (TPUStore.batch_coprocessor).
  mesh    like batch, but the stacked lanes split over the store's mesh
          devices and the per-region PARTIAL STATES merge across the
          shards (a sum for sum/count/avg states, min/max for extremes, a
          gather and a local reduce for bit/first states, a merge-mode
          re-group for GROUP BY tables, a re-top-k for TopN), so a store
          answers with ONE merged state instead of R per-region partials.

`choose_statement_tier` answers the SQL session's statement-level
question above execute_root: on two or more mesh devices an eligible
GROUP BY (or a join feeding one) takes the "mpp" tier (tidb_allow_mpp ON;
mpp/dispatch.py try_mpp_select, and the mesh select when it declines) or
the "mesh" tier (parallel/sql.py try_mesh_select), else "root". The device
count is the store's mesh width, `len(store.mesh_devices)`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..exec.dag import Aggregation, IndexScan, Join, Projection, Selection, TableScan, TopN

# aggregates whose Partial1 states merge with mesh collectives (additive
# states by a sum over regions, min/max by their extremes, bit and first
# states by a gather)
MESH_MERGEABLE_AGGS = frozenset({
    "count", "sum", "avg", "min", "max", "first_row",
    "bit_and", "bit_or", "bit_xor",
    "stddev_pop", "stddev_samp", "var_pop", "var_samp",
})


@dataclass(frozen=True)
class TierDecision:
    # per-request tiers: "single" | "pool" | "batch" | "mesh"
    tier: str
    # mesh merge kind ("scalar" | "group" | "topn")
    kind: str | None = None


def mesh_merge_kind(dag) -> str | None:
    """Shape gate for the mesh tier: is this pushdown DAG's result
    mergeable across regions on the devices? Returns the merge kind:

      "scalar"  [scan, Sel/Proj/Join*, Aggregation(partial, no GROUP BY)]
      "group"   the same with GROUP BY
      "topn"    [scan, Sel/Proj/Join*, TopN]
      None      ineligible (Complete/Final mode, DISTINCT, group_concat,
                string-valued scalar gather states, Limit/Sort tails,
                reordered output offsets).
    """
    exs = dag.executors
    if len(exs) < 2 or not isinstance(exs[0], (TableScan, IndexScan)):
        return None
    from ..exec.dag import current_schema_fts

    n_out = len(current_schema_fts(exs))
    if tuple(dag.output_offsets) != tuple(range(n_out)):
        # the merge stages index state columns positionally; split_dag's
        # push DAGs always carry identity offsets
        return None
    if not all(isinstance(e, (Selection, Projection, Join)) for e in exs[1:-1]):
        return None
    last = exs[-1]
    if isinstance(last, TopN):
        return "topn"
    if not isinstance(last, Aggregation) or not last.partial or last.merge:
        return None
    for d in last.aggs:
        if d.distinct or d.name not in MESH_MERGEABLE_AGGS:
            return None
    if last.group_by:
        return "group"
    for d in last.aggs:
        # a string-valued gather state (first_row/min/max over varchar)
        # has no lane to ride
        if d.name in ("min", "max", "first_row") and d.ft.is_string():
            return None
    return "scalar"


def _n_devices(store) -> int:
    """The store's mesh width (runtime.mesh_devices)."""
    return len(store.mesh_devices)


def estimated_rows(store) -> int:
    """Coarse data-size signal for the tier decision: the store's live key
    count. It only gates the mesh attempt."""
    try:
        return len(store.kv)
    except Exception:  # noqa: BLE001 — a stats miss must never fail dispatch
        return 0


def choose_statement_tier(dag, *, allow_mpp: bool, allow_mesh: bool,
                          columnar_routed, n_devices: int) -> TierDecision:
    """Statement-level tier pick ABOVE execute_root's per-request tiers
    (port of tidb_tpu/distsql/planner.py choose_statement_tier; ref:
    mpp_gather.go:40 useMPPExecution). Returns:

      "mpp"   plan the statement as an exchange-linked fragment graph
              (mpp/dispatch.py try_mpp_select: the fragment plan through
              the wire frames, the probe scan through select, the exchange
              program); when it declines, the mesh select runs next.
      "mesh"  the whole-plan mesh select (parallel/sql.try_mesh_select).
      "root"  no statement-level shortcut: execute_root owns dispatch.

    `n_devices` is the store's mesh width (the reference reads
    jax.devices()). `columnar_routed` is a thunk, evaluated only when a
    shortcut is on the table."""
    if not allow_mesh or n_devices < 2:
        return TierDecision("root")
    from ..parallel.sql import mesh_eligible

    kind = mesh_eligible(dag)
    if kind is None:
        return TierDecision("root")
    if allow_mpp and kind == "join":
        # shuffle joins are the mpp tier's: engine routing must not preempt
        # the statement
        return TierDecision("mpp", kind)
    if columnar_routed():
        return TierDecision("root")
    return TierDecision("mpp" if allow_mpp else "mesh", kind)


def choose_tier(store, req, tasks) -> TierDecision:
    """One tier per request: paging and single-task requests stay on the
    per-task path; eligible partial-agg / TopN shapes with >= 2 devices
    and enough data take the mesh tier; batch_cop requests the batched
    store tier; everything else the pool."""
    n = len(tasks)
    if n <= 1 or req.paging_size is not None:
        return TierDecision("pool" if (req.concurrency > 1 and n > 1) else "single")
    if req.mesh is not False:
        kind = mesh_merge_kind(req.dag)
        if (
            kind is not None
            and _n_devices(store) >= 2
            and estimated_rows(store) >= (req.mesh_min_rows or 0)
        ):
            return TierDecision("mesh", kind)
    if req.batch_cop:
        return TierDecision("batch")
    return TierDecision("pool" if req.concurrency > 1 else "single")
