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
  mesh    the reference shards a batch over the device mesh and merges
          the regions' partial states on the devices. The port has no
          mesh tier yet: a mesh request is grouped as a batch is, and the
          store serves it in its batched tier, as the reference's store
          does when its mesh tier declines.

`choose_statement_tier` answers the SQL session's statement-level
question above execute_root. The reference picks its MPP or whole-statement
mesh tier there on two or more devices; the port has neither (the parallel
and mpp packages are not ported), so every statement takes the "root"
tier, which is where the reference lands when both decline. The device
count comes from torch.cuda.
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


def _n_devices() -> int:
    import torch

    return torch.cuda.device_count()


def estimated_rows(store) -> int:
    """Coarse data-size signal for the tier decision: the store's live key
    count. It only gates the mesh attempt."""
    try:
        return len(store.kv)
    except Exception:  # noqa: BLE001 — a stats miss must never fail dispatch
        return 0


def choose_statement_tier(dag, *, allow_mpp: bool, allow_mesh: bool,
                          columnar_routed) -> TierDecision:
    """Statement-level tier pick above execute_root's per-request tiers
    (port of tidb_tpu/distsql/planner.py choose_statement_tier). Below two
    devices, or with the mesh switched off, the reference answers "root";
    on more devices it asks its mesh shape gate (parallel/sql.py
    mesh_eligible) for an "mpp" or "mesh" tier, whose selects the port
    does not have, so the port answers "root" on any device count:
    execute_root owns dispatch. The arguments keep the reference's
    signature."""
    return TierDecision("root")


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
            and _n_devices() >= 2
            and estimated_rows(store) >= (req.mesh_min_rows or 0)
        ):
            return TierDecision("mesh", kind)
    if req.batch_cop:
        return TierDecision("batch")
    return TierDecision("pool" if req.concurrency > 1 else "single")
