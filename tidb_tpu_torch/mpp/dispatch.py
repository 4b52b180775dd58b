"""MPP dispatch (port of tidb_tpu/mpp/dispatch.py; ref:
pkg/executor/mpp_gather.go MPPGather + store/copr/mpp.go DispatchMPPTask).

`try_mpp_select` is the MPP statement tier: it cuts an eligible DAG into
fragments (`fragment_plan`), round-trips the fragment plan through the
wire codec's fragment frames (the executed plan is the DECODED one, the
seam a real coordinator ships across the network), sources the probe-side
scan, and launches the exchange program. The probe scan comes from the
columnar replica's stable chunks when the replica covers the snapshot
(`_replica_probe_chunks`: columnar_would_serve and the data_not_ready
readiness gate; the span's `replica_served` says which), else from the
row store's scan pushdown through
distsql.dispatch.select, whose typed region errors and epoch fall-out are
the per-region path's. Every decline is a counted fallback
(`MPP_FALLBACKS`), and the session's next tier (the mesh select) runs as
if routing never happened. The task count is the store's mesh width,
`len(store.mesh_devices)`, where the reference reads jax.devices().

Failpoints:
  mpp/dispatch-lost   a task dispatch is lost before launch — counted
                      fallback to the non-MPP tiers.
  mpp/exchange-stall  an exchange never delivers mid-run — the
                      coordinator abandons the run (counted fallback).

`execute_exchange_plan` is the execution core this tier shares with the
mesh select (parallel/sql.py): the chunks play the task lanes (stacked and
padded to a multiple of the mesh width), each join's build table is sliced
over the shards so each slice plays a region shard, and an overflow
retries on a 3-rung capacity ladder that reuses the scanned chunks.
"""

from __future__ import annotations

from ..chunk import Chunk
from ..exec.dag import DAGRequest
from .fragment import chunks_exchange_safe, fragment_kind, fragment_plan

MPP_SYSVAR = "tidb_allow_mpp"

# (encoded dag, n devices, base group capacity) -> the last successful
# (gc, scale) ladder rung; a bounded FIFO, see execute_exchange_plan
_LADDER_HINTS: dict[tuple, tuple[int, int]] = {}


def execute_exchange_plan(dag, chunks, aux_chunks, kind, devs, group_capacity: int = 1024) -> Chunk | None:
    """Launch the exchange program over the scanned chunks, on the mesh of
    `devs` (a list of devices, one shard each; the lead holds the stacked
    input). Overflow (too many groups, a full exchange bucket, join
    fan-out) retries with 4x capacity — the capacity also salts the group
    hash — reusing the scanned chunks. Returns the projected result Chunk,
    or None for a fallback to the per-region path."""
    from ..parallel.grouped import run_sharded_grouped_agg
    from ..parallel.mesh import region_mesh, stack_region_batches
    from ..util import metrics

    agg = dag.executors[-1]
    out_fts = agg.output_fts()
    if not chunks:
        # zero rows scanned: grouped aggregation of nothing is no groups
        return Chunk.empty([out_fts[i] for i in dag.output_offsets])
    if not chunks_exchange_safe(chunks):
        return None  # wide strings cannot ride the exchange byte-exactly

    n = len(devs)
    mesh = region_mesh(devs)
    n_total = ((len(chunks) + n - 1) // n) * n
    try:
        stacked = stack_region_batches(chunks, n_total=n_total, device=mesh.lead)
    except NotImplementedError:
        return None  # e.g. non-ASCII CI data: the per-region path's oracle owns it

    stacked_builds = None
    if kind == "join":
        from .fragment import split_join_dag

        n_stages = len(split_join_dag(dag)[2])
        if aux_chunks is None or len(aux_chunks) < n_stages:
            return None
        stacked_builds = []
        for build in aux_chunks[:n_stages]:
            if not chunks_exchange_safe([build]):
                return None
            if build.num_rows() == 0:
                bslices = [build]
            else:
                step = (build.num_rows() + n - 1) // n
                bslices = [build.slice(i * step, min((i + 1) * step, build.num_rows()))
                           for i in range(n) if i * step < build.num_rows()]
            try:
                stacked_builds.append(stack_region_batches(bslices, n_total=n, device=mesh.lead))
            except NotImplementedError:
                return None

    # the ladder's start rung is remembered per plan identity: a repeated
    # digest starts at the rung that last succeeded. The rung salts the
    # hash, so the hint changes the output order: it is keyed as the
    # reference keys it.
    from ..codec.wire import encode_dag

    hint_key = (encode_dag(dag), n, group_capacity)
    gc, scale = _LADDER_HINTS.get(hint_key, (group_capacity, 1))
    for _ in range(3):
        try:
            if kind == "join":
                from .exchange_op import run_exchange_join_agg

                chunk, overflow = run_exchange_join_agg(dag, stacked, stacked_builds, mesh, group_capacity=gc,
                                                        scale=scale)
            else:
                chunk, overflow = run_sharded_grouped_agg(dag, stacked, mesh, group_capacity=gc)
        except NotImplementedError:
            # an op the device compiler refuses slipped past the static
            # gate: the per-region path keeps host-only work at root
            return None
        if not overflow:
            if len(_LADDER_HINTS) >= 256:
                _LADDER_HINTS.pop(next(iter(_LADDER_HINTS)))
            _LADDER_HINTS[hint_key] = (gc, scale)
            metrics.MESH_SELECTS.inc()
            return Chunk([chunk.columns[i] for i in dag.output_offsets])
        # one overflow flag covers groups, exchange buckets and join
        # fan-out: the middle rung grows scale alone, the last both
        if scale >= 4:
            gc *= 4
        scale *= 4
    return None  # the caller falls back to the per-region path


def ladder_rung(dag, n_devices: int, group_capacity: int) -> tuple[int, int] | None:
    """The (group capacity, scale) rung the last successful run of this
    plan ended on, or None before its first."""
    from ..codec.wire import encode_dag

    return _LADDER_HINTS.get((encode_dag(dag), n_devices, group_capacity))


def _chunks_nbytes(chunks) -> int:
    return sum(int(c.nbytes()) for c in chunks if c is not None)


def _replica_probe_chunks(store, dag, ranges, start_ts, n_lanes, engines, backoff_weight, checker):
    """Source the probe scan from the columnar replica's stable chunks,
    sliced into n_lanes task shards. Returns a chunk list, or None when
    the replica does not cover the snapshot (the row-store scan pushdown
    is the fallback source — not a query failure)."""
    from ..columnar.replica import ColumnarNotReady, _schema_sig
    from ..columnar.route import _plan_intervals, _wait_ready, columnar_would_serve
    from ..util import metrics

    # the probe fragment's scan is the bare TableScan — the mpp eligibility
    # gate already proved the analytical shape, so would-serve is asked on
    # the FULL dag (Aggregation present) with the probe's ranges
    if not columnar_would_serve(store, dag, ranges, engines):
        return None
    plan = _plan_intervals(dag, ranges)
    if not plan:
        return None
    sig = _schema_sig(dag.scan().columns)
    tables = [store.columnar.table_for(pid) for pid in plan]
    if any(t is None or t.schema_sig != sig for t in tables):
        return None
    ts_eff = _wait_ready(store, tables, start_ts, backoff_weight, checker)
    if ts_eff is None:
        metrics.COLUMNAR_FALLBACKS.inc()
        return None
    try:
        scans = [t.scan(ts_eff, plan[pid]) for pid, t in zip(plan, tables)]
    except ColumnarNotReady:
        # a compaction advanced the floor between the gate and the scan
        metrics.COLUMNAR_FALLBACKS.inc()
        return None
    except Exception:  # noqa: BLE001 — degrade, never fail: the row
        # store still owns the authoritative answer
        metrics.COLUMNAR_FALLBACKS.inc()
        return None
    merged = scans[0][0] if len(scans) == 1 else Chunk.concat([c for c, _b in scans])
    rows = merged.num_rows()
    if rows == 0:
        return []
    step = (rows + n_lanes - 1) // n_lanes
    return [merged.slice(i * step, min((i + 1) * step, rows)) for i in range(n_lanes) if i * step < rows]


def try_mpp_select(store, dag: DAGRequest, ranges: list, start_ts: int, *, group_capacity: int = 1024,
                   min_devices: int = 2, aux_chunks: list | None = None, engines: tuple = (),
                   backoff_weight: int = 2, checker=None) -> Chunk | None:
    """Plan and run an eligible DAG as an MPP fragment graph on the store's
    mesh devices; None = not taken (a counted fallback where the run was
    abandoned — the caller dispatches to the mesh select / per-region
    tiers as if MPP routing never happened). `backoff_weight` and
    `checker` bound the columnar replica's readiness wait."""
    kind = fragment_kind(dag)
    if kind is None:
        return None
    if kind == "join" and not aux_chunks:
        return None
    devs = list(store.mesh_devices)
    if len(devs) < min_devices:
        return None
    fplan = fragment_plan(dag, n_tasks=len(devs))
    if fplan is None:
        return None
    from ..codec.wire import decode_fragment_plan, encode_fragment_plan
    from ..util import failpoint, metrics, tracing

    # the wire seam: a real coordinator ships each fragment inside a
    # DispatchMPPTaskRequest — round-trip the topology through the codec
    # so the EXECUTED plan is the decoded one, byte-exact
    fplan = decode_fragment_plan(encode_fragment_plan(fplan))
    if failpoint.eval("mpp/dispatch-lost"):
        # a task dispatch was lost before launch: abandon the MPP run
        metrics.MPP_FALLBACKS.inc()
        return None
    with tracing.span("mpp.dispatch", kind=kind, n_fragments=len(fplan.fragments), n_tasks=fplan.n_tasks,
                      n_ranges=len(ranges)) as sp:
        chunks = _replica_probe_chunks(store, dag, ranges, start_ts, len(devs), engines, backoff_weight, checker)
        replica_served = chunks is not None
        if chunks is None:
            # row-store scan pushdown (paging / retry, typed region errors
            # and epoch fall-out preserved — a mid-query split raises the
            # same typed shape the per-region path does)
            from ..distsql.dispatch import KVRequest, select

            scan = dag.executors[0]
            scan_dag = DAGRequest((scan,), output_offsets=tuple(range(len(scan.columns))))
            res = select(store, KVRequest(scan_dag, ranges, start_ts))
            chunks = [c for c in res.chunks if c is not None and c.num_rows() > 0]
        if failpoint.eval("mpp/exchange-stall"):
            # an exchange never delivered mid-run: abandon the MPP run
            metrics.MPP_FALLBACKS.inc()
            return None
        out = execute_exchange_plan(dag, chunks, aux_chunks, kind, devs, group_capacity=group_capacity)
        if out is None:
            metrics.MPP_FALLBACKS.inc()
            return None
        metrics.MPP_SELECTS.inc()
        metrics.MPP_FRAGMENTS.inc(len(fplan.fragments))
        metrics.MPP_TASKS.inc(len(fplan.fragments) * fplan.n_tasks)
        metrics.MPP_EXCHANGED_BYTES.inc(_chunks_nbytes(chunks) + _chunks_nbytes(aux_chunks or []))
        if sp is not None:
            sp.set("rows", out.num_rows())
            sp.set("replica_served", replica_served)
        return out
