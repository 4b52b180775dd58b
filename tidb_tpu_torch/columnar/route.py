"""Engine routing for the columnar replica (ref: TiDB's
`tidb_isolation_read_engines` + planner engine selection — `kv.StoreType
{TiKV, TiFlash}` picking which store kind may serve each read;
planner/core/find_best_task.go's isolation-read engine filter).

`execute_root` consults this module before splitting a plan for the row
store: when the session's engine list includes `columnar` and the plan is
an ELIGIBLE analytical shape, the whole logical DAG runs over the
replica's device-resident column chunks instead of dispatching per-region
cop tasks — one program over all rows, no rowcodec, no region fan-out.

Eligibility (the TiFlash routing rules, scaled to this engine):
  * the probe is a TABLE scan (index scans/lookups describe row-store
    access paths), every range parses to exact handle bounds, and every
    physical table the ranges touch is replicated with a matching schema
  * the plan is analytical: an Aggregation or TopN appears in the DAG
    (point gets never reach execute_root; plain row-local scans stay on
    the row store, which answers them from its caches)
  * in-txn reads and EXPLAIN ANALYZE runs never route (the session strips
    `columnar` from the engine list for those)

Staleness: a scan at `start_ts` needs the replica frontier to cover it
(`applied_ts >= start_ts`) and compaction not to have folded past it
(`stable_ts <= start_ts`). A lagging frontier answers the typed
DataIsNotReady shape: one wait on the `data_not_ready` backoff budget
(the replication budget — a background tick may advance the frontier),
one re-check, then a counted fallback to the row store. Never a torn
prefix.

Port of `tidb_tpu/columnar/route.py` (imports rewritten; it imports
nothing of tidb_tpu). What differs: the overlay path's
`run_dag_on_chunks` runs on the store's device (`device=store.device`),
where the reference's takes its default device."""

from __future__ import annotations

from ..codec import tablecodec
from .replica import I64_MAX, I64_MIN, ColumnarNotReady, _schema_sig

_ROW_KEY_LEN = 1 + 8 + 2 + 8  # 't' + tid + '_r' + handle


def _range_handles(kr) -> tuple | None:
    """KeyRange -> (pid, lo, hi) INCLUSIVE handle bounds, or None when the
    bytes are not exact row-key bounds (index keyspace, partial prefixes —
    anything ambiguous declines to the row store, never guesses)."""
    start, end = kr.start, kr.end
    if len(start) != _ROW_KEY_LEN:
        return None
    try:
        pid, lo = tablecodec.decode_row_key(start)
    except ValueError:
        return None
    if len(end) == _ROW_KEY_LEN:
        try:
            pid2, h = tablecodec.decode_row_key(end)
        except ValueError:
            return None
        if pid2 != pid or h == I64_MIN:
            return None
        hi = h - 1
    elif len(end) == _ROW_KEY_LEN + 1 and end[-1:] == b"\x00":
        try:
            pid2, hi = tablecodec.decode_row_key(end[:-1])
        except ValueError:
            return None
        if pid2 != pid:
            return None
    else:
        return None
    return pid, lo, hi


def _plan_intervals(dag, ranges) -> dict | None:
    """ranges -> {pid: [(lo, hi)]} in first-seen pid order, or None when
    any range is not an exact row-key interval."""
    out: dict = {}
    for kr in ranges:
        hit = _range_handles(kr)
        if hit is None:
            return None
        pid, lo, hi = hit
        out.setdefault(pid, []).append((lo, hi))
    return out


def _analytical(dag) -> bool:
    from ..exec.dag import Aggregation, TableScan, TopN

    if not isinstance(dag.executors[0], TableScan):
        return False
    return any(isinstance(e, (Aggregation, TopN)) for e in dag.executors)


def columnar_would_serve(store, dag, ranges, engines) -> bool:
    """Cheap routing predicate (no execution, no waiting): is this plan
    the columnar replica's to serve? The session uses it to keep the
    whole-plan mesh shortcut from preempting engine routing; readiness is
    NOT checked here — a lagging frontier is `try_columnar_select`'s
    fallback decision, made at execution time."""
    if "columnar" not in engines:
        return False
    rep = getattr(store, "columnar", None)
    if rep is None or not rep.has_tables() or not _analytical(dag):
        return False
    plan = _plan_intervals(dag, ranges)
    if not plan:
        return False
    sig = _schema_sig(dag.scan().columns)
    return all(
        (t := rep.table_for(pid)) is not None and t.schema_sig == sig
        for pid in plan
    )


def try_columnar_select(store, dag, ranges, start_ts: int, aux_chunks: list,
                        cache=None, group_capacity: int | None = None,
                        small_groups: int | None = None,
                        backoff_weight: int = 2, checker=None):
    """Serve the whole logical DAG from the columnar replica. Returns the
    result Chunk, or None when the plan is not the replica's to serve
    (ineligible shape / unreplicated table) or the frontier could not
    cover the snapshot after one data_not_ready wait (a counted fallback —
    the caller dispatches to the row store as if routing never happened)."""
    from ..exec.builder import DEFAULT_GROUP_CAPACITY
    from ..util import metrics, tracing

    rep = getattr(store, "columnar", None)
    if rep is None or not rep.has_tables() or not _analytical(dag):
        return None
    plan = _plan_intervals(dag, ranges)
    if not plan:
        return None
    sig = _schema_sig(dag.scan().columns)
    tables = []
    for pid in plan:
        t = rep.table_for(pid)
        if t is None:
            return None  # an unreplicated physical table: not ours
        if t.schema_sig != sig:
            # schema drift (a mid-feed ALTER parked the feed): the replica
            # holds the OLD shape — this is a routed-then-declined read
            metrics.COLUMNAR_FALLBACKS.inc()
            return None
        tables.append(t)
    ts_eff = _wait_ready(store, tables, start_ts, backoff_weight, checker)
    if ts_eff is None:
        metrics.COLUMNAR_FALLBACKS.inc()
        return None
    group_capacity = group_capacity or DEFAULT_GROUP_CAPACITY
    with tracing.span("columnar.scan", table=tables[0].name,
                      start_ts=start_ts, snapshot_ts=ts_eff,
                      pids=len(tables)) as sp:
        try:
            out = _run(store, dag, plan, tables, ts_eff, aux_chunks,
                       cache, group_capacity, small_groups)
        except ColumnarNotReady:
            # a compaction advanced the floor between the gate and the
            # scan: fall back rather than serve a torn snapshot
            metrics.COLUMNAR_FALLBACKS.inc()
            return None
        except Exception:  # noqa: BLE001 — degrade, never fail the query:
            # the row store still owns the authoritative answer
            metrics.COLUMNAR_FALLBACKS.inc()
            return None
        if sp is not None:
            sp.set("rows", out.num_rows())
    metrics.COLUMNAR_SCANS.inc()
    return out


def _wait_ready(store, tables, start_ts: int, backoff_weight: int, checker):
    """The staleness gate. Returns the snapshot the replica serves at —
    `min(start_ts, applied_ts)` — or None for a counted row-store
    fallback. The served snapshot is provably EQUIVALENT to `start_ts`:
    it is either `start_ts` itself (the frontier covers it), or the
    frontier with `applied_ts >= kv.max_committed()` proven under a
    quiescent WriteGuard double-sample — no commit exists (or is in
    flight) in `(applied_ts, start_ts]`, so the two snapshots see
    identical data. A frontier trailing a real commit answers the
    DataIsNotReady shape: one wait on the replication error's
    data_not_ready budget (a background pd tick may advance the
    frontier under us), one re-check, then None. A snapshot OLDER than
    the compaction floor (a stale read whose overwritten versions were
    folded away) can never become servable and returns None fast."""
    from ..util.backoff import Backoffer, BackoffExhausted

    def gate():
        applied = min(t.frontier()[0] for t in tables)
        floor = max(t.frontier()[1] for t in tables)
        if applied >= start_ts:
            return start_ts if start_ts >= floor else None
        # frontier behind the snapshot: serving at `applied` is only
        # equivalent when NO commit exists in (applied, start_ts] — and
        # comparing against kv.max_committed alone cannot prove that: a
        # writer inside its [commit-ts draw .. apply] window has a ts
        # drawn but nothing in kv yet. The CDC
        # WriteGuard's quiescent double-sample closes exactly that
        # window (hub._safe_candidate's proof): no write in flight
        # across the max_committed read and none completed between the
        # samples means every drawn commit ts is applied and <=
        # max_committed <= applied; any later writer draws > start_ts.
        guard = getattr(store.cdc, "guard", None)
        if guard is None:
            return None
        inflight, seq = guard.sample()
        if inflight:
            return None
        top = store.kv.max_committed()
        inflight2, seq2 = guard.sample()
        if applied >= top and inflight2 == 0 and seq2 == seq:
            return applied if applied >= floor else None
        return None

    ts = gate()
    if ts is not None:
        return ts
    if start_ts < max(t.frontier()[1] for t in tables):
        # below the compaction floor: floors only advance, so waiting
        # can never make this snapshot servable — fail fast
        return None
    applied = min(t.frontier()[0] for t in tables)
    boff = Backoffer(weight=backoff_weight, checker=checker)
    try:
        boff.backoff(
            "data_not_ready",
            f"columnar data_is_not_ready: applied_ts={applied} start_ts={start_ts}")
    except BackoffExhausted:
        return None
    return gate()


def _run(store, dag, plan: dict, tables: list, start_ts: int, aux_chunks,
         cache, group_capacity: int, small_groups):
    """Execute the DAG over the replica's chunks. Single-table full scans
    with a folded delta ride the DEVICE-RESIDENT stable batch straight
    into the fused program (zero upload, zero decode); everything else
    merges the delta overlay on the host and takes the standard
    chunk-execution path (spill + oracle fallbacks included)."""
    from ..chunk import Chunk
    from ..exec.executor import (
        OverflowRetryError,
        drive_program_info,
        run_dag_on_chunks,
    )

    scans = []
    for pid, t in zip(plan, tables):
        scans.append(t.scan(start_ts, plan[pid]))
    if len(scans) == 1 and scans[0][1] is not None:
        batch = scans[0][1]
        try:
            batches = [batch] + [store._aux_batch(c) for c in aux_chunks]
            chunk, _rows, _info = drive_program_info(
                store.programs, dag, batches, group_capacity,
                small_groups=small_groups)
            return chunk
        except (OverflowRetryError, NotImplementedError):
            pass  # the chunk path below owns the retry/oracle ladder
    merged = scans[0][0] if len(scans) == 1 else Chunk.concat([c for c, _b in scans])
    return run_dag_on_chunks(dag, [merged] + list(aux_chunks),
                             cache=cache or store.programs,
                             group_capacity=group_capacity,
                             small_groups=small_groups, device=store.device)
