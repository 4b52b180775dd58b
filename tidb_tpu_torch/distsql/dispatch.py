"""DistSQL dispatch: split a request into per-region cop tasks, send, merge
(ref: pkg/distsql/distsql.go:56 Select + RequestBuilder request_builder.go:56;
task split copr/coprocessor.go:331 buildCopTasks; retry-on-region-error
coprocessor.go:1424).

Concurrency mirrors `tidb_distsql_scan_concurrency` (sysvar.go:1956) with a
thread pool. The port of tidb_tpu/distsql/dispatch.py over the port's store:
every pool thread enqueues its region's program on its current CUDA stream,
which is the legacy default stream for every thread that has not chosen
another, so the device work of the threads serializes on one stream (the
hand kernels keep their scratch per (device, stream) and rely on that),
while region decode, upload and host encode overlap.

The store's control plane is the reference's: the replica selector reads
each store's read load from `store.replication`, a follower read that its
peer's safe_ts does not cover answers DataIsNotReady and retries on the
leader, and a region whose leader store is down fails over through
`store.pd` (a leader transfer among the live peers, or a placement move
when quorum is lost); only when nothing can serve does dispatch back off
on the store_unavailable budget and raise RegionUnavailableError.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .. import topsql
from ..chunk import Chunk
from ..codec import tablecodec
from ..exec.dag import DAGRequest
from ..store import CopRequest, KeyRange, TPUStore

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1
MAX_RETRY = 8


class RegionUnavailableError(RuntimeError):
    """Every retry budget for a region is spent — MySQL error 9005
    "Region is unavailable" (ref: tidb errno.ErrRegionUnavailable; raised
    when client-go's Backoffer times out on region errors)."""


class CopInternalError(RuntimeError):
    """The coprocessor answered `other_error` — a non-retryable execution
    failure, MySQL error 1105 (ref: copr handleCopResponse returning
    errors.Errorf for OtherError)."""


# ------------------------------------------------------------ circuit breaker

class CircuitBreaker:
    """Per-store breaker (ref: client-go's store slow-score / liveness
    state machine, and the classic closed -> open -> half-open breaker).
    N consecutive failures open it; an open breaker rejects requests (the
    dispatch layer fails the store's tasks over through a PD re-placement
    instead of paying the timeout again); after `probe_after` seconds one
    probe request is let through — success closes, failure re-opens."""

    __slots__ = ("store_id", "state", "fails", "opened_at", "last_probe",
                 "threshold", "probe_after", "_now", "_lock")

    def __init__(self, store_id: int, threshold: int = 3,
                 probe_after: float = 0.05, now_fn=time.monotonic):
        self.store_id = store_id
        self.state = "closed"  # guarded_by: _lock
        self.fails = 0  # guarded_by: _lock
        self.opened_at = 0.0  # guarded_by: _lock
        self.last_probe = 0.0  # guarded_by: _lock
        self.threshold = threshold
        self.probe_after = probe_after
        self._now = now_fn
        self._lock = threading.Lock()

    def _gauge(self):  # requires: _lock
        from ..util import metrics

        metrics.BREAKER_STATE.labels(str(self.store_id)).set(
            {"closed": 0, "half-open": 1, "open": 2}[self.state])

    def allow_request(self) -> bool:
        """The probe admission is RATE-LIMITED, not a single token: a
        probe whose outcome never reaches record_success/record_failure
        (the request died on an unrelated error, the task re-split away,
        the statement was killed mid-probe) must not wedge the breaker —
        the next window simply admits another probe."""
        now = self._now()
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if now - self.opened_at < self.probe_after:
                    return False
                self.state = "half-open"  # time served: admit a probe
            elif now - self.last_probe < self.probe_after:
                return False  # a probe was admitted this window
            self.last_probe = now
            self._gauge()
            return True

    def record_success(self) -> None:
        with self._lock:
            changed = self.state != "closed" or self.fails
            self.state, self.fails = "closed", 0
            if changed:
                self._gauge()

    def state_view(self) -> str:
        """Locked state snapshot — the board's views read THROUGH this
        (vet finding: they used to read `b.state` under the board lock
        only, racing every transition made under the breaker's own)."""
        with self._lock:
            return self.state

    def probe_ready(self) -> bool:
        """Non-consuming routability check: closed, or an open/half-open
        breaker whose probe window has arrived. The replica selector
        avoids stores that return False (no point grouping lanes onto a
        tripped follower) but MUST keep offering ones that return True —
        otherwise a follower nobody routes to can never half-open-probe
        back closed (allow_request still gates the actual admission)."""
        now = self._now()
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return now - self.opened_at >= self.probe_after
            return now - self.last_probe >= self.probe_after

    def record_failure(self) -> bool:
        """Returns True when THIS failure opened (or re-opened) the
        breaker — the caller's cue to fail the task over."""
        from ..util import metrics

        with self._lock:
            self.fails += 1
            if self.state == "half-open" or (
                self.state == "closed" and self.fails >= self.threshold
            ):
                self.state, self.opened_at = "open", self._now()
                metrics.BREAKER_TRIPS.labels(str(self.store_id)).inc()
                self._gauge()
                return True
            return self.state == "open"


class BreakerBoard:
    """All of a TPUStore's per-store breakers (client-side shared state:
    every session and dispatch thread on the store consults one board)."""

    def __init__(self, threshold: int = 3, probe_after: float = 0.05,
                 now_fn=time.monotonic):
        self.threshold = threshold
        self.probe_after = probe_after
        self._now = now_fn
        self._breakers: dict[int, CircuitBreaker] = {}  # guarded_by: _lock
        self._lock = threading.Lock()

    def get(self, store_id: int) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(store_id)
            if b is None:
                b = self._breakers[store_id] = CircuitBreaker(
                    store_id, self.threshold, self.probe_after, self._now)
            return b

    def allow_request(self, store_id: int) -> bool:
        return self.get(store_id).allow_request()

    def record_success(self, store_id: int) -> None:
        self.get(store_id).record_success()

    def record_failure(self, store_id: int) -> bool:
        return self.get(store_id).record_failure()

    def _snapshot(self) -> list:
        with self._lock:
            return list(self._breakers.items())

    def open_stores(self) -> set:
        # per-breaker states are read under each breaker's own lock, with
        # the board lock already released (board -> breaker never nests)
        return {sid for sid, b in self._snapshot() if b.state_view() == "open"}

    def unroutable_stores(self) -> set:
        """Stores the replica selector should route around right now:
        tripped breakers still inside their probe-silence window."""
        return {sid for sid, b in self._snapshot() if not b.probe_ready()}

    def states(self) -> dict:
        return {sid: b.state_view() for sid, b in self._snapshot()}

    def all_closed(self) -> bool:
        return all(b.state_view() == "closed" for sid, b in self._snapshot())


def full_table_ranges(table_id: int) -> list[KeyRange]:
    start = tablecodec.encode_row_key(table_id, I64_MIN)
    end = tablecodec.encode_row_key(table_id, I64_MAX) + b"\x00"
    return [KeyRange(start, end)]


def handle_ranges(table_id: int, pairs: list[tuple[int, int]]) -> list[KeyRange]:
    """[lo, hi] handle intervals -> key ranges (ref: ranger -> kv ranges)."""
    out = []
    for lo, hi in pairs:
        out.append(KeyRange(tablecodec.encode_row_key(table_id, lo), tablecodec.encode_row_key(table_id, hi) + b"\x00"))
    return out


@dataclass
class KVRequest:
    """(ref: kv.Request kv.go:528 — the slice the executor hands to distsql).

    aux_chunks: join build-side operands broadcast to every region task
    (resolved by the root executor from prior scans; ref: TiFlash broadcast
    join, mpp_exec.go:669)."""

    dag: DAGRequest
    ranges: list
    start_ts: int
    concurrency: int = 4
    keep_order: bool = False
    aux_chunks: list = field(default_factory=list)
    paging_size: int | None = None  # per-page row budget (ref: kv.Request Paging)
    use_wire: bool = False  # route every cop request through the serialized
    # bytes seam (coprocessor_bytes) instead of in-process objects
    batch_cop: bool = False  # group region tasks per store/chip into one
    # worker's batch (ref: copr/batch_coprocessor.go — all regions of a
    # TiFlash store travel in one request)
    small_groups: int | None = None  # planner NDV hint -> dense agg kernel
    checker: object = None  # RunawayChecker — before_cop_request() raises
    # past the deadline / after KILL (ref: resourcegroup checker.go:27)
    backoff_weight: int = 2  # tidb_backoff_weight: scales every retry
    # budget (ref: sessionctx BackOffWeight -> copr backoffer construction)
    replica_read: str = "leader"  # tidb_replica_read: leader / follower /
    # closest-replica — which peer of each region serves the cop task
    # (ref: sessionctx ReplicaRead -> kvrpcpb.Context.replica_read)
    mesh: bool | None = None  # mesh dispatch tier (tidb_enable_tpu_mesh):
    # None/True lets the planner pick the mesh tier for eligible
    # partial-agg/TopN shapes on >= 2 devices (the port's store serves it
    # as its batched tier); False pins the request to the batch/pool
    # tiers (distsql/planner.py)
    mesh_min_rows: int = 0  # tidb_tpu_mesh_min_rows: data-size floor the
    # planner applies before attempting the mesh tier


@dataclass
class CopTask:
    region_id: int
    epoch: int
    ranges: list


@dataclass
class SelectResult:
    """(ref: distsql.SelectResult select_result.go:63).

    exec_summaries: one entry per cop response, flattened in TASK order
    (deterministic across runs — pool completion order never leaks into
    EXPLAIN ANALYZE attribution, honoring keep_order). batch_stats carries
    the batched-dispatch attribution ({"batches","regions","launches_saved"})
    when the batch-cop path ran, for EXPLAIN ANALYZE / TRACE surfacing."""

    chunks: list
    exec_summaries: list = field(default_factory=list)
    batch_stats: dict | None = None

    def merged(self) -> Chunk:
        return Chunk.concat(self.chunks) if self.chunks else None


def _build_tasks(store: TPUStore, ranges: list) -> list[CopTask]:
    tasks = []
    for rng in ranges:
        for region in store.cluster.regions_in_range(rng.start, rng.end):
            start = max(rng.start, region.start_key)
            end = min(rng.end, region.end_key)
            if start < end:
                tasks.append(CopTask(region.region_id, region.epoch, [KeyRange(start, end)]))
    # merge tasks per region (ref: buildCopTasks per-region aggregation)
    by_region: dict[int, CopTask] = {}
    ordered = []
    for t in tasks:
        ex = by_region.get(t.region_id)
        if ex is None:
            by_region[t.region_id] = t
            ordered.append(t)
        else:
            ex.ranges.extend(t.ranges)
    return ordered


def select_stream(store: TPUStore, req: KVRequest):
    """Sequential per-task chunk generator — the bounded-memory dispatch
    the degraded OOM path uses (one region's result live at a time;
    ref: copr worker pool degraded to a single in-order worker).

    The mesh tier applies here too (the planner's call): eligible
    partial-agg shapes run one store batch at a time (merged across the
    store's mesh devices), and the stream yields that batch's chunks —
    still bounded by one store's stacked batch. The low-memory degrade path
    pins `mesh=False` and keeps the strict one-region-at-a-time shape."""
    from .planner import choose_tier

    scan_kind = _scan_kind(req)
    with _admission_guard(store):
        pass  # saturation answered before any task is built
    tasks = _build_tasks(store, req.ranges)
    if choose_tier(store, req, tasks).tier == "mesh":
        results: list = [None] * len(tasks)
        summaries_by_task: list = [[] for _ in tasks]
        ctx = _route_ctx(store) if req.replica_read != "leader" else None
        by_store: dict[int, list] = {}
        for i, t in enumerate(tasks):
            by_store.setdefault(_route_task(store, req, t, ctx=ctx),
                                []).append((i, t))
        for sid, entries in by_store.items():
            _run_store_batch(store, req, sid, entries, results,
                             summaries_by_task, None, scan_kind, mesh=True)
            for i, _t in entries:
                for c in results[i] or []:
                    if c is not None:
                        yield c, summaries_by_task[i]
        return
    for task in tasks:
        summaries: list = []
        for c in _run_one_task(store, req, task, summaries, scan_kind=scan_kind):
            if c is not None:
                yield c, summaries


def _scan_kind(req) -> str:
    from ..exec.dag import IndexScan

    return "index" if isinstance(req.dag.scan(), IndexScan) else "table"


def _route_ctx(store) -> tuple:
    """One (bad-store set, read-load map) snapshot for a whole routing
    pass — the batch grouping loop calls _route_task once per lane, and
    these inputs are loop-invariant there (re-snapshotting per lane
    would take the board/down/replica locks O(lanes) times)."""
    return (store.down_stores() | store.breakers.unroutable_stores(),
            store.replication.read_counts())


def _route_task(store, req, task, avoid=frozenset(), leader_only=False,
                ctx=None) -> int:
    """Pick the peer that serves this cop task (ref: client-go's replica
    selector honoring tidb_replica_read). `leader` routes to the leader;
    `follower` prefers the least-read-loaded healthy follower; `closest-
    replica` picks the least-read-loaded healthy peer, leader included
    (the in-process analog of same-AZ proximity: the least-busy chip is
    'closest'). The client does NOT pre-filter on safe_ts — the store's
    gate answers DataIsNotReady and the retry loop falls back to the
    leader, exactly the reference's wire protocol. `ctx` is an optional
    `_route_ctx` snapshot; the retry loop omits it (a retry wants fresh
    health state)."""
    cluster = store.cluster
    leader = cluster.leader_of(task.region_id)
    if leader_only or req.replica_read == "leader":
        return leader
    peers = cluster.peers_of(task.region_id)
    # skip peers the client already knows are sick: down switches AND
    # breakers inside their probe-silence window (else min-by-load keeps
    # re-picking a tripped follower — its frozen read count looks
    # attractively idle — and every batch degrades to the single path).
    # A breaker whose probe window arrived is offered again: someone has
    # to send the half-open probe that re-closes it.
    bad, loads = ctx if ctx is not None else _route_ctx(store)
    healthy = [p for p in peers if p not in avoid and p not in bad]
    if not healthy:
        return leader
    if req.replica_read == "follower":
        followers = [p for p in healthy if p != leader]
        if not followers:
            return leader
        return min(followers, key=lambda p: (loads.get(p, 0), p))
    return min(healthy, key=lambda p: (loads.get(p, 0), p))


def _failover(store, region_id: int, bad_store: int, boff) -> int | None:
    """Ask the PD to fail a region over off its sick LEADER store (ref:
    client-go marking a store unreachable): a leader transfer among the
    live peers, or a re-placement when quorum is lost. When nothing can
    serve (or the transfer timed out), backs off on the
    store_unavailable budget — maybe the store comes back or a breaker
    probe succeeds — and returns None."""
    from ..util.backoff import BackoffExhausted

    pd = getattr(store, "pd", None)
    avoid = store.breakers.open_stores() | store.down_stores()
    target = pd.failover_region(region_id, bad_store, avoid=avoid) if pd else None
    if target is None:
        try:
            boff.backoff("store_unavailable",
                         f"no healthy store for region {region_id}")
        except BackoffExhausted as exc:
            raise RegionUnavailableError(str(exc)) from exc
    return target


def _run_one_task(store, req, task, summaries, retries=MAX_RETRY,
                  dispatch_span=None, scan_kind="table", boff=None):
    """One cop task; drives the paging loop when paging is on (ref:
    copr/coprocessor.go:1393 handleCopPagingResult — each page's lastRange
    seeds the next request until the task drains). Shared by select()'s
    pool workers and the sequential select_stream path so metrics, spans,
    failpoints, wire routing AND the typed error contract cannot drift
    apart. Returns the task's chunks (retry subtasks included); summaries
    accumulate in place.

    Region errors are CLASSIFIED (ref: copr/coprocessor.go:1424
    handleCopResponse): each kind retries on its own Backoffer budget.
    store_unavailable from the LEADER feeds the store's circuit breaker
    and — once the breaker opens — fails the task over via the PD (a
    leader transfer among live peers; placement move only on quorum
    loss); from a FOLLOWER it just routes around the bad replica.
    not_leader with a usable hint switches peers immediately (one shot,
    no backoff); data_not_ready waits once on its own budget, retries
    the follower, then latches the task onto the leader."""
    import time as _time

    from ..store.errors import parse_region_error
    from ..util import failpoint as _fp
    from ..util import metrics, tracing
    from ..util.backoff import Backoffer, BackoffExhausted

    if boff is None:
        # one budget per TASK, shared with its re-split subtasks (the
        # reference allocates one Backoffer per request chain)
        boff = Backoffer(weight=req.backoff_weight, checker=req.checker)
    board = store.breakers
    t_task = _time.monotonic()
    with tracing.span(
        "distsql.cop_task",
        parent=None if tracing.current_span() is not None else dispatch_span,
        region_id=task.region_id, epoch=task.epoch,
    ) as sp:
        out_chunks: list = []
        ranges = task.ranges
        pages = 0
        local_avoid: set = set()  # follower peers this task routes around
        leader_only = False  # DataIsNotReady latch: fall back to the leader
        forced_sid: int | None = None  # NotLeader hint: one-shot target
        hint_used = False
        dnr_waits = 0  # DataIsNotReady waits before the leader fallback
        while True:
            if req.checker is not None:
                req.checker.before_cop_request()
            _fp.eval("distsql.before_task")
            if forced_sid is not None:
                sid, forced_sid = forced_sid, None
            else:
                sid = _route_task(store, req, task, avoid=local_avoid,
                                  leader_only=leader_only)
            leader = store.cluster.leader_of(task.region_id)
            if not board.allow_request(sid):
                if sid != leader:
                    # a sick FOLLOWER never fails the region over — the
                    # leader is fine; just route around the bad replica
                    local_avoid.add(sid)
                    continue
                # leader breaker open: do NOT pay the sick store's failure
                # again — fail over through the PD (leader transfer among
                # live peers, placement move only on quorum loss) or wait
                # for a probe window on the store_unavailable budget
                _failover(store, task.region_id, sid, boff)
                continue
            metrics.DISTSQL_TASKS.inc()
            # authoritative placement lookup (a miss routes through the
            # PD, never a modulo guess) — the per-store counts are what
            # bench.py's skew scenario reads before/after PD balancing
            metrics.DISTSQL_STORE_TASKS.labels(str(sid)).inc()
            creq = CopRequest(
                req.dag, ranges, req.start_ts, task.region_id, task.epoch,
                aux_chunks=req.aux_chunks, paging_size=req.paging_size,
                small_groups=req.small_groups, peer_store=sid,
                replica_read=req.replica_read != "leader" and sid != leader,
            )
            if req.use_wire:
                from ..codec.wire import decode_cop_response, encode_cop_request

                resp = decode_cop_response(store.coprocessor_bytes(encode_cop_request(creq)))
            else:
                resp = store.coprocessor(creq)
            if resp.region_error is not None:
                err = parse_region_error(resp.region_error)
                metrics.DISTSQL_RETRIES.inc()
                metrics.REGION_ERRORS.labels(err.kind).inc()
                if sp is not None:
                    sp.set("region_error", resp.region_error)
                if retries <= 0:
                    raise RegionUnavailableError(
                        f"region retries exhausted: {resp.region_error}")
                try:
                    if err.kind == "store_unavailable":
                        opened = board.record_failure(sid)
                        pd = getattr(store, "pd", None)
                        if pd is not None:
                            pd.note_store_down(sid)
                        if sid != leader:
                            # a dead follower costs a re-route, not a
                            # failover: the leader still serves (client-go
                            # trying the next peer in the selector)
                            local_avoid.add(sid)
                        elif opened:
                            _failover(store, task.region_id, sid, boff)
                        else:
                            boff.backoff("store_unavailable", resp.region_error)
                        continue  # same task, fresh routing decision
                    if err.kind == "server_busy":
                        board.record_failure(sid)
                        boff.backoff("server_busy", resp.region_error,
                                     suggested_ms=getattr(err, "backoff_ms", 0))
                        continue
                    if err.kind == "not_leader":
                        hint = getattr(err, "leader_store", -1)
                        if hint >= 0 and hint != sid and not hint_used:
                            # a usable leader hint: switch peers NOW — one
                            # immediate retry, no backoff round burned
                            # (ref: client-go updating the region cache
                            # from errorpb.NotLeader.leader and retrying)
                            hint_used = True
                            forced_sid = hint
                            continue
                        boff.backoff("not_leader", resp.region_error)
                        hint_used = False  # a fresh hint may follow the election
                        continue
                    if err.kind == "data_not_ready":
                        # the follower's safe_ts trails start_ts: one short
                        # wait and a follower retry (maybe the apply loop
                        # catches up), then the leader serves the rest of
                        # this task (ref: client-go's DataIsNotReady ->
                        # leader fallback on the maxDataNotReady budget)
                        dnr_waits += 1
                        if dnr_waits > 1:
                            leader_only = True
                        else:
                            boff.backoff("data_not_ready", resp.region_error)
                        continue
                    # epoch_not_match / region_not_found / generic miss:
                    # brief backoff, then re-split the REMAINING ranges
                    # against the fresh region view; subtask spans nest
                    # under this one (ambient)
                    boff.backoff(err.kind, resp.region_error)
                except BackoffExhausted as exc:
                    raise RegionUnavailableError(str(exc)) from exc
                for s2 in _build_tasks(store, ranges):
                    out_chunks.extend(_run_one_task(
                        store, req, s2, summaries, retries - 1,
                        scan_kind=scan_kind, boff=boff,
                    ))
                return out_chunks
            if resp.other_error is not None:
                raise CopInternalError(resp.other_error)
            board.record_success(sid)
            pd = getattr(store, "pd", None)
            if pd is not None:
                pd.note_store_up(sid)
            summaries.append(resp.exec_summaries)
            out_chunks.append(resp.chunk)
            pages += 1
            if resp.last_range is None:
                if sp is not None:
                    sp.set("pages", pages)
                    sp.set("rows", sum(c.num_rows() for c in out_chunks if c is not None))
                metrics.DISTSQL_TASK_DURATION.labels(scan_kind).observe(
                    _time.monotonic() - t_task
                )
                return out_chunks
            ranges = resp.last_range


def _run_store_batch(store, req, sid, entries, results, summaries_by_task,
                     dispatch_span, scan_kind, mesh: bool = False) -> dict:
    """ONE batched dispatch for all of a store's region tasks (ref:
    copr/batch_coprocessor.go — a TiFlash store's regions travel in one
    request): the store stacks the regions and runs the region-batched
    program once per capacity bucket. When the planner chose the MESH tier
    (`mesh`) the requests say so, and the store merges the group's partial
    states across its mesh devices (one merged state per store, the rest
    of the lanes empty) or degrades to the batched tier; the contract here
    is identical either way.
    `sid` is the ROUTED target peer (the leader for every lane under
    tidb_replica_read='leader'; a follower group otherwise). A region
    that comes back with a region_error (stale epoch after a concurrent
    split, region folded by a merge, a follower's safe_ts gate) falls out
    of the batch into the standard _run_one_task retry path — the rest of
    the batch's results stand. Returns this batch's attribution stats."""
    import time as _time

    from ..util import failpoint as _fp
    from ..util import metrics, tracing

    if not store.breakers.allow_request(sid):
        # the store's circuit breaker is open: skip the batched dispatch
        # entirely — every lane falls out to the single-task path, which
        # owns the failover-through-PD decision (exactly like stale-epoch
        # lanes, just before the launch instead of after)
        for i, t in entries:
            results[i] = _run_one_task(
                store, req, t, summaries_by_task[i],
                dispatch_span=dispatch_span, scan_kind=scan_kind,
            )
        return {"batches": 0, "regions": 0, "launches_saved": 0,
                "mesh_batches": 0, "mesh_lanes": 0}
    creqs = []
    for i, t in entries:
        if req.checker is not None:
            req.checker.before_cop_request()
        _fp.eval("distsql.before_task")
        metrics.DISTSQL_TASKS.inc()
        metrics.DISTSQL_STORE_TASKS.labels(str(sid)).inc()
        creqs.append(CopRequest(
            req.dag, t.ranges, req.start_ts, t.region_id, t.epoch,
            aux_chunks=req.aux_chunks, small_groups=req.small_groups,
            peer_store=sid,
            replica_read=(req.replica_read != "leader"
                          and sid != store.cluster.leader_of(t.region_id)),
            mesh=mesh, mesh_min_rows=req.mesh_min_rows,
        ))
    t_batch = _time.monotonic()
    stats = {"batches": 0, "regions": 0, "launches_saved": 0,
             "mesh_batches": 0, "mesh_lanes": 0}
    batch_ids: set = set()
    mesh_ids: set = set()
    with tracing.span("distsql.batch_cop", parent=dispatch_span,
                      batch_size=len(entries),
                      tier="mesh" if mesh else "batch") as bsp:
        if req.use_wire:
            from ..codec.wire import decode_batch_cop_response, encode_batch_cop_request

            resps = decode_batch_cop_response(
                store.batch_coprocessor_bytes(encode_batch_cop_request(creqs)))
        else:
            resps = store.batch_coprocessor(creqs)
        served_ok = 0
        for (i, t), resp in zip(entries, resps):
            sums = summaries_by_task[i]
            if resp.region_error is not None:
                from ..store.errors import parse_region_error

                metrics.DISTSQL_RETRIES.inc()
                metrics.REGION_ERRORS.labels(parse_region_error(resp.region_error).kind).inc()
                # faulted lane (stale epoch, folded region, down store):
                # re-split its ranges against the fresh region view and
                # retry ONLY it through the single-task path, which owns
                # classification, backoff, breakers and failover (spans
                # nest under the batch span, ambient)
                chunks: list = []
                for s2 in _build_tasks(store, t.ranges):
                    chunks.extend(_run_one_task(
                        store, req, s2, sums, MAX_RETRY - 1, scan_kind=scan_kind,
                    ))
                results[i] = chunks
                continue
            if resp.other_error is not None:
                raise CopInternalError(resp.other_error)
            served_ok += 1
            # only lanes a vmapped launch actually served count toward
            # batch attribution — cop-cache hits, overflow fall-outs and
            # single-path degrades did not ride one (resp.batched == 0);
            # distinct ids count distinct launches (capacity buckets), so
            # launches_saved equals the store's served-per-launch-minus-one
            if resp.batched:
                stats["regions"] += 1
                batch_ids.add(resp.batched)
                if resp.mesh_merged:
                    # this lane's partial state was merged across the
                    # store's mesh devices (the store's mesh tier)
                    stats["mesh_lanes"] += 1
                    mesh_ids.add(resp.batched)
            sums.append(resp.exec_summaries)
            results[i] = [resp.chunk]
            with tracing.span("distsql.cop_task", region_id=t.region_id,
                              epoch=t.epoch, batched=bool(resp.batched)) as sp:
                if sp is not None and resp.chunk is not None:
                    sp.set("rows", resp.chunk.num_rows())
        if served_ok:
            # at least one lane answered cleanly: the store is reachable
            # (closes a half-open probe; resets the consecutive-fail count)
            store.breakers.record_success(sid)
        stats["batches"] = len(batch_ids)
        stats["launches_saved"] = max(stats["regions"] - len(batch_ids), 0)
        stats["mesh_batches"] = len(mesh_ids)
        if bsp is not None:
            bsp.set("launches_saved", stats["launches_saved"])
            if stats["mesh_lanes"]:
                bsp.set("mesh_lanes_merged", stats["mesh_lanes"])
        metrics.DISTSQL_TASK_DURATION.labels(scan_kind).observe(
            _time.monotonic() - t_batch
        )
    return stats


def _admission_guard(store):
    """Dispatch-tier admission: when the gate's dispatch lane
    is saturated (or the server/admission-full failpoint is armed), the
    request is refused with a typed ServerIsBusy-style shed BEFORE any
    cop task is built — the store never starts work it would drop. The
    returned token is a context manager releasing the dispatch slot. The
    port's store has no gate yet, so the guard is a no-op there."""
    from contextlib import nullcontext

    gate = getattr(store, "admission", None)
    return gate.before_dispatch() if gate is not None else nullcontext()


def select(store: TPUStore, req: KVRequest) -> SelectResult:
    with _admission_guard(store):
        return _select_admitted(store, req)


def _select_admitted(store: TPUStore, req: KVRequest) -> SelectResult:
    from ..util import tracing
    from .planner import choose_tier

    tasks = _build_tasks(store, req.ranges)
    results: list = [None] * len(tasks)
    # per-task summary buckets, flattened in task order below: pool workers
    # finish in arbitrary order, and a shared append list would make
    # EXPLAIN ANALYZE region attribution nondeterministic across runs
    summaries_by_task: list = [[] for _ in tasks]
    # cross-thread span handoff: pool workers don't inherit contextvars,
    # so capture the dispatching thread's span here and parent the
    # per-task spans on it explicitly (pkg/util/tracing's SpanFromContext
    # handover at the copIterator worker boundary). The Top SQL resource
    # tag rides the SAME seam: workers adopt the statement's tag so the
    # store/backoff sinks attribute from pool threads.
    dispatch_span = tracing.current_span()
    stmt_tag = topsql.current_tag()
    scan_kind = _scan_kind(req)
    batch_stats: dict | None = None

    def submitted() -> int | None:
        """A pool task's submit time, taken only while a trace is open."""
        return time.perf_counter_ns() if dispatch_span is not None else None

    def queued(queued_ns: int | None, **attrs) -> None:
        """A pool task's wait, from its submit on this thread to its start
        on a worker (now)."""
        if queued_ns is not None:
            with tracing.span("distsql.cop_queue", parent=dispatch_span, start_ns=queued_ns, **attrs):
                pass

    def run_task(i: int, task: CopTask, queued_ns: int | None = None):
        queued(queued_ns, region_id=task.region_id)
        with topsql.adopt(stmt_tag):
            return _run_one_task(store, req, task, summaries_by_task[i],
                                 dispatch_span=dispatch_span, scan_kind=scan_kind)

    # ONE execution planner picks the tier by data size and topology
    # (distsql/planner.py): single -> pool -> region-batched store batch
    # -> mesh. batch and mesh share the per-store grouping below; mesh
    # marks its cop requests (the port's store serves them batched).
    decision = choose_tier(store, req, tasks)
    if decision.tier in ("batch", "mesh"):
        # batched dispatch: ONE request per STORE — the store stacks its
        # regions and runs the region-batched program once per capacity
        # bucket instead of N serialized per-region programs (ref: batch_coprocessor.go grouping regions
        # per TiFlash store, balanced by the PD's authoritative placement
        # map). Paging requests never batch: the per-page resume cursor is
        # inherently per-region sequential state.
        by_store: dict[int, list] = {}
        ctx = _route_ctx(store) if req.replica_read != "leader" else None
        for i, t in enumerate(tasks):
            # group lanes by their ROUTED peer (leader view by default;
            # follower/closest targets under tidb_replica_read) — each
            # target store still gets exactly one batched dispatch
            by_store.setdefault(_route_task(store, req, t, ctx=ctx),
                                []).append((i, t))

        def run_batch(sid, entries, queued_ns):
            queued(queued_ns, store_id=sid)
            with topsql.adopt(stmt_tag):
                return _run_store_batch(store, req, sid, entries, results,
                                        summaries_by_task, dispatch_span, scan_kind,
                                        mesh=decision.tier == "mesh")

        with ThreadPoolExecutor(max_workers=max(len(by_store), 1)) as pool:
            futs = [pool.submit(run_batch, sid, entries, submitted())
                    for sid, entries in by_store.items()]
            per_store = [f.result() for f in futs]
        batch_stats = {
            "batches": sum(s["batches"] for s in per_store),
            "regions": sum(s["regions"] for s in per_store),
            "launches_saved": sum(s["launches_saved"] for s in per_store),
            "mesh_batches": sum(s["mesh_batches"] for s in per_store),
            "mesh_lanes": sum(s["mesh_lanes"] for s in per_store),
        }
    elif req.concurrency > 1 and len(tasks) > 1:
        with ThreadPoolExecutor(max_workers=req.concurrency) as pool:
            futs = [pool.submit(run_task, i, t, submitted()) for i, t in enumerate(tasks)]
            for i, f in enumerate(futs):
                results[i] = f.result()
    else:
        for i, t in enumerate(tasks):
            results[i] = run_task(i, t)

    chunks = [c for sub in results for c in sub if c is not None]
    summaries = [s for per_task in summaries_by_task for s in per_task]
    return SelectResult(chunks=chunks, exec_summaries=summaries,
                        batch_stats=batch_stats)
