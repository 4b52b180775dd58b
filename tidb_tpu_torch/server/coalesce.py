"""Cross-session fused execution — the per-store session
coalescer.

Under many concurrent sessions every session still pays its own device
launch and its own quorum proposal. This module makes sessions into
lanes of one launch:

  reads   concurrent plan-cache-hit point-gets park in a short
          micro-batch window (bounded by `tidb_tpu_coalesce_wait_us`
          and a max lane count) and ship as ONE vmapped device launch
          through the existing `batch_coprocessor` stacking path; every
          lane's rows slice back out, with honest per-lane device-time
          attribution through the Top SQL `split_by_rows` seam
  writes  concurrent autocommit single-row writes fold into GROUP
          COMMIT — `TxnEngine.commit_group` 2PCs every lane at its own
          commit ts in one critical section, and the store folds the
          applied lanes into ONE quorum proposal per (region, window)
          (`ReplicaManager.propose_group`)

Protocol — leader/follower, no daemon thread: the FIRST session to open
a window becomes its leader and waits out the window (condition wait
with a deadline, never a sleep); followers park on their lane's event.
The leader CLAIMS the window's lanes atomically, flushes them, and
answers every lane. A follower whose leader stalls past its patience
(the `coalesce/window-stall` chaos shape) withdraws its lane — if still
unclaimed — and falls back to the single path; a claimed lane always
waits for its answer. Any lane the flush could not answer (a region
fault, a lost flush, a refused quorum) FALLS OUT to the caller's single
path exactly like a stale-epoch lane falls out of batch cop — the
coalescer never invents an error path the single path doesn't have.

Lock order: the coalescer mutex is a LEAF — no store/txn/dispatch lock
is ever taken while holding it (lanes are snapshotted under the mutex,
flushed outside it).

Copy of `tidb_tpu/server/coalesce.py` for the PyTorch port (it imports
nothing of tidb_tpu). The read flush's one `batch_coprocessor` call runs
each same-DAG bucket as one region-batched program (`torch.func.vmap`
over the lanes) on the store's device.
"""

from __future__ import annotations

import threading
import time

from ..util import failpoint, metrics

# fall-out reasons (typed, each a `tidb_tpu_coalesce_fallbacks_total` label):
#   window_stall  follower patience expired with the window unclaimed
#   flush_lost    the flush died (or `coalesce/flush-lost` fired) before
#                 this lane was answered
#   fault_lane    a region/store fault answered one of the lane's cop
#                 requests — the single path owns retry/backoff
#   txn_conflict  group-commit prewrite/conflict check refused the lane —
#                 the single path re-runs the same checks canonically
FALLBACK_REASONS = ("window_stall", "flush_lost", "fault_lane", "txn_conflict")


class _Window:
    __slots__ = ("kind", "lanes", "closed", "claimed")

    def __init__(self, kind: str):
        self.kind = kind
        self.lanes: list = []  # guarded_by: SessionCoalescer._mu
        self.closed = False  # guarded_by: SessionCoalescer._mu — full, no new lanes
        self.claimed = False  # guarded_by: SessionCoalescer._mu — leader took the lanes


class _Lane:
    __slots__ = ("kind", "tag", "done", "meta", "handles", "mutations",
                 "start_ts", "result", "error", "fallback", "reason",
                 "enq", "window")

    def __init__(self, kind: str, tag):
        self.kind = kind
        self.tag = tag  # Top SQL ResourceTag for cross-thread attribution
        self.done = threading.Event()
        self.meta = None
        self.handles: list = []
        self.mutations: dict = {}
        self.start_ts = 0
        self.result = None
        self.error: BaseException | None = None
        self.fallback = False
        self.reason = ""
        self.enq = 0.0
        self.window: _Window | None = None


class SessionCoalescer:
    """One per store (TPUStore.__init__), shared by every session."""

    def __init__(self, store):
        self.store = store
        self._mu = threading.RLock()  # RLock: Condition._is_owned works
        # under the lockwatch proxy (a plain Lock has no ownership probe)
        self._cv = threading.Condition(self._mu)
        self._open: dict[str, _Window | None] = {"read": None, "write": None}  # guarded_by: _mu

    # ------------------------------------------------------------- API
    def point_get(self, meta, handles, tag=None,
                  wait_us: int = 300, max_lanes: int = 64):
        """Park a point-get lane (table meta + integer handles) in the
        read window. Returns {handle: row datums} covering every handle
        that exists at the window's shared snapshot, or None — the lane
        fell out and the caller must run its single path."""
        if max_lanes <= 1 or wait_us <= 0:
            return None
        lane = _Lane("read", tag)
        lane.meta = meta
        lane.handles = list(handles)
        if not self._park(lane, wait_us, max_lanes):
            return None
        if lane.error is not None:
            raise lane.error
        return lane.result

    def group_commit(self, mutations: dict, start_ts: int, tag=None,
                     wait_us: int = 300, max_lanes: int = 64):
        """Park an autocommit write lane (key -> value|None at start_ts)
        in the write window. Returns the lane's commit_ts on success, or
        None — the lane fell out (stall / lost flush / conflict) and the
        caller must commit through the single path. A typed refusal the
        single path would also raise (quorum lost) raises here."""
        if max_lanes <= 1 or wait_us <= 0 or not mutations:
            return None
        lane = _Lane("write", tag)
        lane.mutations = dict(mutations)
        lane.start_ts = start_ts
        if not self._park(lane, wait_us, max_lanes):
            return None
        if lane.error is not None:
            raise lane.error
        return lane.result

    # -------------------------------------------------------- protocol
    @staticmethod
    def _patience(wait_s: float) -> float:
        # a follower outwaits the leader's window plus scheduling slack;
        # anything longer means the leader is wedged (window-stall chaos)
        return wait_s * 4 + 0.05

    def _park(self, lane: _Lane, wait_us: int, max_lanes: int) -> bool:
        """Enqueue the lane; lead or follow; True = lane was answered
        (result/error set), False = lane fell out to the single path."""
        wait_s = wait_us / 1e6
        lane.enq = time.perf_counter()
        with self._mu:
            win = self._open.get(lane.kind)
            if win is None or win.closed or win.claimed:
                win = _Window(lane.kind)
                self._open[lane.kind] = win
                leader = True
            else:
                leader = False
            win.lanes.append(lane)
            lane.window = win
            if len(win.lanes) >= max_lanes:
                win.closed = True
                self._cv.notify_all()
        if leader:
            self._lead(win, wait_s)
        elif not lane.done.wait(self._patience(wait_s)):
            with self._mu:
                if not win.claimed and not lane.done.is_set():
                    win.lanes.remove(lane)
                    self._fall_out(lane, "window_stall")
            # claimed in the race window: the leader's flush owns the
            # answer now and its finally-clause guarantees the event
            lane.done.wait()
        return not lane.fallback

    def _lead(self, win: _Window, wait_s: float) -> None:
        deadline = time.monotonic() + wait_s
        with self._mu:
            while not win.closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            stall = failpoint.eval("coalesce/window-stall")
            if stall:
                # chaos: a descheduled leader holds the window open past
                # its deadline — followers withdraw and fall back
                hold = time.monotonic() + (stall if isinstance(stall, float) else 0.25)
                while True:
                    left = hold - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
            win.closed = True
            win.claimed = True
            if self._open.get(win.kind) is win:
                self._open[win.kind] = None
            lanes = list(win.lanes)
        try:
            if win.kind == "read":
                self._flush_reads(lanes)
            else:
                self._flush_writes(lanes)
        finally:
            for lane in lanes:  # a flush that died mid-way answers
                if not lane.done.is_set():  # every claimed lane anyway
                    self._fall_out(lane, "flush_lost")

    def _fall_out(self, lane: _Lane, reason: str) -> None:
        lane.fallback = True
        lane.reason = reason
        metrics.COALESCE_FALLBACKS.labels(reason).inc()
        lane.done.set()

    # ---------------------------------------------------------- flush
    def _flush_reads(self, lanes: list) -> None:
        """ONE batch_coprocessor call for the whole window: every lane's
        point ranges become per-region cop requests at ONE shared
        snapshot ts (same-table lanes share a DAG, so they land in the
        same vmapped launch group). Faulted lanes fall out; the rest get
        {handle: row} plus their proportional share of the launch."""
        from .. import topsql
        from ..codec import tablecodec
        from ..distsql.dispatch import _build_tasks
        from ..exec.dag import ColumnInfo, DAGRequest, TableScan
        from ..sql.session import HANDLE_FT
        from ..store.store import CopRequest, KeyRange

        store = self.store
        if failpoint.eval("coalesce/flush-lost"):
            for lane in lanes:
                self._fall_out(lane, "flush_lost")
            return
        t_flush = time.perf_counter()
        # ONE snapshot for the window: batch_coprocessor groups lanes by
        # (fingerprint, start_ts, ...) — per-session timestamps would
        # never stack. Serializing the window's autocommit reads at one
        # TSO tick is a legal serial order for them.
        shared_ts = store.next_ts()
        store.register_snapshot(shared_ts)
        try:
            reqs: list = []
            spans: list = []  # (lane, first req index, past-last index)
            dags: dict = {}
            for lane in lanes:
                meta = lane.meta
                dag = dags.get(meta.table_id)
                if dag is None:
                    cols = [ColumnInfo(-1, HANDLE_FT)] + list(meta.scan_columns())
                    dags[meta.table_id] = dag = DAGRequest(
                        (TableScan(meta.table_id, tuple(cols)),),
                        output_offsets=tuple(range(len(cols))),
                    )
                ranges = [
                    KeyRange(tablecodec.encode_row_key(meta.table_id, h),
                             tablecodec.encode_row_key(meta.table_id, h) + b"\x00")
                    for h in lane.handles
                ]
                lo = len(reqs)
                for t in _build_tasks(store, ranges):
                    reqs.append(CopRequest(
                        dag=dag, ranges=t.ranges, start_ts=shared_ts,
                        region_id=t.region_id, region_epoch=t.epoch,
                        peer_store=store.cluster.leader_of(t.region_id),
                    ))
                spans.append((lane, lo, len(reqs)))
            t0 = time.perf_counter_ns()
            with topsql.adopt(None):
                # untagged launch: the store's internal record_device
                # no-ops, so device time lands ONLY through the per-lane
                # shares below — each lane attributed once, exactly
                resps = store.batch_coprocessor(reqs)
            elapsed = time.perf_counter_ns() - t0
        finally:
            store.unregister_snapshot(shared_ts)
        launch_ids = {r.batched for r in resps if r.batched}
        batched_n = sum(1 for r in resps if r.batched)
        metrics.COALESCE_BATCHES.inc()
        metrics.COALESCE_LANES.labels("read").inc(len(lanes))
        if batched_n > len(launch_ids):
            metrics.COALESCE_LAUNCHES_SAVED.inc(batched_n - len(launch_ids))
        rows_per_lane = []
        for lane, lo, hi in spans:
            sub = resps[lo:hi]
            if any(r.region_error or r.other_error for r in sub):
                self._fall_out(lane, "fault_lane")
                rows_per_lane.append(0)
                continue
            by_handle: dict = {}
            for r in sub:
                if r.chunk is not None:
                    for row in r.chunk.rows():
                        by_handle[int(row[0].val)] = list(row[1:])
            lane.result = by_handle
            rows_per_lane.append(len(by_handle))
        shares = topsql.split_by_rows(elapsed, rows_per_lane)
        for (lane, _lo, _hi), share in zip(spans, shares):
            if lane.fallback:
                continue
            park_s = max(t_flush - lane.enq, 0.0)
            metrics.COALESCE_WINDOW_WAIT.observe(park_s)
            with topsql.adopt(lane.tag):
                topsql.record_device(share)
                topsql.record_queue_wait(park_s * 1000.0)
            lane.done.set()

    def _flush_writes(self, lanes: list) -> None:
        """ONE group commit for the window: every lane 2PCs at its own
        commit ts inside one engine critical section; the store folds
        the applied lanes into one proposal per region. Conflict-refused
        lanes fall out to the single path; a quorum refusal raises the
        same typed error the single path would."""
        from .. import topsql
        from ..store.txn import TxnError

        store = self.store
        if failpoint.eval("coalesce/flush-lost"):
            for lane in lanes:
                self._fall_out(lane, "flush_lost")
            return
        t_flush = time.perf_counter()
        results = store.txn.commit_group(
            [(lane.mutations, lane.start_ts) for lane in lanes],
            store.next_ts,
        )
        metrics.COALESCE_BATCHES.inc()
        metrics.COALESCE_LANES.labels("write").inc(len(lanes))
        for lane, res in zip(lanes, results):
            park_s = max(t_flush - lane.enq, 0.0)
            metrics.COALESCE_WINDOW_WAIT.observe(park_s)
            with topsql.adopt(lane.tag):
                topsql.record_queue_wait(park_s * 1000.0)
            if isinstance(res, TxnError):
                self._fall_out(lane, "txn_conflict")
            elif isinstance(res, BaseException):
                lane.error = res  # typed (quorum lost): raise in the lane
                lane.done.set()
            elif res is None:
                self._fall_out(lane, "txn_conflict")  # empty lane: single path
            else:
                lane.result = res
                metrics.COALESCE_GROUP_COMMITS.inc()
                lane.done.set()
