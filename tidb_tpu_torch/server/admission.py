"""Admission control — the server tier's load-shedding front door (ref:
TiDB's server-side connection/token limits + TiKV's ServerIsBusy
backpressure: when the store saturates, new work is REFUSED with a typed
wait hint instead of queueing until something wedges).

One `AdmissionGate` per store (every session and the dispatch layer of a
server consult the same gate):

  * `admit()` bounds concurrently EXECUTING statements (`max_inflight`).
    A statement arriving at a full gate waits in a bounded PER-SESSION
    queue (`session_queue` deep, `queue_wait_ms` long); past either bound
    it is SHED: a typed `AdmissionShed{backoff_ms}` whose message is the
    wire `server_is_busy` string, so `parse_region_error` classifies it
    and clients retry on the existing Backoffer `server_busy` budget
    (the region-error taxonomy).
  * `before_dispatch()` answers the same shed BEFORE any cop task is
    built when the dispatch tier itself saturates (`max_dispatch`
    concurrent distsql dispatches) — the store never sees work it would
    have to drop mid-flight.

The measured-cost mode (`admission.cost_classed`): a flat
in-flight count treats a 2µs point-get and a full-mesh aggregate as the
same unit of load, so saturation sheds them with equal probability. In
cost mode the gate weighs in-flight statements by their Top SQL cost
class — the per-digest EWMA of measured (cpu_ns + device_ns), never a
guess from the statement text. `max_inflight` becomes a weight budget
denominated in point-gets: a class of weight w gets `max_inflight // w`
concurrent slots of its own, so heavy digests saturate (and shed, same
typed 9003) at a quarter of the budget while point-gets keep their full
count flowing. Queue wait in either mode is attributed to the waiting
statement's resource tag.

The `server/admission-full` failpoint forces the saturated answer, so
tests and the chaos harness can exercise shedding without real load.
Defaults are fully open (0 = unlimited): embedded/test sessions pay one
lock-free-ish check per statement and nothing else.

Copy of `tidb_tpu/server/admission.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
import time

from ..store.errors import ServerIsBusy
from ..topsql import CLASS_WEIGHTS, COLLECTOR, record_queue_wait
from ..util import failpoint, metrics


class AdmissionShed(RuntimeError):
    """Statement refused at the admission gate. `backoff_ms` is the
    suggested client wait (rides the message in the wire server_is_busy
    format, so parse_region_error -> ServerIsBusy{backoff_ms} and the
    Backoffer honors it as a floor on the server_busy budget)."""

    def __init__(self, backoff_ms: int, where: str = "admission"):
        super().__init__(str(ServerIsBusy.make(-1, backoff_ms)) + f" ({where})")
        self.backoff_ms = backoff_ms
        self.where = where


class AdmissionGate:
    """Bounded statement admission + dispatch saturation check."""

    def __init__(self, max_inflight: int = 0, session_queue: int = 4,
                 queue_wait_ms: float = 50.0, shed_backoff_ms: int = 5,
                 max_dispatch: int = 0, now_fn=time.monotonic,
                 cost_classed: bool = False, classifier=None):
        self.max_inflight = max_inflight  # 0 = unlimited
        self.session_queue = session_queue
        self.queue_wait_ms = queue_wait_ms
        self.shed_backoff_ms = shed_backoff_ms
        self.max_dispatch = max_dispatch  # 0 = unlimited
        self.cost_classed = cost_classed
        # digest -> cost class; defaults to the Top SQL collector's
        # measured EWMA classes (injectable for tests)
        self._classifier = classifier
        self._now = now_fn
        self._cv = threading.Condition()  # ONE lock: gate counters + waiters
        self._inflight = 0  # guarded_by: _cv
        self._dispatching = 0  # guarded_by: _cv
        self._queued: dict = {}  # session id -> queued count; guarded_by: _cv
        self._by_class: dict = {}  # cost class -> inflight count; guarded_by: _cv

    def configure(self, max_inflight: int | None = None,
                  session_queue: int | None = None,
                  queue_wait_ms: float | None = None,
                  shed_backoff_ms: int | None = None,
                  max_dispatch: int | None = None,
                  cost_classed: bool | None = None):
        with self._cv:
            if max_inflight is not None:
                self.max_inflight = max_inflight
            if session_queue is not None:
                self.session_queue = session_queue
            if queue_wait_ms is not None:
                self.queue_wait_ms = queue_wait_ms
            if shed_backoff_ms is not None:
                self.shed_backoff_ms = shed_backoff_ms
            if max_dispatch is not None:
                self.max_dispatch = max_dispatch
            if cost_classed is not None:
                self.cost_classed = cost_classed
            self._cv.notify_all()

    def _classify(self, digest) -> str:
        if self._classifier is not None:
            return self._classifier(digest)
        return COLLECTOR.cost_class(digest)

    def _shed(self, where: str) -> AdmissionShed:
        metrics.ADMISSION_SHED.labels(where).inc()
        return AdmissionShed(self.shed_backoff_ms, where)

    # ---------------------------------------------------- statement gate
    def admit(self, session_id, digest: str | None = None) -> "_AdmitToken":
        """Enter the statement gate (context manager). Raises
        AdmissionShed when saturated past this session's queue bound or
        queue wait — BEFORE any parse/plan/dispatch work happens.
        `digest` is the statement's literal-masked SQL digest (the plan
        cache probe's): in cost-classed mode it selects the weight lane;
        the flat gate ignores it."""
        if failpoint.eval("server/admission-full"):
            raise self._shed("gate")
        if self.max_inflight <= 0:
            return _AdmitToken(self, counted=False)
        if self.cost_classed:
            return self._admit_classed(session_id, digest)
        with self._cv:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                metrics.ADMISSION_ADMITTED.inc()
                metrics.ADMISSION_INFLIGHT.set(self._inflight)
                return _AdmitToken(self, counted=True)
            self._enqueue_locked(session_id)
            t_q = self._now()
            try:
                deadline = t_q + self.queue_wait_ms / 1000.0
                while self._inflight >= self.max_inflight > 0:
                    left = deadline - self._now()
                    if left <= 0:
                        raise self._shed("queue_timeout")
                    self._cv.wait(left)
            finally:
                self._dequeue_locked(session_id)
                self._note_queue_wait(t_q)
            self._inflight += 1
            metrics.ADMISSION_ADMITTED.inc()
            metrics.ADMISSION_INFLIGHT.set(self._inflight)
            return _AdmitToken(self, counted=True)

    def _admit_classed(self, session_id, digest: str | None) -> "_AdmitToken":
        """The measured-cost gate: the statement's class (Top SQL EWMA)
        picks its weight lane — a class of weight w owns
        `max_inflight // w` slots, so heavy digests saturate first and
        shed the same typed 9003 while point-gets keep their full count."""
        cls = self._classify(digest)
        cap = max(1, self.max_inflight // CLASS_WEIGHTS.get(cls, 1))
        with self._cv:
            if self._by_class.get(cls, 0) < cap:
                return self._admit_classed_locked(cls)
            self._enqueue_locked(session_id)
            t_q = self._now()
            try:
                deadline = t_q + self.queue_wait_ms / 1000.0
                while self._by_class.get(cls, 0) >= cap:
                    left = deadline - self._now()
                    if left <= 0:
                        metrics.TOPSQL_CLASS_DECISIONS.labels(cls, "shed").inc()
                        raise self._shed("queue_timeout")
                    self._cv.wait(left)
            finally:
                self._dequeue_locked(session_id)
                self._note_queue_wait(t_q)
            return self._admit_classed_locked(cls)

    def _admit_classed_locked(self, cls: str) -> "_AdmitToken":  # requires: _cv
        self._by_class[cls] = self._by_class.get(cls, 0) + 1
        self._inflight += 1
        metrics.ADMISSION_ADMITTED.inc()
        metrics.ADMISSION_INFLIGHT.set(self._inflight)
        metrics.TOPSQL_CLASS_DECISIONS.labels(cls, "admit").inc()
        return _AdmitToken(self, counted=True, cls=cls)

    def _enqueue_locked(self, session_id) -> None:  # requires: _cv
        q = self._queued.get(session_id, 0)
        if q >= self.session_queue:
            raise self._shed("queue_full")
        self._queued[session_id] = q + 1
        metrics.ADMISSION_QUEUE_WAITS.inc()

    def _dequeue_locked(self, session_id) -> None:  # requires: _cv
        n = self._queued.get(session_id, 1) - 1
        if n <= 0:
            self._queued.pop(session_id, None)
        else:
            self._queued[session_id] = n

    def _note_queue_wait(self, t_q: float) -> None:
        # queue wait onto the waiting statement's resource tag (Top SQL:
        # a digest that spends its life waiting at the gate should show
        # it). The tag lock is a leaf — safe under _cv.
        record_queue_wait((self._now() - t_q) * 1000.0)

    def _release(self, cls: str | None = None):
        with self._cv:
            self._inflight -= 1
            if cls is not None:
                n = self._by_class.get(cls, 1) - 1
                if n <= 0:
                    self._by_class.pop(cls, None)
                else:
                    self._by_class[cls] = n
            metrics.ADMISSION_INFLIGHT.set(self._inflight)
            # classed waiters wait on per-class capacity: wake them all,
            # each re-checks its own lane
            self._cv.notify_all()

    # ----------------------------------------------------- dispatch gate
    def before_dispatch(self) -> "_DispatchToken":
        """Saturation check at the distsql dispatch seam — answers the
        typed shed BEFORE building cop tasks (the store never starts work
        it would drop). Unlimited by default."""
        if failpoint.eval("server/admission-full"):
            raise self._shed("dispatch")
        if self.max_dispatch <= 0:
            return _DispatchToken(self, counted=False)
        with self._cv:
            if self._dispatching >= self.max_dispatch:
                raise self._shed("dispatch")
            self._dispatching += 1
        return _DispatchToken(self, counted=True)

    def _release_dispatch(self):
        with self._cv:
            self._dispatching -= 1

    def view(self) -> dict:
        with self._cv:
            return {
                "max_inflight": self.max_inflight,
                "inflight": self._inflight,
                "dispatching": self._dispatching,
                "queued": sum(self._queued.values()),
                "cost_classed": self.cost_classed,
                "by_class": dict(self._by_class),
                "weighted_inflight": sum(
                    n * CLASS_WEIGHTS.get(c, 1) for c, n in self._by_class.items()
                ),
            }


class _AdmitToken:
    def __init__(self, gate: AdmissionGate, counted: bool, cls: str | None = None):
        self._gate, self._counted, self._cls = gate, counted, cls

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._counted:
            self._gate._release(self._cls)
        return False


class _DispatchToken:
    def __init__(self, gate: AdmissionGate, counted: bool):
        self._gate, self._counted = gate, counted

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._counted:
            self._gate._release_dispatch()
        return False
