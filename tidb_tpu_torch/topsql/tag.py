"""The per-statement resource tag and its attribution sinks (ref:
pkg/util/topsql/state — the reference carries `sql_digest, plan_digest`
in goroutine pprof labels; here the tag is a contextvar, the same
ambient mechanism util/tracing uses for spans).

The tag is set ONCE per statement at the session boundary, riding the
digest the plan-cache probe already computed in its one lexer pass. The
dispatch pool's workers do NOT inherit contextvars (the PR-2 tracing
seam has the same property), so `select()` captures the tag on the
session thread and each worker `adopt()`s it explicitly — one tag
object shared by every thread of the statement, its counters guarded by
a leaf lock no other lock is ever taken under.

Sinks are free when no tag is ambient: one contextvar read, no lock.
"""

from __future__ import annotations

import contextvars
import threading
import time
from contextlib import contextmanager

from .reporter import COLLECTOR

_tag: contextvars.ContextVar = contextvars.ContextVar("topsql_tag", default=None)


class ResourceTag:
    """Mutable per-statement attribution target. `sql_digest` is the
    plan-cache probe's literal-masked digest (EXECUTE re-points it at
    the underlying prepared statement's, the same join the stmt log
    does); `plan_digest` lands when the planner picks an access path.
    Counter fields accumulate under `_mu` — sinks run on dispatch pool
    threads concurrently with each other."""

    __slots__ = (
        "sql_digest", "plan_digest", "sample_sql", "_mu",
        "cpu_ns", "device_ns", "compile_ns", "backoff_ms", "queue_ms",
        "bytes_to_device", "cop_cache_hits",
    )

    def __init__(self, sql_digest: str, sample_sql: str = ""):
        self.sql_digest = sql_digest
        self.plan_digest = ""
        self.sample_sql = sample_sql
        self._mu = threading.Lock()
        with self._mu:  # tags churn per-statement: even init writes lock
            self.cpu_ns = 0  # guarded_by: _mu
            self.device_ns = 0  # guarded_by: _mu
            self.compile_ns = 0  # guarded_by: _mu
            self.backoff_ms = 0.0  # guarded_by: _mu
            self.queue_ms = 0.0  # guarded_by: _mu
            self.bytes_to_device = 0  # guarded_by: _mu
            self.cop_cache_hits = 0  # guarded_by: _mu

    def add(self, device_ns: int = 0, compile_ns: int = 0,
            bytes_to_device: int = 0, backoff_ms: float = 0.0,
            queue_ms: float = 0.0, cop_cache_hits: int = 0):
        with self._mu:
            self.device_ns += device_ns
            self.compile_ns += compile_ns
            self.bytes_to_device += bytes_to_device
            self.backoff_ms += backoff_ms
            self.queue_ms += queue_ms
            self.cop_cache_hits += cop_cache_hits

    def add_cpu(self, cpu_ns: int) -> None:
        """A pool worker's thread-CPU delta over its task."""
        with self._mu:
            self.cpu_ns += cpu_ns

    def finish(self, cpu_ns: int) -> dict:
        """Statement end: the session adds its own exact thread-CPU delta
        to what its pool workers added and takes the flush snapshot in
        one locked step."""
        with self._mu:
            self.cpu_ns += cpu_ns
        return self.snapshot()

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "sql_digest": self.sql_digest,
                "plan_digest": self.plan_digest,
                "sample_sql": self.sample_sql,
                "cpu_ns": self.cpu_ns,
                "device_ns": self.device_ns,
                "compile_ns": self.compile_ns,
                "backoff_ms": self.backoff_ms,
                "queue_ms": self.queue_ms,
                "bytes_to_device": self.bytes_to_device,
                "cop_cache_hits": self.cop_cache_hits,
            }


def current_tag() -> ResourceTag | None:
    return _tag.get()


def activate(tag: ResourceTag | None):
    """Install `tag` as the statement's ambient attribution target.
    Returns the token `deactivate` needs; None tags install nothing
    (Top SQL off, or an unlexable statement with no probe digest)."""
    if tag is None:
        return None
    return _tag.set(tag)


def deactivate(token) -> None:
    if token is not None:
        _tag.reset(token)


@contextmanager
def adopt(tag: ResourceTag | None):
    """Cross-thread handoff: a dispatch pool worker adopts the session
    thread's tag for the duration of its task (contextvars do not cross
    ThreadPoolExecutor, exactly like the dispatch_span handoff). A thread
    that runs no statement of its own (no tag ambient) adds its CPU time
    over the block to the tag; a statement's own thread does not, since
    the session lands that thread's whole delta at `finish`."""
    if tag is None:
        yield
        return
    cpu0 = time.thread_time_ns() if _tag.get() is None else None
    token = _tag.set(tag)
    try:
        yield
    finally:
        _tag.reset(token)
        if cpu0 is not None:
            tag.add_cpu(time.thread_time_ns() - cpu0)


# ------------------------------------------------------------------ sinks
def record_device(launch_ns: int, compile_ns: int = 0,
                  bytes_to_device: int = 0) -> None:
    """One fused-program launch's device attribution: the whole launch
    elapsed lands on the ambient statement (per-lane ExecSummary shares
    are display attribution; the statement owns the full launch), plus
    the launch total into the collector's conservation ledger — so
    `sum(per-digest device_ns) == sum(launch totals)` is checkable."""
    t = _tag.get()
    if t is None:
        return
    t.add(device_ns=launch_ns, compile_ns=compile_ns,
          bytes_to_device=bytes_to_device)
    COLLECTOR.note_launch(launch_ns)


def record_backoff(ms: float) -> None:
    """A Backoffer slept interval attributed to the ambient statement."""
    t = _tag.get()
    if t is not None:
        t.add(backoff_ms=ms)


def record_queue_wait(ms: float) -> None:
    """Admission-gate queue wait attributed to the ambient statement."""
    t = _tag.get()
    if t is not None:
        t.add(queue_ms=ms)


def record_cop_cache_hit() -> None:
    """A region served from the coprocessor cache: zero device time by
    construction (no launch ran) — the hit count keeps the conservation
    story honest instead of looking like lost attribution."""
    t = _tag.get()
    if t is not None:
        t.add(cop_cache_hits=1)
