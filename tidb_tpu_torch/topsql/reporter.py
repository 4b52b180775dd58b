"""Windowed top-K reporter + EWMA cost classes (ref:
pkg/util/topsql/reporter — the pubsub reporter collects per-digest
records into one-minute windows, keeps the top `MaxStatementCount`
digests per metric and folds the rest into an `others` row, retaining a
bounded history).

Statements flush their finished resource tag here; the live window
auto-seals when its span elapses (checked on every record and read, so
idle processes without a PD still rotate) and the PD tick's
`topsql.report` phase forces the check on a clock. Sealed windows keep
the union of top-K digests BY EACH metric — a digest that dominates
backoff but not CPU still surfaces — and fold the remainder into one
`(others)` entry so window totals stay conservation-exact.

Cost classes: a per-digest EWMA of (cpu_ns + device_ns) per execution
buckets digests into point/small/scan/heavy. The admission gate's
measured-cost mode weighs in-flight statements by class — the EWMA is
the "measured, not guessed" half of the ROADMAP item. Classes are
re-learned continuously: a digest whose plan changes migrates as soon
as the EWMA crosses a boundary, never pinned to its first-seen cost.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..util import metrics

OTHERS_DIGEST = "(others)"

# additive per-statement metrics a window row carries; ranking considers
# each independently when picking a window's top-K survivors
WINDOW_METRICS = ("cpu_ns", "device_ns", "compile_ns", "backoff_ms", "queue_ms")

# EWMA(cpu_ns + device_ns) upper bounds per class; above the last bound
# is "heavy". Scaled to this engine's in-process latencies (a point-get
# is ~100µs of host time; a mesh aggregate is tens of ms of device time).
CLASS_BOUNDS_NS = (("point", 1_500_000), ("small", 8_000_000), ("scan", 40_000_000))
CLASS_WEIGHTS = {"point": 1, "small": 1, "scan": 2, "heavy": 4}
DEFAULT_CLASS = "small"  # unmeasured digests: neither fast-tracked nor shed

_EWMA_ALPHA = 0.4  # fast re-learn: ~3 executions cross a class boundary
_MAX_EWMAS = 4096  # cost map bound; least-recently-updated evicts


def split_by_rows(total_ns: int, rows: list) -> list:
    """Split one launch's elapsed across its lanes proportionally to
    each lane's decoded rows (the ex_rows attribution the batched tiers
    need), EXACTLY: shares always sum to `total_ns`, largest-remainder
    rounding, deterministic. All-zero row counts degrade to equal split."""
    n = len(rows)
    if n == 0:
        return []
    w = [max(int(r), 0) for r in rows]
    s = sum(w)
    if s == 0:
        w = [1] * n
        s = n
    shares = [total_ns * wi // s for wi in w]
    rem = total_ns - sum(shares)
    if rem:
        order = sorted(range(n), key=lambda i: (-(total_ns * w[i] % s), i))
        for j in range(rem):  # rem < n by floor arithmetic
            shares[order[j]] += 1
    return shares


class DigestStats:
    """One digest's additive totals inside one window (or the live one)."""

    __slots__ = ("digest", "plan_digest", "sample_sql", "exec_count", "errors",
                 "cpu_ns", "device_ns", "compile_ns", "backoff_ms", "queue_ms",
                 "bytes_to_device", "cop_cache_hits", "plan_cache_hits")

    def __init__(self, digest: str):
        self.digest = digest
        self.plan_digest = ""
        self.sample_sql = ""
        self.exec_count = 0
        self.errors = 0
        self.cpu_ns = 0
        self.device_ns = 0
        self.compile_ns = 0
        self.backoff_ms = 0.0
        self.queue_ms = 0.0
        self.bytes_to_device = 0
        self.cop_cache_hits = 0
        self.plan_cache_hits = 0

    def merge(self, other: "DigestStats") -> None:
        self.exec_count += other.exec_count
        self.errors += other.errors
        self.cpu_ns += other.cpu_ns
        self.device_ns += other.device_ns
        self.compile_ns += other.compile_ns
        self.backoff_ms += other.backoff_ms
        self.queue_ms += other.queue_ms
        self.bytes_to_device += other.bytes_to_device
        self.cop_cache_hits += other.cop_cache_hits
        self.plan_cache_hits += other.plan_cache_hits

    def as_dict(self) -> dict:
        return {
            "digest": self.digest,
            "plan_digest": self.plan_digest,
            "sample_sql": self.sample_sql,
            "exec_count": self.exec_count,
            "errors": self.errors,
            "cpu_ns": self.cpu_ns,
            "device_ns": self.device_ns,
            "compile_ns": self.compile_ns,
            "backoff_ms": self.backoff_ms,
            "queue_ms": self.queue_ms,
            "bytes_to_device": self.bytes_to_device,
            "cop_cache_hits": self.cop_cache_hits,
            "plan_cache_hits": self.plan_cache_hits,
        }


class _Window:
    __slots__ = ("start", "end", "top", "others")

    def __init__(self, start: float, end: float, top: dict,
                 others: DigestStats | None):
        self.start = start
        self.end = end
        self.top = top  # digest -> DigestStats, ranked survivors
        self.others = others


class _Ewma:
    __slots__ = ("value", "n")

    def __init__(self):
        self.value = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        self.value = x if self.n == 0 else _EWMA_ALPHA * x + (1.0 - _EWMA_ALPHA) * self.value
        self.n += 1


class TopSQLCollector:
    """The process-wide ledger. One leaf lock (`_mu`) guards the live
    window, the ring and the cost map; statements flush under it once
    per execution and readers snapshot under it — no other lock is ever
    taken while holding it, so it can never participate in a cycle."""

    def __init__(self, window_s: float = 1.0, top_k: int = 30,
                 ring: int = 60, now_fn=time.time):
        self._mu = threading.Lock()
        self._now = now_fn
        self.enabled = True
        self.window_s = window_s
        self.top_k = top_k
        self._live: dict[str, DigestStats] = {}  # guarded_by: _mu
        self._live_start: float = now_fn()  # guarded_by: _mu
        self._ring: deque = deque(maxlen=ring)  # guarded_by: _mu
        self._cost: dict[str, _Ewma] = {}  # guarded_by: _mu
        # all-time totals: incremented with EXACTLY the values the live
        # window absorbs, so API/infoschema sums reconcile against the
        # tidb_tpu_topsql_* counters byte-for-byte
        self.totals: dict[str, float] = {m: 0 for m in WINDOW_METRICS}  # guarded_by: _mu
        self.totals["exec_count"] = 0
        self.launch_device_ns = 0  # guarded_by: _mu — conservation ledger

    # ------------------------------------------------------------ config
    def configure(self, top_k: int | None = None, window_s: float | None = None,
                  ring: int | None = None, enabled: bool | None = None):
        with self._mu:
            if top_k is not None:
                self.top_k = max(1, int(top_k))
            if window_s is not None:
                self.window_s = max(0.001, float(window_s))
            if ring is not None:
                self._ring = deque(self._ring, maxlen=max(1, int(ring)))
            if enabled is not None:
                self.enabled = bool(enabled)

    def reset(self):
        with self._mu:
            self._live = {}
            self._live_start = self._now()
            self._ring.clear()
            self._cost = {}
            self.totals = {m: 0 for m in WINDOW_METRICS}
            self.totals["exec_count"] = 0
            self.launch_device_ns = 0

    # ------------------------------------------------------------- sinks
    def note_launch(self, ns: int) -> None:
        """One fused-program launch's total device time, recorded at the
        store while a statement tag is ambient — the right-hand side of
        the attribution-conservation equation."""
        with self._mu:
            self.launch_device_ns += ns
        metrics.TOPSQL_LAUNCH_DEVICE_NS.inc(ns)

    def record_statement(self, snap: dict, success: bool = True,
                         plan_cache_hit: bool = False) -> None:
        """Fold one finished statement's tag snapshot into the live
        window and its digest's cost EWMA."""
        if not self.enabled:
            return
        digest = snap.get("sql_digest") or ""
        if not digest:
            return
        now = self._now()
        with self._mu:
            self._maybe_seal_locked(now)
            d = self._live.get(digest)
            fresh = d is None
            if fresh:
                d = self._live[digest] = DigestStats(digest)
            d.exec_count += 1
            d.errors += 0 if success else 1
            d.cpu_ns += snap["cpu_ns"]
            d.device_ns += snap["device_ns"]
            d.compile_ns += snap["compile_ns"]
            d.backoff_ms += snap["backoff_ms"]
            d.queue_ms += snap["queue_ms"]
            d.bytes_to_device += snap["bytes_to_device"]
            d.cop_cache_hits += snap["cop_cache_hits"]
            d.plan_cache_hits += 1 if plan_cache_hit else 0
            if snap.get("plan_digest"):
                d.plan_digest = snap["plan_digest"]
            if not d.sample_sql and snap.get("sample_sql"):
                d.sample_sql = snap["sample_sql"]
            t = self.totals
            t["exec_count"] += 1
            t["cpu_ns"] += snap["cpu_ns"]
            t["device_ns"] += snap["device_ns"]
            t["compile_ns"] += snap["compile_ns"]
            t["backoff_ms"] += snap["backoff_ms"]
            t["queue_ms"] += snap["queue_ms"]
            ew = self._cost.get(digest)
            if ew is None:
                if len(self._cost) >= _MAX_EWMAS:
                    self._cost.pop(next(iter(self._cost)))
                ew = self._cost[digest] = _Ewma()
            else:
                self._cost[digest] = self._cost.pop(digest)  # LRU refresh
            ew.update(float(snap["cpu_ns"] + snap["device_ns"]))
            live_n = len(self._live)
        # the counter mirror is BATCHED at seal time (_seal_locked): one
        # metric-lock round-trip per window instead of five per statement
        # — after any rotate the counters equal the sealed-window sums
        # exactly, which is when the byte-consistency reconciliation reads
        # them. Only the live-digest gauge moves here, and only when a
        # digest first appears (steady-state hot path: zero metric locks).
        if fresh:
            metrics.TOPSQL_LIVE_DIGESTS.set(live_n)

    # ----------------------------------------------------------- windows
    def _maybe_seal_locked(self, now: float) -> int:  # requires: _mu
        """Seal the live window if its span elapsed. Empty spans advance
        the start without minting empty windows."""
        sealed = 0
        if now - self._live_start < self.window_s:
            return 0
        if self._live:
            sealed = self._seal_locked(now)
        self._live_start = now
        return sealed

    def _seal_locked(self, now: float) -> int:  # requires: _mu
        end = min(now, self._live_start + self.window_s)
        keep: set = set()
        rows = list(self._live.values())
        # deferred counter mirror: the whole window's sums land in one
        # round-trip per family (record_statement stays metric-lock-free)
        recs = cpu = dev = comp = 0
        back = qms = 0.0
        for st in rows:
            recs += st.exec_count
            cpu += st.cpu_ns
            dev += st.device_ns
            comp += st.compile_ns
            back += st.backoff_ms
            qms += st.queue_ms
        metrics.TOPSQL_RECORDS.inc(recs)
        if cpu:
            metrics.TOPSQL_CPU_NS.inc(cpu)
        if dev:
            metrics.TOPSQL_DEVICE_NS.inc(dev)
        if comp:
            metrics.TOPSQL_COMPILE_NS.inc(comp)
        if back:
            metrics.TOPSQL_BACKOFF_MS.inc(back)
        if qms:
            metrics.TOPSQL_QUEUE_MS.inc(qms)
        for m in WINDOW_METRICS:
            ranked = sorted(rows, key=lambda d, m=m: (-getattr(d, m), d.digest))
            keep.update(d.digest for d in ranked[: self.top_k])
        top = {dg: st for dg, st in self._live.items() if dg in keep}
        others = None
        folded = [st for dg, st in self._live.items() if dg not in keep]
        if folded:
            others = DigestStats(OTHERS_DIGEST)
            for st in folded:
                others.merge(st)
            metrics.TOPSQL_OTHERS_FOLDED.inc(len(folded))
        self._ring.append(_Window(self._live_start, end, top, others))
        self._live = {}
        metrics.TOPSQL_WINDOWS_SEALED.inc()
        metrics.TOPSQL_LIVE_DIGESTS.set(0)
        return 1

    def rotate(self, force: bool = False) -> int:
        """Seal the live window when due (`force` seals a non-empty live
        window regardless of age — tests and shutdown flushes). The PD
        tick's `topsql.report` phase calls this on a clock so windows
        rotate even on an idle SQL front end."""
        now = self._now()
        with self._mu:
            if force and self._live:
                n = self._seal_locked(now)
                self._live_start = now
                return n
            return self._maybe_seal_locked(now)

    # ------------------------------------------------------------- views
    def windows_view(self, include_live: bool = True) -> list[dict]:
        """JSON-able window list, oldest first, live window (if any and
        requested) last with `"live": true`. The information_schema
        memtable, the HTTP API and the tests all consume THIS — one
        serializer, so the surfaces cannot drift."""
        now = self._now()
        with self._mu:
            self._maybe_seal_locked(now)
            out = []
            for w in self._ring:
                rows = sorted(
                    w.top.values(),
                    key=lambda d: (-(d.cpu_ns + d.device_ns), d.digest),
                )
                out.append({
                    "start": w.start,
                    "end": w.end,
                    "live": False,
                    "digests": [d.as_dict() for d in rows],
                    "others": w.others.as_dict() if w.others is not None else None,
                })
            if include_live and self._live:
                rows = sorted(
                    self._live.values(),
                    key=lambda d: (-(d.cpu_ns + d.device_ns), d.digest),
                )
                out.append({
                    "start": self._live_start,
                    "end": now,
                    "live": True,
                    "digests": [d.as_dict() for d in rows],
                    "others": None,
                })
            return out

    def digest_view(self, digest: str) -> dict:
        """One digest across the retained windows + its cost state."""
        windows = []
        for w in self.windows_view():
            for row in w["digests"]:
                if row["digest"] == digest:
                    windows.append(dict(row, window_start=w["start"],
                                        window_end=w["end"], live=w["live"]))
        with self._mu:
            ew = self._cost.get(digest)
            ewma = ew.value if ew is not None else None
            n = ew.n if ew is not None else 0
        return {
            "digest": digest,
            "cost_class": self._class_of(ewma),
            "ewma_cost_ns": ewma,
            "measured_executions": n,
            "windows": windows,
        }

    # -------------------------------------------------------- cost model
    @staticmethod
    def _class_of(ewma_ns: float | None) -> str:
        if ewma_ns is None:
            return DEFAULT_CLASS
        for name, bound in CLASS_BOUNDS_NS:
            if ewma_ns < bound:
                return name
        return "heavy"

    def cost_class(self, digest: str | None) -> str:
        """Measured cost class for the digest; DEFAULT_CLASS until the
        first execution lands (never guessed from the statement text)."""
        if not digest:
            return DEFAULT_CLASS
        with self._mu:
            ew = self._cost.get(digest)
            return self._class_of(ew.value if ew is not None else None)

    def weight(self, digest: str | None) -> int:
        return CLASS_WEIGHTS[self.cost_class(digest)]


COLLECTOR = TopSQLCollector()
