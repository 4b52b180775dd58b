"""Slow-query log + statement summary (ref: pkg/executor/adapter.go:1580
ExecStmt.LogSlowQuery and pkg/util/stmtsummary — the reference writes slow
entries to the slow log file and aggregates per SQL digest into
`information_schema.statements_summary`; here both live in one in-process
registry shared by every session of a catalog (the domain analog) and are
served as information_schema memtables).

Digests normalize the SQL through the real lexer: literals become '?', so
`select * from t where a = 5` and `... a = 7` share one summary row, the
same way the reference's parser.NormalizeDigest works.

Copy of `tidb_tpu/util/stmtlog.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field


def normalize_sql(sql: str) -> tuple[str, str]:
    """(normalized text, hex digest). Literals -> '?', idents lowered —
    the parser.Normalize/Digest analog.

    FALLBACK ONLY: every statement that went through the
    session already carries the plan-cache probe's identical pair from
    its one lexer pass, and `record()` takes it via `norm_digest` — this
    re-lex serves only direct `record()` callers (tests, tools) and the
    unlexable-statement path. Slow log, statement summary, Top SQL and
    the plan cache therefore share ONE digest per statement by
    construction."""
    from ..parser.lexer import T, tokenize

    try:
        toks = tokenize(sql)
    except Exception:  # noqa: BLE001 — unlexable SQL still gets a digest
        norm = " ".join(sql.split()).lower()
        return norm, hashlib.sha256(norm.encode()).hexdigest()[:32]
    parts = []
    for t in toks:
        if t.kind is T.EOF:
            break
        if t.kind in (T.NUMBER, T.STRING):
            parts.append("?")
        elif t.kind in (T.IDENT, T.QIDENT):
            # quoted and bare identifiers normalize identically (lookups
            # are case-insensitive, so `T` and t are one statement)
            parts.append(t.text.lower())
        else:
            parts.append(t.text)
    norm = " ".join(parts)
    return norm, hashlib.sha256(norm.encode()).hexdigest()[:32]


@dataclass
class SlowLogEntry:
    """(ref: the slow-log fields adapter.go writes: Time, Query_time, SQL,
    digest, result rows, success). plan_digest joins slow-log rows against
    statement summaries (ref: the Plan_digest slow-log field)."""

    ts: float
    duration_ms: float
    sql: str
    digest: str
    rows: int
    success: bool
    error: str = ""
    plan_digest: str = ""


@dataclass
class StmtSummary:
    """(ref: stmtsummary.stmtSummaryByDigest)."""

    digest: str
    normalized: str
    sample_sql: str
    exec_count: int = 0
    sum_latency_ms: float = 0.0
    max_latency_ms: float = 0.0
    min_latency_ms: float = float("inf")
    sum_rows: int = 0
    errors: int = 0
    last_seen: float = 0.0
    sum_cpu_ms: float = 0.0  # thread CPU time (the Top SQL attribution,
    # ref: pkg/util/topsql/collector — per-digest CPU sampling; in-process
    # the exact thread_time delta replaces statistical sampling)
    # resource-tag attribution: the Top SQL sinks' per-statement
    # totals, folded here so statements_summary answers avg/max device and
    # wait costs per digest without a join against the windowed reporter
    sum_device_ns: int = 0
    max_device_ns: int = 0
    sum_compile_ns: int = 0
    sum_backoff_ms: float = 0.0
    sum_queue_ms: float = 0.0

    @property
    def avg_latency_ms(self) -> float:
        return self.sum_latency_ms / self.exec_count if self.exec_count else 0.0

    @property
    def avg_device_ns(self) -> float:
        return self.sum_device_ns / self.exec_count if self.exec_count else 0.0


class StmtLog:
    """Shared per-catalog registry: bounded slow-query ring + per-digest
    summaries (LRU-bounded like tidb_stmt_summary_max_stmt_count)."""

    def __init__(self, slow_capacity: int = 512, max_digests: int = 3000):
        self._lock = threading.Lock()
        self.slow: list[SlowLogEntry] = []  # guarded_by: _lock
        self.slow_capacity = slow_capacity
        self.summaries: dict[str, StmtSummary] = {}  # guarded_by: _lock
        self.max_digests = max_digests

    def record(
        self,
        sql: str,
        duration_ms: float,
        rows: int,
        success: bool,
        error: str = "",
        slow_threshold_ms: float | None = 300.0,
        summary_enabled: bool = True,
        cpu_ms: float = 0.0,
        plan_digest: str = "",
        norm_digest: tuple[str, str] | None = None,
        attr: dict | None = None,
    ):
        # a FAILED statement leaves a slow-log artifact regardless of the
        # threshold (slow log still enabled) — a fast-failing dispatch
        # error is exactly the query one needs to find afterwards (ref:
        # adapter.go LogSlowQuery records failed statements with their error)
        is_slow = slow_threshold_ms is not None and (duration_ms > slow_threshold_ms or not success)
        if not summary_enabled and not is_slow:
            return  # neither sink wants it: skip the lexer+digest pass
        # the session hands its already-computed (normalized, digest) pair
        # when it lexed the statement anyway (the plan-cache probe), and
        # EXECUTE hands the UNDERLYING prepared statement's pair so the
        # run joins that summary row instead of the "execute s" shape
        norm, digest = norm_digest if norm_digest is not None else normalize_sql(sql)
        now = time.time()
        with self._lock:
            if summary_enabled:
                s = self.summaries.get(digest)
                if s is None:
                    if len(self.summaries) >= self.max_digests:
                        # evict the least-recently-seen digest
                        victim = min(self.summaries.values(), key=lambda x: x.last_seen)
                        del self.summaries[victim.digest]
                    s = StmtSummary(digest, norm, sql[:256])
                    self.summaries[digest] = s
                s.exec_count += 1
                s.sum_latency_ms += duration_ms
                s.max_latency_ms = max(s.max_latency_ms, duration_ms)
                s.min_latency_ms = min(s.min_latency_ms, duration_ms)
                s.sum_rows += rows
                s.errors += 0 if success else 1
                s.sum_cpu_ms += cpu_ms
                if attr is not None:  # the statement's resource-tag totals
                    s.sum_device_ns += attr.get("device_ns", 0)
                    s.max_device_ns = max(s.max_device_ns, attr.get("device_ns", 0))
                    s.sum_compile_ns += attr.get("compile_ns", 0)
                    s.sum_backoff_ms += attr.get("backoff_ms", 0.0)
                    s.sum_queue_ms += attr.get("queue_ms", 0.0)
                s.last_seen = now
            if is_slow:
                self.slow.append(
                    SlowLogEntry(now, duration_ms, sql[:4096], digest, rows, success,
                                 error, plan_digest)
                )
                if len(self.slow) > self.slow_capacity:
                    del self.slow[: len(self.slow) - self.slow_capacity]

    def top_sql(self, n: int = 30) -> list[StmtSummary]:
        """Top digests by cumulative CPU time (ref: pkg/util/topsql's
        top-N reporter over the per-digest CPU attribution)."""
        with self._lock:
            return sorted(self.summaries.values(), key=lambda s: -s.sum_cpu_ms)[:n]

    def slow_entries(self) -> list[SlowLogEntry]:
        with self._lock:
            return list(self.slow)

    def summary_rows(self) -> list[StmtSummary]:
        with self._lock:
            return sorted(self.summaries.values(), key=lambda s: -s.sum_latency_ms)

    def clear(self):
        with self._lock:
            self.slow.clear()
            self.summaries.clear()
