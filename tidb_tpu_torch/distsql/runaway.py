"""Runaway-query control (ref: pkg/resourcegroup/runaway/checker.go — the
RunawayChecker whose BeforeCopRequest hook the coprocessor client calls
before every request, checker.go:27; TiDB's own MAX_EXECUTION_TIME
enforcement rides the same mechanism).

A checker is created per statement from `max_execution_time` (ms, 0 =
unlimited) plus an explicit kill flag (KILL QUERY). The dispatch loop asks
it before every coprocessor task AND every paging round, so a scan that
fans out over many regions dies at the first boundary past the deadline —
the same granularity the reference gets from its per-request hook.

A copy of the JAX package's tidb_tpu/distsql/runaway.py (stdlib only)."""

from __future__ import annotations

import time


class QueryKilledError(Exception):
    """Surfaced as MySQL error 3024 (ER_QUERY_TIMEOUT, `timeout=True`)
    or 1317 (ER_QUERY_INTERRUPTED, explicit KILL) by the session — the
    flag is typed here at the raise site, never parsed from the text."""

    def __init__(self, message: str, timeout: bool = False):
        super().__init__(message)
        self.timeout = timeout


class RunawayChecker:
    def __init__(self, max_execution_ms: int = 0, now_fn=time.monotonic):
        self._now = now_fn
        self._deadline = (
            self._now() + max_execution_ms / 1000.0 if max_execution_ms > 0 else None
        )
        self._killed = False

    def kill(self):
        """KILL QUERY: the next dispatch boundary aborts the statement."""
        self._killed = True

    @property
    def deadline(self) -> float | None:
        """Absolute monotonic deadline (None = unlimited) — the Backoffer
        clamps its sleeps so a statement never sleeps past its own
        MAX_EXECUTION_TIME (it would only wake up to die)."""
        return self._deadline

    def before_cop_request(self):
        """The BeforeCopRequest hook: raise when over budget or killed."""
        if self._killed:
            raise QueryKilledError("Query execution was interrupted")
        if self._deadline is not None and self._now() > self._deadline:
            raise QueryKilledError(
                "Query execution was interrupted, maximum statement execution time exceeded",
                timeout=True,
            )
