"""Memory tracking (ref: pkg/util/memory — Tracker tree with quotas and
OOM action chain: spill / cancel / log).

Trackers form a parent tree; consumption propagates to the root. Exceeding
a tracker's quota runs its action (default: raise QuotaExceeded — the
'cancel' action; callers can install softer actions such as cache
eviction, the spill analog).

Copy of `tidb_tpu/util/memory.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading


class QuotaExceeded(MemoryError):
    def __init__(self, tracker: "MemTracker", requested: int):
        super().__init__(
            f"memory quota exceeded: tracker {tracker.label!r} at "
            f"{tracker.consumed} + {requested} > {tracker.quota}"
        )
        self.tracker = tracker


class MemTracker:
    def __init__(self, label: str, quota: int | None = None, parent: "MemTracker | None" = None, action=None):
        self.label = label
        self.quota = quota
        self.parent = parent
        self.action = action  # callable(tracker, requested) -> None; may free
        self._consumed = 0  # guarded_by: _lock
        self._peak = 0  # guarded_by: _lock
        self._lock = threading.Lock()

    @property
    def consumed(self) -> int:
        with self._lock:
            return self._consumed

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def consume(self, n: int):
        """Account n bytes (negative releases). Over-quota runs the action
        once, then re-checks; still over -> QuotaExceeded."""
        with self._lock:
            self._consumed += n
            self._peak = max(self._peak, self._consumed)
            over = self.quota is not None and n > 0 and self._consumed > self.quota
        if over:
            if self.action is not None:
                self.action(self, n)
                with self._lock:
                    over = self.quota is not None and self._consumed > self.quota
            if over:
                raise QuotaExceeded(self, n)
        if self.parent is not None:
            self.parent.consume(n)

    def release_all(self):
        with self._lock:
            n = self._consumed
            self._consumed = 0
        if self.parent is not None and n:
            self.parent.consume(-n)
