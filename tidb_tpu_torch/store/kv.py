"""In-memory MVCC key-value engine (ref: unistore/tikv/mvcc.go MVCCStore on
badger + lockstore).

A sorted-array store with timestamped versions: enough Percolator surface
for snapshot reads and the write path (put at commit_ts, delete as
tombstone), without the lock column family — single-process writes are
serialized by the session layer for now (2PC lands with the txn layer).

Copy of `tidb_tpu/store/kv.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field


class MemKV:
    __slots__ = ("_data", "_keys", "_dirty", "lock", "max_version")

    def __init__(self):
        self._data: dict[bytes, list[tuple[int, bytes | None]]] = {}  # guarded_by: lock
        self._keys: list[bytes] = []  # guarded_by: lock
        self._dirty = False  # guarded_by: lock
        # largest commit_ts ever written: a snapshot at start_ts >=
        # max_version sees EVERY committed version, which is what makes a
        # coprocessor response reusable across snapshots (store cop cache)
        self.max_version = 0  # guarded_by: lock
        # structural lock: every read/write takes it, and TxnEngine.commit
        # holds it across the WHOLE apply loop, so a concurrent snapshot
        # read can never observe half a commit (the docstring invariant of
        # store/txn.py); RLock so the engine can nest puts under it
        self.lock = threading.RLock()

    def put(self, key: bytes, value: bytes | None, ts: int) -> bool:
        """value None = tombstone. Returns whether the key had a LIVE
        (non-tombstone) latest version before this put — the flow
        recorder's insert/update/delete discriminator."""
        with self.lock:
            versions = self._data.get(key)
            prev_live = bool(versions) and versions[-1][1] is not None
            if versions is None:
                self._data[key] = [(ts, value)]
                self._dirty = True
            else:
                versions.append((ts, value))
                if len(versions) > 1 and versions[-2][0] > ts:
                    versions.sort(key=lambda v: v[0])
            if ts > self.max_version:
                self.max_version = ts
            return prev_live

    def _ensure_sorted(self):  # requires: lock
        if self._dirty:
            self._keys = sorted(self._data.keys())
            self._dirty = False

    def get(self, key: bytes, ts: int) -> bytes | None:
        with self.lock:
            versions = self._data.get(key)
            if not versions:
                return None
            # newest version with commit_ts <= ts
            for vts, val in reversed(versions):
                if vts <= ts:
                    return val
            return None

    def scan(self, start: bytes, end: bytes, ts: int, limit: int | None = None):
        """Yield (key, value) with start <= key < end visible at ts.
        The result set is materialized under the lock — one consistent cut."""
        with self.lock:
            self._ensure_sorted()
            i = bisect.bisect_left(self._keys, start)
            out = []
            while i < len(self._keys):
                k = self._keys[i]
                if k >= end:
                    break
                v = self.get(k, ts)
                if v is not None:
                    out.append((k, v))
                    if limit is not None and len(out) >= limit:
                        break
                i += 1
        return iter(out)

    def scan_versions(self, start: bytes, end: bytes, lo_ts: int, hi_ts: int):
        """Every committed version of keys in [start, end) with
        lo_ts < commit_ts <= hi_ts, as (key, commit_ts, value|None) in key
        order — the CDC incremental scan (ref: TiCDC's kv client scanning
        the range from checkpoint-ts when a region subscription (re)opens;
        tombstones ride along so deletes replay downstream). One
        consistent cut: materialized under the lock."""
        out = []
        with self.lock:
            self._ensure_sorted()
            i = bisect.bisect_left(self._keys, start)
            while i < len(self._keys):
                k = self._keys[i]
                if k >= end:
                    break
                for vts, val in self._data.get(k, ()):
                    if lo_ts < vts <= hi_ts:
                        out.append((k, vts, val))
                i += 1
        return out

    def gc(self, safepoint: int) -> int:
        """MVCC garbage collection at `safepoint`: per key, keep every
        version newer than the safepoint plus the newest one at-or-below
        it (the version a safepoint-old snapshot still reads); if that
        survivor is a tombstone nothing can ever read, drop it too
        (ref: pkg/store/gcworker/gc_worker.go resolve + delete-versions).
        Returns the number of versions removed."""
        removed = 0
        with self.lock:
            for key in list(self._data):
                versions = self._data[key]  # ascending commit_ts
                newest_le = None
                keep = []
                for vts, val in versions:
                    if vts <= safepoint:
                        newest_le = (vts, val)
                    else:
                        keep.append((vts, val))
                if newest_le is not None and newest_le[1] is not None:
                    keep.insert(0, newest_le)
                removed += len(versions) - len(keep)
                if keep:
                    self._data[key] = keep
                else:
                    del self._data[key]
                    self._dirty = True
        return removed

    def latest_ts(self, key: bytes) -> int:
        """Commit ts of the newest version of `key` (0 if none) — the
        write-conflict check input (ref: mvcc.go checkConflict)."""
        with self.lock:
            versions = self._data.get(key)
            return versions[-1][0] if versions else 0

    def max_ts(self) -> int:
        # vet(lock-discipline) finding: this walked _data with no lock —
        # a concurrent put resizing the dict mid-iteration raises
        ts = 0
        with self.lock:
            for versions in self._data.values():
                if versions:
                    ts = max(ts, versions[-1][0])
        return ts

    def max_committed(self) -> int:
        """Locked snapshot of max_version (for callers that must not
        take `lock` around their own critical sections)."""
        with self.lock:
            return self.max_version

    def __len__(self):
        with self.lock:
            return len(self._data)
