"""Percolator transaction engine over MemKV (ref: unistore/tikv/mvcc.go
MVCCStore prewrite/commit + lockstore; client-go 2PC driver;
pkg/store/driver/txn/txn_driver.go).

The reference splits 2PC across the client (primary selection, parallel
prewrite, commit point) and the store (lock CF, write CF, conflict checks).
In one process both halves collapse into this engine:

  prewrite   lock every mutated key after write-conflict + lock checks
  commit     apply buffered values at commit_ts, release locks (atomic
             under the engine mutex — readers never observe a partial
             commit, which is why snapshot reads here do not need the
             reference's lock-wait/resolve path)
  rollback   drop this txn's locks
  pessimistic lock
             conflict-checked intention locks taken at DML time
             (ref: acquire pessimistic lock, mvcc.go; lock converts to a
             prewrite lock at commit)

Failure semantics match Percolator where observable in-process:
  KeyIsLocked    another live txn holds the key (no wait queue — the
                 caller surfaces a lock-conflict error immediately)
  WriteConflict  a commit landed after this txn's snapshot/for_update ts

Copy of `tidb_tpu/store/txn.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

from .kv import MemKV


class TxnError(Exception):
    pass


class KeyIsLocked(TxnError):
    def __init__(self, key: bytes, holder_ts: int):
        super().__init__(f"key is locked by txn {holder_ts}")
        self.key, self.holder_ts = key, holder_ts


class WriteConflict(TxnError):
    def __init__(self, key: bytes, conflict_ts: int, start_ts: int):
        super().__init__(
            f"write conflict: key committed at {conflict_ts} > txn start {start_ts}"
        )
        self.key, self.conflict_ts, self.start_ts = key, conflict_ts, start_ts


@dataclass
class Lock:
    """(ref: lockstore entry / kvrpcpb.LockInfo)."""

    primary: bytes
    start_ts: int
    op: str  # "prewrite" | "pessimistic"
    value: bytes | None = None  # buffered write (prewrite only)
    is_delete: bool = False
    for_update_ts: int = 0


class TxnEngine:
    def __init__(self, kv: MemKV, on_commit=None, on_apply=None,
                 pre_apply=None, write_guard=None, on_apply_group=None):
        self.kv = kv
        self.locks: dict[bytes, Lock] = {}  # guarded_by: _mu
        self._mu = threading.RLock()
        self._on_commit = on_commit  # store cache-invalidation hook
        self._on_apply = on_apply  # batch hook: ([(key, value|None,
        # prev_live)], commit_ts) called AFTER the kv critical section
        # (PD write flow + replication proposal + CDC delivery)
        self._on_apply_group = on_apply_group  # group-commit hook:
        # ([(applied, commit_ts)]) for a whole coalesced window at once,
        # so the store can fold every lane's changes into ONE replication
        # proposal per region (falls back to per-lane _on_apply when unset)
        self._pre_apply = pre_apply  # keys hook BEFORE any apply: may raise
        # (the store's write-quorum gate — a refused commit applies nothing)
        self._write_guard = write_guard  # zero-arg ctx factory wrapping
        # [commit-ts draw .. change delivery]: the CDC resolved-ts sampler
        # treats the window as an in-flight write (cdc/hub.py WriteGuard)

    def _guard(self):
        return self._write_guard() if self._write_guard is not None else nullcontext()

    # ------------------------------------------------------------------
    def acquire_pessimistic(self, keys: list, primary: bytes, start_ts: int, for_update_ts: int):
        """Intention locks for pessimistic DML (ref: mvcc.go pessimistic
        lock path): conflict-checked against commits newer than
        for_update_ts, held until commit/rollback."""
        with self._mu:
            for k in keys:
                l = self.locks.get(k)
                if l is not None and l.start_ts != start_ts:
                    raise KeyIsLocked(k, l.start_ts)
            for k in keys:
                cts = self.kv.latest_ts(k)
                if cts > for_update_ts:
                    raise WriteConflict(k, cts, for_update_ts)
            for k in keys:
                if k not in self.locks:
                    self.locks[k] = Lock(primary, start_ts, "pessimistic", for_update_ts=for_update_ts)

    def prewrite(self, mutations: dict, primary: bytes, start_ts: int):
        """mutations: key -> value bytes (None = delete tombstone)."""
        with self._mu:
            for k in mutations:
                l = self.locks.get(k)
                if l is not None and l.start_ts != start_ts:
                    raise KeyIsLocked(k, l.start_ts)
            for k in mutations:
                l = self.locks.get(k)
                if l is not None and l.op == "pessimistic":
                    continue  # conflict already checked at for_update_ts
                cts = self.kv.latest_ts(k)
                if cts > start_ts:
                    raise WriteConflict(k, cts, start_ts)
            for k, v in mutations.items():
                self.locks[k] = Lock(primary, start_ts, "prewrite", v, v is None)

    def commit(self, keys: list, start_ts: int, commit_ts):
        """commit_ts: an int, or a callable TSO source. When callable, the
        timestamp is drawn INSIDE the kv critical section: with a monotone
        TSO, no reader can have obtained read_ts >= commit_ts before the
        whole apply is visible — snapshot isolation without the reference's
        lock-wait/resolve read path. Returns the commit_ts used."""
        applied = []
        with self._guard():  # entered BEFORE the commit ts is drawn
            with self._mu:
                staged = []
                for k in keys:
                    l = self.locks.get(k)
                    if l is None or l.start_ts != start_ts:
                        raise TxnError(f"lock not found for commit (txn {start_ts})")
                    if l.op != "prewrite":
                        raise TxnError("commit before prewrite (pessimistic lock not converted)")
                    staged.append((k, l))
                if self._pre_apply is not None and staged:
                    # the write-quorum gate: raises BEFORE anything applies,
                    # so a quorum-lost region refuses the whole commit (the
                    # caller's locks stay put for its rollback path)
                    self._pre_apply([k for k, _ in staged])
                with self.kv.lock:  # readers see all of the commit or none
                    if callable(commit_ts):
                        commit_ts = commit_ts()
                    for k, l in staged:
                        v = None if l.is_delete else l.value
                        prev = self.kv.put(k, v, commit_ts)
                        del self.locks[k]
                        applied.append((k, v, prev))
            if self._on_apply is not None and applied:
                self._on_apply(applied, commit_ts)  # outside the locks —
                # flow bookkeeping must never extend the window in which
                # readers are blocked
        if self._on_commit is not None and staged:
            self._on_commit()
        return commit_ts

    def rollback(self, keys: list, start_ts: int):
        with self._mu:
            for k in keys:
                l = self.locks.get(k)
                if l is not None and l.start_ts == start_ts:
                    del self.locks[k]

    def release_all(self, start_ts: int):
        """Drop every lock a txn holds (rollback convenience)."""
        with self._mu:
            for k in [k for k, l in self.locks.items() if l.start_ts == start_ts]:
                del self.locks[k]

    # ------------------------------------------------------------------
    def commit_txn(self, mutations: dict, start_ts: int, commit_ts):
        """Full 2PC for an in-process txn: prewrite everything (primary =
        first key), then commit. Raises without side effects on conflict;
        pessimistic locks this txn already holds are converted.
        commit_ts may be a callable TSO source (see commit)."""
        if not mutations:
            return None
        keys = list(mutations)
        primary = keys[0]
        try:
            self.prewrite(mutations, primary, start_ts)
        except TxnError:
            self.release_all(start_ts)
            raise
        return self.commit(keys, start_ts, commit_ts)

    def commit_group(self, reqs: list, tso) -> list:
        """Group commit: 2PC several independent autocommit
        transactions in ONE write-guard window and ONE kv critical
        section, each lane committing at its OWN timestamp drawn from
        `tso` in lane order. reqs: [(mutations dict, start_ts)]. Returns
        one result per lane: the commit_ts on success, or the exception
        instance for a lane that fell out (conflict / refused quorum —
        its locks are released; the window stands for the other lanes).
        The per-lane sequence is exactly commit_txn's — prewrite, quorum
        gate, apply, release — so a group of one is byte-equivalent to
        the single path."""
        results: list = [None] * len(reqs)
        staged_lanes: list = []  # (idx, keys, start_ts)
        applied_lanes: list = []  # (applied, commit_ts)
        with self._guard():  # entered BEFORE any commit ts is drawn
            with self._mu:
                for i, (mutations, start_ts) in enumerate(reqs):
                    if not mutations:
                        continue
                    keys = list(mutations)
                    try:
                        self.prewrite(mutations, keys[0], start_ts)
                        if self._pre_apply is not None:
                            self._pre_apply(keys)
                    except Exception as exc:  # TxnError | QuorumLostError
                        self.release_all(start_ts)
                        results[i] = exc
                        continue
                    staged_lanes.append((i, keys, start_ts))
                with self.kv.lock:  # readers see all of a lane or none
                    for i, keys, start_ts in staged_lanes:
                        cts = tso()
                        applied = []
                        for k in keys:
                            l = self.locks[k]
                            v = None if l.is_delete else l.value
                            prev = self.kv.put(k, v, cts)
                            del self.locks[k]
                            applied.append((k, v, prev))
                        results[i] = cts
                        applied_lanes.append((applied, cts))
            if applied_lanes:  # outside the locks, inside the guard —
                # same bracket as the single path's _on_apply
                if self._on_apply_group is not None:
                    self._on_apply_group(applied_lanes)
                elif self._on_apply is not None:
                    for applied, cts in applied_lanes:
                        self._on_apply(applied, cts)
        if applied_lanes and self._on_commit is not None:
            self._on_commit()
        return results

    def check_unlocked(self, keys, start_ts: int = 0):
        """Raise KeyIsLocked if any key is held by another transaction —
        the guard bulk ingest (LOAD DATA, BR restore) runs before writing
        around the lock table (ref: Lightning conflict with live txns)."""
        with self._mu:
            for k in keys:
                l = self.locks.get(k)
                if l is not None and l.start_ts != start_ts:
                    raise KeyIsLocked(k, l.start_ts)

    @contextmanager
    def ingest_guard(self):
        """One critical section for a whole bulk-import batch: the caller
        draws its read/write timestamps, re-runs its duplicate checks, and
        applies the writes all inside — no committed write or prewrite can
        interleave (LOAD DATA / BR restore vs in-flight 2PC; lock order
        engine _mu -> kv.lock matches commit())."""
        with self._mu:
            with self.kv.lock:
                yield

    def bulk_ingest(self, items, ts: int):
        """Atomically verify-and-apply (key, value) pairs (BR restore —
        no value-level duplicate checks needed; LOAD DATA wraps its whole
        check+apply in ingest_guard instead)."""
        applied = []
        with self._guard():
            with self.ingest_guard():
                self.check_unlocked([k for k, _ in items])
                if self._pre_apply is not None and items:
                    self._pre_apply([k for k, _ in items])
                for k, v in items:
                    applied.append((k, v, self.kv.put(k, v, ts)))
            if self._on_apply is not None and applied:
                self._on_apply(applied, ts)
