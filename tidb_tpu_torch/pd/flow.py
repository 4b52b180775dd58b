"""Region flow collection — what the data plane tells the PD
(ref: pdpb.RegionHeartbeatRequest: bytes_written/bytes_read,
keys_written/keys_read, approximate_size/approximate_keys; TiKV fills
these from its flow observer, store/worker/pd_worker collects them into
the heartbeat stream).

In one process there is no heartbeat RPC: the store's coprocessor path
calls `record_read` per served region task and the write paths (direct
puts, 2PC commit apply, bulk ingest) call `record_write` per key. The PD
tick drains the interval deltas with `heartbeat()` — the snapshot IS the
heartbeat — while the approximate size/keys totals persist as the
region's running stats (the split/merge checkers' input).

Copy of `tidb_tpu/pd/flow.py` for the PyTorch port."""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class RegionFlow:
    """Per-region counters: interval deltas (reset by each heartbeat
    drain) plus running approximate totals (never reset; redistributed on
    split/merge like the reference's approximate_size bookkeeping)."""

    region_id: int
    read_bytes: int = 0
    read_keys: int = 0
    write_bytes: int = 0
    write_keys: int = 0
    approx_size: int = 0  # logical live-data bytes (overwrites replace,
    # deletes shrink by the mean entry size) — approximate
    approx_keys: int = 0  # live-key estimate (tombstones decrement)


@dataclass(frozen=True)
class RegionHeartbeat:
    """One region's heartbeat snapshot (ref: pdpb.RegionHeartbeatRequest,
    the flow subset the schedulers consume)."""

    region_id: int
    read_bytes: int
    read_keys: int
    write_bytes: int
    write_keys: int
    approx_size: int
    approx_keys: int


class FlowRecorder:
    """Thread-safe flow sink shared by the cop pool workers and the txn
    commit path; key->region attribution goes through the cluster's
    locate (the region the key lives in NOW, matching how TiKV's
    flow observer attributes to the serving peer)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._mu = threading.Lock()
        self._flows: dict[int, RegionFlow] = {}  # guarded_by: _mu

    def _flow(self, region_id: int) -> RegionFlow:  # requires: _mu
        f = self._flows.get(region_id)
        if f is None:
            f = self._flows[region_id] = RegionFlow(region_id)
        return f

    # -- data-plane hooks ---------------------------------------------------
    def record_read(self, region_id: int, nbytes: int, keys: int) -> None:
        """One served cop task: decoded bytes + rows scanned."""
        with self._mu:
            f = self._flow(region_id)
            f.read_bytes += nbytes
            f.read_keys += keys

    def record_write(self, key: bytes, nbytes: int, prev_live: bool = False,
                     delete: bool = False) -> None:
        """One applied KV mutation (put_row / commit apply / ingest).
        `prev_live` (from MemKV.put) discriminates insert / overwrite /
        delete so the approximate totals track LOGICAL size: an overwrite
        is traffic but not growth, a delete of a live key shrinks by the
        region's mean entry size."""
        region_id = self.cluster.locate(key).region_id
        with self._mu:
            self._apply_write(region_id, key, nbytes, prev_live, delete)

    def record_writes(self, items) -> None:
        """Batch form for commit/ingest appliers: items of
        (key, nbytes, prev_live, delete). Region attribution resolves
        first (cluster lock), then one flow-lock pass applies — callers
        invoke this AFTER releasing the kv critical section so readers
        never wait on flow bookkeeping."""
        located = [
            (self.cluster.locate(k).region_id, k, n, p, d)
            for k, n, p, d in items
        ]
        with self._mu:
            for rid, k, n, p, d in located:
                self._apply_write(rid, k, n, p, d)

    def _apply_write(self, region_id: int, key: bytes, nbytes: int,  # requires: _mu
                     prev_live: bool, delete: bool) -> None:
        f = self._flow(region_id)
        f.write_bytes += nbytes + len(key)
        f.write_keys += 1
        if delete:
            if prev_live:
                mean = f.approx_size // max(f.approx_keys, 1)
                f.approx_size = max(f.approx_size - mean, 0)
                f.approx_keys = max(f.approx_keys - 1, 0)
        elif not prev_live:
            f.approx_size += nbytes + len(key)
            f.approx_keys += 1
        # overwrite of a live key: the new version logically replaces the
        # old (GC reclaims it), so approximate totals stay put

    # -- PD-side consumption ------------------------------------------------
    def heartbeat(self) -> list[RegionHeartbeat]:
        """Drain interval deltas into heartbeat snapshots, one per LIVE
        region (merged-away regions are pruned here; zero-traffic regions
        still report, which is what lets the hot caches decay them)."""
        live = {r.region_id for r in self.cluster.regions()}
        with self._mu:
            for rid in [rid for rid in self._flows if rid not in live]:
                del self._flows[rid]
            for rid in live:
                self._flow(rid)  # a region with no traffic yet still beats
            beats = [
                RegionHeartbeat(
                    f.region_id, f.read_bytes, f.read_keys,
                    f.write_bytes, f.write_keys, f.approx_size, f.approx_keys,
                )
                for f in self._flows.values()
            ]
            for f in self._flows.values():
                f.read_bytes = f.read_keys = f.write_bytes = f.write_keys = 0
        return beats

    def stats(self) -> dict[int, tuple[int, int]]:
        """region_id -> (approx_size, approx_keys) running totals."""
        with self._mu:
            return {rid: (f.approx_size, f.approx_keys) for rid, f in self._flows.items()}

    # -- topology-change bookkeeping ----------------------------------------
    def on_split(self, parent_id: int, child_id: int) -> None:
        """A split halves the parent's approximate totals into the child
        (ref: the approximate redistribution PD applies until the next
        real heartbeat corrects it)."""
        with self._mu:
            p = self._flow(parent_id)
            c = self._flow(child_id)
            c.approx_size, p.approx_size = p.approx_size // 2, p.approx_size - p.approx_size // 2
            c.approx_keys, p.approx_keys = p.approx_keys // 2, p.approx_keys - p.approx_keys // 2

    def on_merge(self, left_id: int, right_id: int) -> None:
        """A merge folds the absorbed region's totals AND pending deltas
        into the survivor."""
        with self._mu:
            right = self._flows.pop(right_id, None)
            if right is None:
                return
            left = self._flow(left_id)
            left.read_bytes += right.read_bytes
            left.read_keys += right.read_keys
            left.write_bytes += right.write_bytes
            left.write_keys += right.write_keys
            left.approx_size += right.approx_size
            left.approx_keys += right.approx_keys
