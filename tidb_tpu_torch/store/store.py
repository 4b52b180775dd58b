"""The coprocessor store on the card (port of tidb_tpu/store/store.py's
single-request endpoint).

A CopRequest carries the DAG, key ranges, snapshot ts, region id and
epoch, and the broadcast build sides of its joins; the store decodes the
region's rows to a columnar chunk once per region version (the C++ scan
decoder of `native/`, else the Python rowcodec), caches that chunk on the
host and its padded DeviceBatch on `device`, runs the program through
drive_program_info, and answers with the result chunk plus execution
summaries (ref: unistore/cophandler/cop_handler.go:89 HandleCopRequest).
`coprocessor_bytes` is the same endpoint from wire bytes to wire bytes
(codec/wire.py). Whole responses are cached by region data version, and a
DAG the device program cannot run (an op it does not express, or capacity
retries that run out) is answered by the row oracle, run_dag_reference.

`batch_coprocessor` (and `batch_coprocessor_bytes`) serves a store's
region tasks together (ref: copr/batch_coprocessor.go): tasks of one DAG
and snapshot are grouped, bucketed by power-of-two capacity, and each
bucket of regions runs ONE execution of the region-batched program
(drive_batched_program_info); a lane whose flags fired, and a whole
bucket on any error, take the single-request path. A group of requests
with `mesh` set first tries the MESH tier (`_run_cop_mesh`): the group's
lanes split over the store's `mesh_devices` (runtime.mesh_devices), each shard
runs the region-batched program, the partial states merge across the
shards, and the group answers with ONE merged state (`mesh_merged`);
any decline or failure degrades the group to the batched tier.

The store also carries the SQL session's write side: the Percolator
engine (`txn`, store/txn.py; every commit bumps the write version, which
drops the result cache), the registry of open snapshots that bounds MVCC
GC (`register_snapshot`, `run_gc`, `gc_safepoint`), `advance_tso` and the
admission gate (server/admission.py).

And the control plane (ref: tidb_tpu/store/store.py:166-205, 368-467):
`pd` (pd/core.py PlacementDriver) and `replication` (replication/
ReplicaManager). Every write records its flow into the PD heartbeat and
proposes through the region's replication group, after a write-quorum gate
that refuses it (QuorumLostError) when the region's acks cannot reach
quorum: put_row / delete_row / put_index directly, the engine's commits,
group commits and bulk ingests through its on_apply / on_apply_group /
pre_apply hooks. Every served region read records its read flow. A request
routed to a peer (`peer_store`) meets the fault ladder (`_region_fault`):
a down store or the `store/unreachable` failpoint answer StoreUnavailable,
`store/not-leader` and `store/server-busy` their typed errors, a
non-leader peer NotLeader with the leader as the hint, and a replica read
serves only where the peer's safe_ts covers its start_ts, else
DataIsNotReady. The `cop-region-error`, `cop-other-error` and
`cop-debug-raise` failpoints act at the endpoint as in the reference.

Change data capture and the columnar replica (ref: tidb_tpu/store/
store.py:185-196, 247-249, 443-491): `cdc` (cdc/ ChangefeedHub) subscribes
to every replication proposal, and its WriteGuard brackets every write path
([commit-ts draw .. capture delivery]: put_row / delete_row / put_index,
the engine's commits and bulk ingests) so a resolved-ts candidate can prove
quiescence; `columnar` (columnar/ ColumnarReplica) holds the changefeed-fed
replicas, whose stable batches live on `device`; `schema_journal` and
`propose_schema_change` carry a row-shape DDL through the feed.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field, replace

from ..chunk import Chunk, to_device_batch, to_stacked_device_batch
from ..chunk.device import DeviceBatch
from ..codec import tablecodec
from ..codec.rowcodec import RowEncoder, decode_row_to_datum_map, fill_origin_default
from ..exec.builder import DEFAULT_GROUP_CAPACITY, ProgramCache
from ..exec.dag import DAGRequest
from ..exec.executor import (OverflowRetryError, _pow2, drive_batched_program_info, drive_program_info,
                             run_dag_reference)
from ..runtime import mesh_devices as _mesh_devices
from ..runtime import resolve_device
from ..types import Datum
from .kv import MemKV
from .region import Cluster, Region
from .txn import TxnEngine


def _fault_matches(value, store_id: int) -> bool:
    """Per-store failpoint arming: True fires for every store; a
    set/list/tuple of ids fires for those stores; a dict
    `{"stores": ids-or-None, ...}` fires for the listed stores (None =
    all) and may carry extra payload (`backoff_ms` for server-busy); a
    ZERO-arg callable returns any of those shapes per hit (a value
    arriving un-invoked via `failpoint.peek` is asked here).
    None/falsy never fires."""
    if not value:
        return False
    if callable(value):  # peek path hands over the raw callable
        return _fault_matches(value(), store_id)
    if value is True or isinstance(value, int):
        return True
    if isinstance(value, (set, frozenset, list, tuple)):
        return store_id in value
    if isinstance(value, dict):
        stores = value.get("stores")
        return stores is None or store_id in stores
    return True


@dataclass(frozen=True)
class KeyRange:
    """(ref: coprocessor.KeyRange)."""

    start: bytes
    end: bytes


@dataclass
class CopRequest:
    """(ref: coprocessor.Request: tp=DAG, data, ranges, start_ts).

    aux_chunks: broadcast operands for the DAG's join build sides, one per
    non-probe scan in canonical order (the TiFlash broadcast-exchange analog
    — ref: mpp_exec.go:669 Broadcast partition mode). Every region task of a
    broadcast join carries the same chunks; the device upload is shared.

    paging_size: when set, the scan stops after at most this many rows and
    the response carries `last_range`, the resume cursor for the next page
    (ref: copr/coprocessor.go:1393 handleCopPagingResult; store side
    cop_handler.go:210 lastRange). Row-local DAGs only — aggregations
    cannot produce correct partials from a partial scan.

    mesh: the request may take the store's mesh tier (batch_coprocessor
    merges a same-DAG group's partial states across the mesh devices);
    mesh_min_rows: the data-size floor the store holds the group's decoded
    rows to before it tries the mesh."""

    dag: DAGRequest
    ranges: list
    start_ts: int
    region_id: int = 0
    region_epoch: int = 0
    aux_chunks: list = field(default_factory=list)
    paging_size: int | None = None
    small_groups: int | None = None  # planner NDV hint (stats-driven)
    peer_store: int = -1  # the peer the client routed to (-1 = whoever
    # leads at serve time); a non-leader peer answers NotLeader unless
    # replica_read (ref: kvrpcpb.Context.peer)
    replica_read: bool = False  # follower read: a non-leader peer may
    # serve IF its safe_ts covers start_ts, else DataIsNotReady
    # (ref: kvrpcpb.Context.replica_read)
    mesh: bool = False
    mesh_min_rows: int = 0


@dataclass
class ExecSummary:
    """(ref: tipb.ExecutorExecutionSummary, cop_handler.go:518). Extended
    with device-time attribution: where the task's wall time went —
    program build (vs. a program-cache hit) and the bytes the executor
    moved (scan row: decoded region bytes; final row: result bytes)."""

    time_processed_ns: int = 0
    num_produced_rows: int = 0
    num_iterations: int = 1
    time_compile_ns: int = 0  # 0 on a cache hit
    cache_hit: bool = False  # the program came from the cache
    num_bytes: int = 0
    # radix-join attribution: set on the first Join executor whose task
    # rode the radix-partitioned kernel — partition count, the join
    # capacity rung the program was built at, and the skew-escape row
    # count; 0/0/0 = monolithic kernel
    radix_partitions: int = 0
    radix_rung: int = 0
    radix_escapes: int = 0


@dataclass
class CopResponse:
    chunk: Chunk | None = None
    region_error: str | None = None
    other_error: str | None = None
    exec_summaries: list = field(default_factory=list)
    last_range: list | None = None  # [KeyRange] resume cursor; None = drained
    batched: int = 0  # the bucket's id when the batched tier served it
    mesh_merged: int = 0  # the mesh tier served it: the lanes its merged state covers


def _apply_radix_attribution(summaries: list, walk, info) -> None:
    """Fold the executor's radix attribution (exec/executor.py
    _radix_attribution: partitions / capacity rung / skew escapes) onto
    the FIRST Join executor's summary — the triple is program-level, so
    stamping every Join would multiply it in a cross-summary sum; the
    summary indexes align with the executor walk, as the row counts do."""
    ri = info.get("radix") if isinstance(info, dict) else None
    if not ri:
        return
    from ..exec.dag import Join as _Join

    for i, ex in enumerate(walk):
        if isinstance(ex, _Join) and i < len(summaries):
            summaries[i].radix_partitions = int(ri.get("partitions") or 0)
            summaries[i].radix_rung = int(ri.get("rung") or 0)
            summaries[i].radix_escapes = int(ri.get("escapes") or 0)
            return


# the counts stats() returns: what served each request, how often the
# caches missed, and the batched tier's buckets (batch_batches: program
# executions over a bucket; batch_regions: lanes a bucket served;
# batch_launches_saved: executions a bucket spared over one per region;
# batch_fallbacks: groups or buckets that an error sent to the single path;
# mesh_batches / mesh_lanes / mesh_fallbacks: the mesh tier's launches, the
# lanes they merged, and the groups it declined or that failed;
# host_fetches: the device-to-host reads of the programs the coprocessor
# ran, the drive_*_info functions' info["fetches"])
STAT_KEYS = ("device_served", "oracle_fallbacks", "result_cache_hits", "other_errors", "chunk_decodes",
             "native_decodes", "device_uploads", "aux_uploads", "batch_batches", "batch_regions",
             "batch_launches_saved", "batch_fallbacks", "mesh_batches", "mesh_lanes", "mesh_fallbacks",
             "host_fetches")


class TPUStore:
    """KV + regions + the coprocessor on `device`, one process (ref:
    mockstore EmbedUnistore, mockstore.go:86)."""

    _AUX_CACHE_MAX = 16
    _COP_CACHE_MAX = 128

    def __init__(self, device="cuda", mesh_devices=None):
        from ..pd.core import PlacementDriver
        from ..replication import ReplicaManager

        self.device = resolve_device(device)
        # the devices the mesh tier shards over (runtime.mesh_devices: all
        # visible cards for a cuda store, the store's device for a cpu one)
        self.mesh_devices = _mesh_devices(device, mesh_devices)
        self.kv = MemKV()
        self.cluster = Cluster()
        self.programs = ProgramCache()
        # the control plane: flow stats always record (cheap increments);
        # the schedulers only act when tick() or a timer runs (ref: every
        # TiKV store heartbeats PD whether or not PD is scheduling)
        self.pd = PlacementDriver(self)
        # the replication overlay: peer sets live on the cluster, per-peer
        # applied watermarks (safe_ts) live here; every committed write
        # proposes through it
        self.replication = ReplicaManager(self)
        # change data capture: the hub subscribes to every replication
        # proposal; its WriteGuard brackets the write paths so the
        # resolved-ts frontier can prove quiescence
        from ..cdc import ChangefeedHub
        from ..cdc.schema import SchemaJournal
        from ..columnar import ColumnarReplica

        self.cdc = ChangefeedHub(self)
        # the columnar replica tier: per-table delta + stable column stores
        # fed by changefeeds, compacted by the pd.columnar tick phase,
        # routed to by tidb_isolation_read_engines
        self.columnar = ColumnarReplica(self)
        # the ordered store-level log of schema-change entries: the
        # changefeed recovery source (they are synthetic, never in KV)
        self.schema_journal = SchemaJournal()
        # Percolator 2PC; a commit bumps the write version (and so drops
        # the result cache) as put_row does, and its applied keys pass the
        # write-quorum gate before and record flow and propose after, all
        # inside the CDC write guard
        self.txn = TxnEngine(self.kv, on_commit=self._bump_write_ver,
                             on_apply=self.record_applied_writes,
                             pre_apply=self._check_write_quorum,
                             write_guard=self.cdc.guard.writing,
                             on_apply_group=self.record_applied_writes_grouped)
        self._tso = itertools.count(100)  # guarded_by: _tso_lock
        self._tso_lock = threading.Lock()
        self._active_snapshots: dict[int, int] = {}  # guarded_by: _tso_lock
        self.gc_safepoint = -1  # the newest safepoint run_gc collected at
        self._write_ver = 0  # guarded_by: _cop_lock
        self._chunk_cache: dict = {}
        self._batch_cache: dict = {}
        self._aux_batch_cache: dict = {}  # token -> (chunk, DeviceBatch); guarded_by: _aux_lock
        self._aux_lock = threading.Lock()
        self._chunk_tokens = itertools.count(1)  # monotonic chunk identity; guarded_by: _aux_lock
        # coprocessor RESULT cache (ref: pkg/store/copr/coprocessor_cache.go):
        # a whole region response keyed by the region's data version
        self._cop_cache: dict = {}  # guarded_by: _cop_lock
        self._cop_lock = threading.Lock()
        self._row_encoder = RowEncoder()
        # logical placement stores marked down answer every cop request
        # with a typed StoreUnavailable region error
        self._down_stores: set[int] = set()  # guarded_by: _down_lock
        self._down_lock = threading.Lock()
        # per-store circuit breakers — client-side state, but shared by
        # every dispatch thread on this store (runtime import: the distsql
        # layer imports this module at load time)
        from ..distsql.dispatch import BreakerBoard
        from ..server.admission import AdmissionGate

        self.breakers = BreakerBoard()
        # admission control: one gate per store, fully open until a
        # session's Config configures it
        self.admission = AdmissionGate()
        # cross-session fused execution: one coalescer per store —
        # concurrent plan-cache-hit point gets park in a micro-batch window
        # and ship as ONE batch-cop launch; concurrent autocommit
        # single-row writes fold into group commit (runtime import: the
        # server package re-exports lazily, so no cycle)
        from ..server.coalesce import SessionCoalescer

        self.coalescer = SessionCoalescer(self)
        # the attached log backups (dest uri -> br.pitr.LogBackup; GIL-atomic
        # dict ops, written by BACKUP LOG / stop, read by the pd.pitr tick)
        self.log_backups: dict = {}
        self._stats = dict.fromkeys(STAT_KEYS, 0)  # guarded_by: _stats_lock
        self._stats_lock = threading.Lock()

    # -- counts -----------------------------------------------------------------
    def _count(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += by

    def stats(self) -> dict:
        """The counts since the store was made (plain integers)."""
        with self._stats_lock:
            return dict(self._stats)

    # -- store fault switches -----------------------------------------------------
    def set_down(self, store_id: int) -> None:
        """Take one logical placement store down: every cop request whose
        region is placed there answers `store_unavailable` until set_up."""
        with self._down_lock:
            self._down_stores.add(store_id)

    def set_up(self, store_id: int) -> None:
        with self._down_lock:
            self._down_stores.discard(store_id)

    def store_down(self, store_id: int) -> bool:
        with self._down_lock:
            return store_id in self._down_stores

    def down_stores(self) -> set:
        with self._down_lock:
            return set(self._down_stores)

    def ping_store(self, store_id: int) -> bool:
        """Store liveness probe (ref: client-go store liveness check /
        PD's store heartbeat watchdog): False when the store is switched
        down OR the unreachable failpoint is armed for it. Non-consuming —
        a probe must never eat a fire-N-times count."""
        from ..util import failpoint

        if self.store_down(store_id):
            return False
        return not _fault_matches(failpoint.peek("store/unreachable"), store_id)

    def evict_caches(self) -> int:
        """Drop the decoded-chunk, device-batch, build-side and result
        caches (the next request of each region decodes and uploads anew)
        — the first action of the memory-quota chain (ref: pkg/util/memory
        ActionOnExceed: free reclaimable buffers before killing the query).
        Returns an approximate count of the bytes freed, as the reference
        does: the host bytes of the decoded chunks and of the cached
        responses' chunks. The device batches and the build sides are
        dropped but not counted (0 when every cache was already empty)."""
        with self._cop_lock:
            freed = sum(ch.nbytes() for ch, _ts in list(self._chunk_cache.values()))
            freed += sum(resp.chunk.nbytes() for resp, _ts, _flow in self._cop_cache.values()
                         if resp.chunk is not None)
            self._cop_cache.clear()
            self._chunk_cache.clear()
            self._batch_cache.clear()
        with self._aux_lock:
            self._aux_batch_cache.clear()
        return freed

    def clear_result_cache(self) -> None:
        """Drop the cached responses only (decoded chunks and device batches
        stay): the next request of each region runs its program again."""
        with self._cop_lock:
            self._cop_cache.clear()

    def next_ts(self) -> int:
        """Store-global TSO (ref: PD timestamp oracle; mock unistore/pd.go)."""
        with self._tso_lock:
            return next(self._tso)

    def advance_tso(self, ts: int) -> None:
        """Fast-forward the TSO past `ts` (a no-op when the clock is
        already ahead)."""
        with self._tso_lock:
            self._tso = itertools.count(max(next(self._tso), ts + 1))

    def register_snapshot(self, start_ts: int) -> None:
        """An open transaction pins its snapshot: GC never collects at or
        above the oldest registered start_ts (ref: gc_worker.go
        calcSafePointByMinStartTS)."""
        with self._tso_lock:
            self._active_snapshots[start_ts] = self._active_snapshots.get(start_ts, 0) + 1

    def unregister_snapshot(self, start_ts: int) -> None:
        with self._tso_lock:
            n = self._active_snapshots.get(start_ts, 0) - 1
            if n <= 0:
                self._active_snapshots.pop(start_ts, None)
            else:
                self._active_snapshots[start_ts] = n

    def run_gc(self, safepoint: int | None = None) -> int:
        """MVCC GC pass (ref: gc_worker.go): the safepoint is clamped
        strictly below every registered snapshot and every lock holder's
        start_ts. Default safepoint = the current TSO (keep only the latest
        committed version of each key). Returns the versions removed."""
        sp = safepoint if safepoint is not None else self.next_ts()
        with self._tso_lock:
            for ts in self._active_snapshots:
                sp = min(sp, ts - 1)
        with self.txn._mu:
            for l in self.txn.locks.values():
                sp = min(sp, l.start_ts - 1)
        self.gc_safepoint = max(self.gc_safepoint, sp)
        return self.kv.gc(sp)

    def _bump_write_ver(self):
        # every cache key embeds the old write version, so no entry can
        # serve stale data; the clears drop the dead entries
        with self._cop_lock:
            self._write_ver += 1
            self._cop_cache.clear()
            self._chunk_cache.clear()
            self._batch_cache.clear()

    def _snapshot_write_ver(self) -> int:
        """Locked read of the store write version — the pre-read snapshot
        every cache key embeds."""
        with self._cop_lock:
            return self._write_ver

    def _record_write_flow(self, key: bytes, value: bytes | None, prev_live: bool,
                           ts: int, placement: tuple | None = None):
        """Per-key write flow into the PD heartbeat snapshot (ref: TiKV's
        flow observer feeding pdpb.RegionHeartbeat bytes/keys_written) +
        a replication proposal carrying the change entry: the write rides
        the region's raft-lite log, commits on quorum ack and advances
        follower safe_ts."""
        self.pd.flow.record_write(key, 0 if value is None else len(value),
                                  prev_live=prev_live, delete=value is None)
        if placement is None:
            placement = self.cluster.locate_placement(key)
        rid, leader, peers = placement
        self.replication.propose(rid, ts, placement=(leader, peers),
                                 entries=[(key, value)])

    def record_applied_writes(self, items, ts: int | None = None):
        """Batch write flow for appliers that land many keys at once (2PC
        commit, bulk ingest, LOAD DATA): items of (key, value|None,
        prev_live). Called AFTER the kv critical section so the flow
        bookkeeping never extends the reader-blocking window. Each touched
        region gets ONE replication proposal at the batch's commit ts
        carrying exactly its own keys' changes. `ts` defaults to the store
        commit watermark; batch appliers pass their actual commit_ts."""
        self.pd.flow.record_writes(
            [(k, 0 if v is None else len(v), prev, v is None) for k, v, prev in items]
        )
        if ts is None:
            ts = self.kv.max_committed()
        values = {k: v for k, v, _prev in items}
        for rid, keys in self.cluster.group_keys_by_region(list(values)).items():
            self.replication.propose(rid, ts,
                                     entries=[(k, values[k]) for k in keys])

    def record_applied_writes_grouped(self, lanes):
        """Group-commit write flow: lanes of (applied items, commit_ts)
        from ONE coalesced window, ascending commit ts. One flow-stats
        batch for the whole window, then ONE replication proposal per
        touched region carrying every lane's entries at its own commit ts
        (ReplicaManager.propose_group)."""
        from ..util import metrics

        flow_items = []
        per_region: dict[int, list] = {}
        pairs = 0
        for applied, ts in lanes:
            flow_items.extend(
                (k, 0 if v is None else len(v), prev, v is None)
                for k, v, prev in applied
            )
            values = {k: v for k, v, _prev in applied}
            for rid, keys in self.cluster.group_keys_by_region(list(values)).items():
                per_region.setdefault(rid, []).append(
                    (ts, [(k, values[k]) for k in keys])
                )
                pairs += 1
        self.pd.flow.record_writes(flow_items)
        for rid, groups in per_region.items():
            self.replication.propose_group(rid, groups)
        if pairs > len(per_region):
            metrics.COALESCE_GROUP_PROPOSALS_SAVED.inc(pairs - len(per_region))

    def _check_write_quorum(self, keys) -> None:
        """The pre-apply write gate: every region a write touches must
        hold quorum, else the whole write is refused with a typed
        QuorumLostError (MySQL 9005 at the session boundary) BEFORE
        anything turns durable on the shared KV. One cluster-lock
        acquisition fetches every placement."""
        for rid, placement in self.cluster.placements_of_keys(keys).items():
            self.replication.check_write_quorum(rid, placement=placement)

    # -- write path (ref: table.AddRecord -> memdb -> prewrite/commit) ------
    def put_row(self, table_id: int, handle: int, col_ids: list[int], datums: list[Datum], ts: int):
        key = tablecodec.encode_row_key(table_id, handle)
        val = self._row_encoder.encode(col_ids, datums)
        self._put_checked(key, val, ts)

    def delete_row(self, table_id: int, handle: int, ts: int):
        self._put_checked(tablecodec.encode_row_key(table_id, handle), None, ts)

    def put_index(self, key: bytes, value: bytes, ts: int):
        self._put_checked(key, value, ts)

    def _put_checked(self, key: bytes, value: bytes | None, ts: int) -> None:
        """One direct write: the region's quorum gate, the put, its flow
        and replication proposal (inside the CDC write guard), then the
        write-version bump."""
        placement = self.cluster.locate_placement(key)
        self.replication.check_write_quorum(placement[0], placement=placement[1:])
        with self.cdc.guard.writing():
            prev = self.kv.put(key, value, ts)
            self._record_write_flow(key, value, prev, ts, placement=placement)
        self._bump_write_ver()

    def propose_schema_change(self, meta, op: str, query: str) -> int:
        """One committed row-shape DDL -> one schema-change entry riding
        `ReplicaManager.propose` (DDL through the feed). The key is
        synthetic (`m_schema_<tid>_<ver>`, never in KV); the ts draws
        INSIDE the CDC WriteGuard so no resolved-ts candidate can prove
        quiescence past an undelivered schema change, as on the row write
        paths. The journal records it first: a feed that misses the live
        delivery (paused, born later, puller-drop) re-injects from the
        journal on its next tick."""
        import json

        from ..cdc.schema import encode_schema_key, schema_payload

        key = encode_schema_key(meta.table_id, meta.schema_version)
        value = json.dumps(schema_payload(meta, op, query)).encode()
        with self.cdc.guard.writing():
            ts = self.next_ts()
            self.schema_journal.append(ts, meta.table_id, key, value)
            rid = self.cluster.locate_placement(tablecodec.table_prefix(meta.table_id))[0]
            self.replication.propose(rid, ts, entries=[(key, value)])
        return ts

    def bulk_ingest(self, items, ts: int) -> None:
        """Apply (key, value) pairs at commit ts `ts` in one critical section
        (TxnEngine.bulk_ingest: raises KeyIsLocked, applying nothing, when a
        live transaction holds one of the keys, and QuorumLostError when a
        region the keys touch cannot reach quorum; the applied keys record
        their flow and propose per region)."""
        self.txn.bulk_ingest(list(items), ts)
        self._bump_write_ver()

    # -- scan/decode with caching -------------------------------------------
    def region_chunk(self, region: Region, ranges: list, dag: DAGRequest, start_ts: int) -> Chunk:
        """Rows of `region` ∩ `ranges` decoded to a columnar chunk.

        Cached by the store write version (any write invalidates: coarse,
        but correct) under the result cache's snapshot rule
        (`_snapshot_cache_get` / `_snapshot_cache_put`), so later snapshots
        reuse a decode. The reference keys this cache by the exact start_ts,
        which a SQL session, drawing a new one for every statement, never
        repeats."""
        scan = dag.scan()
        col_ids = tuple(c.col_id for c in scan.columns)
        write_ver = self._snapshot_write_ver()
        rkey = (
            region.region_id,
            region.epoch,
            write_ver,
            scan.table_id,
            col_ids,
            tuple((r.start, r.end) for r in ranges),
        )
        cached = self._snapshot_cache_get(self._chunk_cache, rkey, start_ts)
        if cached is not None:
            return cached
        self._count("chunk_decodes")
        fts = [c.ft for c in scan.columns]
        fts_by_id = {c.col_id: c.ft for c in scan.columns}
        ch = None
        from ..exec.dag import IndexScan

        if not isinstance(scan, IndexScan):
            ch = self._native_region_chunk(region, ranges, scan, start_ts)
        if ch is None:
            rows = []
            for key, val in self._scan_region_kvs(region, ranges, start_ts):
                row = self._decode_row(key, val, scan, fts_by_id)
                if row is not None:
                    rows.append(row)
            ch = Chunk.from_rows(fts, rows)
        self._snapshot_cache_put(self._chunk_cache, rkey, ch, start_ts, write_ver)
        return ch

    @staticmethod
    def _snapshot_cache_get(cache: dict, key, start_ts: int):
        """A decoded region (or its device batch) cached by data version:
        served to any snapshot at or after the one it was read at."""
        ent = cache.get(key)
        if ent is None or start_ts < ent[1]:
            return None
        return ent[0]

    def _snapshot_cache_put(self, cache: dict, key, value, start_ts: int, write_ver: int) -> None:
        """File a region read at `start_ts` under its data version, as
        _cop_cache_put files a response: only when no write landed since
        `write_ver` was read and the snapshot sees every committed version,
        so the value is what every later snapshot of this write version
        reads."""
        with self._cop_lock:
            if write_ver != self._write_ver or start_ts < self.kv.max_committed():
                return
        cache[key] = (value, start_ts)

    def _scan_region_kvs(self, region: Region, ranges: list, start_ts: int):
        """(key, value) pairs of region ∩ ranges at the snapshot — the one
        range-clamping loop both decode paths consume."""
        for rng in ranges:
            start = max(rng.start, region.start_key)
            end = min(rng.end, region.end_key)
            if start >= end:
                continue
            yield from self.kv.scan(start, end, start_ts)

    def _native_region_chunk(self, region: Region, ranges: list, scan, start_ts: int) -> Chunk | None:
        """C++ scan decode (native/): rowcodec values -> columns in one
        call. None on any unsupported shape or decode error — the caller
        runs the row-at-a-time Python decoder instead."""
        from .. import native

        if not native.available():
            return None
        if any(c.default is not None for c in scan.columns):
            return None  # origin-default fill is python-side only
        values: list[bytes] = []
        handles: list[int] = []
        for key, val in self._scan_region_kvs(region, ranges, start_ts):
            try:
                _, handle = tablecodec.decode_row_key(key)
            except ValueError:
                continue
            values.append(val)
            handles.append(handle)
        cols = native.decode_rows_columnar(values, handles, scan.columns)
        if cols is None:
            return None
        from ..util import metrics

        metrics.NATIVE_DECODES.inc()
        self._count("native_decodes")
        return Chunk(cols)

    def _decode_row(self, key: bytes, val: bytes, scan, fts_by_id: dict):
        from ..exec.dag import IndexScan

        if isinstance(scan, IndexScan):
            return self._decode_index_entry(key, scan)
        try:
            _, handle = tablecodec.decode_row_key(key)
        except ValueError:
            return None
        dmap = decode_row_to_datum_map(val, fts_by_id)
        row = []
        for c in scan.columns:
            if c.col_id == -1:  # handle column (_tidb_rowid)
                row.append(Datum.i64(handle))
                continue
            row.append(fill_origin_default(val, c.col_id, c.default, dmap[c.col_id]))
        return row

    def _decode_index_entry(self, key: bytes, scan):
        """Index key `t{tid}_i{iid}{vals...}{handle}` -> one row of the
        IndexScan schema (index cols then handle; ref: indexScanExec
        mpp_exec.go:255 decoding index entries back to datums)."""
        from ..codec.datum_codec import decode_datums

        prefix_len = 1 + 8 + 2 + 8  # 't' + tid + '_i' + iid
        if len(key) <= prefix_len:
            return None
        fts = [c.ft for c in scan.columns]
        try:
            datums = decode_datums(key[prefix_len:], fts)
        except (ValueError, IndexError):
            return None
        if len(datums) != len(scan.columns):
            return None
        return datums

    def _paged_region_chunk(self, region: Region, ranges: list, dag: DAGRequest, start_ts: int, limit: int):
        """Scan at most `limit` rows of region ∩ ranges; returns
        (chunk, resume_ranges | None). The resume cursor is the first
        unscanned key, exactly the reference's lastRange contract
        (ref: cop_handler.go:210-224)."""
        scan = dag.scan()
        fts = [c.ft for c in scan.columns]
        fts_by_id = {c.col_id: c.ft for c in scan.columns}
        rows: list = []
        for ri, rng in enumerate(ranges):
            start = max(rng.start, region.start_key)
            end = min(rng.end, region.end_key)
            if start >= end:
                continue
            for key, val in self.kv.scan(start, end, start_ts):
                if len(rows) >= limit:
                    resume = [KeyRange(key, rng.end)] + list(ranges[ri + 1 :])
                    return Chunk.from_rows(fts, rows), resume
                row = self._decode_row(key, val, scan, fts_by_id)
                if row is not None:
                    rows.append(row)
        return Chunk.from_rows(fts, rows), None

    def region_device_batch(self, region: Region, ranges, dag: DAGRequest, start_ts: int, capacity: int | None = None) -> DeviceBatch:
        """The region chunk as a capacity-padded DeviceBatch on the store's
        device, uploaded once per region version."""
        write_ver = self._snapshot_write_ver()
        ch = self.region_chunk(region, ranges, dag, start_ts)
        cap = capacity or _pow2(max(ch.num_rows(), 1))
        scan = dag.scan()
        bkey = (
            region.region_id,
            region.epoch,
            write_ver,
            scan.table_id,
            tuple(c.col_id for c in scan.columns),
            tuple((r.start, r.end) for r in ranges),
            cap,
        )
        cached = self._snapshot_cache_get(self._batch_cache, bkey, start_ts)
        if cached is not None:
            return cached
        batch = to_device_batch(ch, capacity=cap, device=self.device)
        self._count("device_uploads")
        self._snapshot_cache_put(self._batch_cache, bkey, batch, start_ts, write_ver)
        return batch

    def _chunk_token(self, chunk: Chunk) -> int:
        """Monotonic identity for a chunk object. id() is reused after GC —
        a dead build side's cache entry could alias a brand-new chunk at
        the same address; a token handed out once per object never can."""
        tok = getattr(chunk, "_device_token", None)
        if tok is None:
            with self._aux_lock:
                tok = getattr(chunk, "_device_token", None)
                if tok is None:
                    tok = next(self._chunk_tokens)
                    chunk._device_token = tok
        return tok

    def _aux_batch(self, chunk: Chunk) -> DeviceBatch:
        """Broadcast build-side chunk -> DeviceBatch, uploaded once per
        chunk object (all region tasks of a join share the operand).

        Bounded LRU keyed by the chunk token (never-reused identity); the
        entry pins the chunk so the device batch and its source live and
        die together."""
        key = self._chunk_token(chunk)
        with self._aux_lock:
            cached = self._aux_batch_cache.get(key)
            if cached is not None:
                self._aux_batch_cache.pop(key)  # refresh LRU position
                self._aux_batch_cache[key] = cached
                return cached[1]
        batch = to_device_batch(chunk, capacity=_pow2(max(chunk.num_rows(), 1)), device=self.device)
        self._count("aux_uploads")
        with self._aux_lock:
            self._aux_batch_cache[key] = (chunk, batch)
            while len(self._aux_batch_cache) > self._AUX_CACHE_MAX:
                self._aux_batch_cache.pop(next(iter(self._aux_batch_cache)))
        return batch

    # -- coprocessor result cache (ref: copr/coprocessor_cache.go) ----------
    def _cop_cache_key(self, req: CopRequest, write_ver: int):
        return (
            req.region_id,
            req.region_epoch,
            write_ver,
            req.dag.fingerprint(),
            tuple((r.start, r.end) for r in req.ranges),
            req.small_groups,
        )

    def _cop_cacheable(self, req: CopRequest) -> bool:
        # paging responses carry per-page cursors; aux chunks (join build
        # sides) are statement-local operands with no data version to key on
        return req.paging_size is None and not req.aux_chunks

    def _cop_cache_get(self, req: CopRequest) -> CopResponse | None:
        """Serve a whole region response from the result cache when the
        region's data version — (epoch, store write version) — and the DAG
        fingerprint match (ref: coprocessor_cache.go keying responses by
        region data version). Entries are only created for snapshots that
        already see every committed version (start_ts >= kv.max_version at
        put time), so with the write version unchanged any request at
        start_ts >= the entry's sees byte-identical data; an older snapshot
        might predate a version the entry includes and must miss. A hit
        still records read flow: the region logically served the rows, and
        the hot-region scheduler must see the most re-read regions."""
        if not self._cop_cacheable(req):
            return None
        with self._cop_lock:
            key = self._cop_cache_key(req, self._write_ver)
            ent = self._cop_cache.get(key)
            if ent is None:
                return None
            resp, entry_ts, flow = ent
            if req.start_ts < entry_ts:
                return None
            self._cop_cache.pop(key)  # refresh LRU position
            self._cop_cache[key] = ent
        from ..topsql import record_cop_cache_hit
        from ..util import metrics

        metrics.COP_CACHE_HITS.inc()
        record_cop_cache_hit()  # no device time: no launch ran
        self.pd.flow.record_read(req.region_id, flow[0], flow[1])
        summaries = [replace(s, cache_hit=True, time_compile_ns=0) for s in resp.exec_summaries]
        return CopResponse(chunk=resp.chunk, exec_summaries=summaries)

    def _cop_cache_put(self, req: CopRequest, resp: CopResponse, write_ver: int, flow: tuple = (0, 0)) -> None:
        """flow = (decoded bytes, rows) of the region read, replayed into
        the PD heartbeat on every hit.

        write_ver is the caller's snapshot of _write_ver taken BEFORE it
        read the region: the insert is refused under _cop_lock if a write
        landed since (version moved, or a half-applied commit already
        raised kv.max_version) — otherwise a pre-write response could be
        filed under the post-write key and serve stale rows."""
        if (
            not self._cop_cacheable(req)
            or resp.chunk is None
            or resp.region_error is not None
            or resp.other_error is not None
            or resp.last_range is not None
        ):
            return
        with self._cop_lock:
            if write_ver != self._write_ver:
                return  # a write raced the read: the response may predate it
            # a snapshot that predates some committed version would cache a
            # view newer snapshots must not inherit (MVCC: same write_ver,
            # different visibility) — only the all-seeing snapshot caches
            if req.start_ts < self.kv.max_committed():
                return
            self._cop_cache[self._cop_cache_key(req, write_ver)] = (resp, req.start_ts, flow)
            while len(self._cop_cache) > self._COP_CACHE_MAX:
                self._cop_cache.pop(next(iter(self._cop_cache)))

    def _count_replica_read(self, req: CopRequest) -> None:
        """tidb_tpu_replica_read_total{target=} — one count per routed
        request (req.peer_store >= 0), marker-deduped because a batch lane
        can be re-served by the single-request path (singleton groups,
        overflow fall-outs) after the batch already admitted it. Also
        feeds the closest-replica router's per-store read load."""
        if req.peer_store < 0 or getattr(req, "_replica_counted", False):
            return
        req._replica_counted = True
        from ..util import metrics

        target = "follower" if req.peer_store != self.cluster.leader_of(req.region_id) else "leader"
        metrics.REPLICA_READS.labels(target).inc()
        self.replication.note_read(req.peer_store)

    def _region_fault(self, region_id: int, peer_store: int = -1, replica_read: bool = False,
                      start_ts: int = 0):
        """The typed fault ladder for the peer a request was routed to
        (`peer_store`; -1 = whoever leads at serve time): the set_down
        switch and the three per-store-armable failpoints
        (`store/unreachable`, `store/not-leader`, `store/server-busy`) —
        each returns a typed RegionError the dispatch client classifies
        onto its own backoff budget — then the replication checks: a
        non-leader peer answers NotLeader WITH the current leader as the
        hint unless the request is a replica read, and a replica read is
        gated on the peer's applied watermark (`safe_ts >= start_ts`,
        else DataIsNotReady — ref: TiKV replica read's resolved-ts
        check). None = this peer serves."""
        from ..util import failpoint
        from .errors import DataIsNotReady, NotLeader, ServerIsBusy, StoreUnavailable

        leader = self.cluster.leader_of(region_id)
        sid = peer_store if peer_store >= 0 else leader
        if self.store_down(sid):
            return StoreUnavailable.make(sid)
        if _fault_matches(failpoint.eval("store/unreachable"), sid):
            return StoreUnavailable.make(sid)
        if _fault_matches(failpoint.eval("store/not-leader"), sid):
            # injected leadership wobble: the hint is whatever the cluster
            # currently believes — pointing at the armed store itself
            # means "election in flight", no usable hint
            return NotLeader.make(region_id, sid, leader)
        busy = failpoint.eval("store/server-busy")
        if _fault_matches(busy, sid):
            ms = busy.get("backoff_ms", 0) if isinstance(busy, dict) else 0
            return ServerIsBusy.make(sid, ms)
        if sid != leader:
            if not replica_read:
                return NotLeader.make(region_id, sid, leader)
            safe = self.replication.safe_ts(region_id, sid)
            if safe < start_ts:
                return DataIsNotReady.make(region_id, sid, safe)
        return None

    # -- the serialized endpoint (the sidecar seam) -------------------------
    def coprocessor_bytes(self, req_bytes: bytes) -> bytes:
        """Serve one cop request from wire bytes to wire bytes — the
        process-boundary shape of the coprocessor endpoint (ref:
        unistore/rpc.go:260 CmdCop dispatch over serialized protos)."""
        from ..codec.wire import decode_cop_request, encode_cop_response

        try:
            req = decode_cop_request(req_bytes)
        except Exception as exc:  # malformed bytes must not kill the server
            self._count("other_errors")
            return encode_cop_response(CopResponse(other_error=f"bad request: {exc}"))
        return encode_cop_response(self.coprocessor(req))

    # -- the coprocessor endpoint -------------------------------------------
    def coprocessor(self, req: CopRequest, group_capacity: int = DEFAULT_GROUP_CAPACITY) -> CopResponse:
        from ..util import metrics

        metrics.COP_REQUESTS.inc()
        t_start = time.monotonic()
        resp = self._coprocessor(req, group_capacity)
        metrics.COP_DURATION.observe(time.monotonic() - t_start)
        if resp.region_error is not None or resp.other_error is not None:
            metrics.COP_ERRORS.inc()
        if resp.other_error is not None:
            self._count("other_errors")
        return resp

    def _coprocessor(self, req: CopRequest, group_capacity: int) -> CopResponse:
        from ..exec.dag import executor_walk
        from ..topsql import record_device
        from ..util import failpoint, metrics, tracing

        if failpoint.eval("cop-region-error"):
            # fault injection at the RPC seam (ref: unistore/rpc.go:265-271)
            return CopResponse(region_error="injected epoch_not_match")
        if failpoint.eval("cop-other-error"):
            return CopResponse(other_error="injected coprocessor error")
        region = self.cluster.region_snapshot(req.region_id)
        if region is None:
            return CopResponse(region_error=f"region {req.region_id} not found")
        err = self._region_fault(req.region_id, req.peer_store, req.replica_read, req.start_ts)
        if err is not None:
            return CopResponse(region_error=str(err))
        if req.region_epoch != region.epoch:
            return CopResponse(region_error=f"epoch_not_match: have {region.epoch}, got {req.region_epoch}")
        self._count_replica_read(req)
        cached = self._cop_cache_get(req)
        if cached is not None:
            self._count("result_cache_hits")
            return cached
        ver = self._snapshot_write_ver()  # pre-read snapshot: gates the cache insert
        t0 = time.monotonic_ns()
        last_range = None
        page = None
        in_bytes, in_rows = 0, 0
        launch_ns = 0
        try:
            with tracing.span("cop.decode", region_id=req.region_id) as dsp:
                if req.paging_size is not None:
                    from ..exec.dag import Aggregation as _Agg, Limit as _Limit, Sort as _Sort, TopN as _TopN

                    if req.paging_size <= 0:
                        return CopResponse(other_error=f"invalid paging_size {req.paging_size}")
                    if any(isinstance(e, (_Agg, _TopN, _Limit, _Sort)) for e in executor_walk(req.dag.executors)):
                        # per-page agg/top-k/limit results are not mergeable by
                        # concatenation — row-local DAGs only (scan/sel/proj/join)
                        return CopResponse(other_error="paging requires a row-local DAG (no aggregation/TopN/Limit)")
                    page, last_range = self._paged_region_chunk(
                        region, req.ranges, req.dag, req.start_ts, req.paging_size
                    )
                    in_bytes, in_rows = page.nbytes(), page.num_rows()
                    batch = to_device_batch(page, capacity=_pow2(max(page.num_rows(), 1)), device=self.device)
                    self._count("device_uploads")
                else:
                    rc = self.region_chunk(region, req.ranges, req.dag, req.start_ts)
                    in_bytes, in_rows = rc.nbytes(), rc.num_rows()
                    batch = self.region_device_batch(region, req.ranges, req.dag, req.start_ts)
                # read flow into the PD heartbeat (ref: TiKV flow observer ->
                # pdpb.RegionHeartbeat bytes/keys_read)
                self.pd.flow.record_read(region.region_id, in_bytes, in_rows)
                if dsp is not None:
                    dsp.set("bytes_to_device", in_bytes)
            batches = [batch] + [self._aux_batch(c) for c in req.aux_chunks]
            with tracing.span("cop.execute", region_id=req.region_id) as xsp:
                t_launch = time.monotonic_ns()
                chunk, ex_rows, info = drive_program_info(self.programs, req.dag, batches, group_capacity,
                                                          small_groups=req.small_groups)
                launch_ns = time.monotonic_ns() - t_launch
                if xsp is not None:
                    xsp.set("rows", chunk.num_rows())
                    xsp.set("cache_hit", info["cache_hit"])
            self._count("device_served")
            self._count("host_fetches", info["fetches"])
        except (OverflowRetryError, NotImplementedError):
            # degenerate fan-out OR an op the device program cannot express
            # (JSON, host-only funcs, ops not ported yet): fall back to the
            # row-at-a-time oracle (tidb_tpu/store/store.py:914)
            metrics.COP_FALLBACKS.inc()
            self._count("oracle_fallbacks")
            try:
                with tracing.span("cop.oracle_fallback", region_id=req.region_id):
                    region_chunk = page if page is not None else self.region_chunk(region, req.ranges, req.dag,
                                                                                   req.start_ts)
                    rows = run_dag_reference(req.dag, [region_chunk] + list(req.aux_chunks))
                    chunk = Chunk.from_rows(req.dag.output_fts(), rows)
                # fallback summaries: aligned with the device path's
                # per-executor walk (build pipelines included); counts are
                # the final row count
                ex_rows = [chunk.num_rows()] * len(executor_walk(req.dag.executors))
                info = {"cache_hit": False, "compile_ns": 0}
            except (RuntimeError, TypeError, NotImplementedError, ValueError) as exc:
                if failpoint.eval("cop-debug-raise"):
                    raise  # the loud-failure gate
                return CopResponse(other_error=f"oracle fallback failed: {exc}")
        except (RuntimeError, TypeError) as exc:
            if failpoint.eval("cop-debug-raise"):
                raise  # surface kernel bugs with a stack when armed
            return CopResponse(other_error=str(exc))
        elapsed = time.monotonic_ns() - t0
        # Top SQL's device time is the program's run and the fetch of its
        # outputs (the region decode is host work); an oracle answer adds 0
        record_device(launch_ns, compile_ns=info["compile_ns"], bytes_to_device=in_bytes)
        # per-executor produced-row counts are real (counted inside the
        # program); the time is the whole program's, so every summary of
        # the task carries it, as it carries the compile/cache attribution;
        # bytes attribute to the data movers (the scan's decoded region
        # bytes in, the final executor's result out; ref:
        # cop_handler.go:518-531)
        walk = executor_walk(req.dag.executors)
        out_bytes = chunk.nbytes()
        summaries = [
            ExecSummary(
                time_processed_ns=elapsed, num_produced_rows=r,
                time_compile_ns=info["compile_ns"], cache_hit=info["cache_hit"],
                num_bytes=in_bytes if i == 0 else (out_bytes if i == len(ex_rows) - 1 else 0),
            )
            for i, r in enumerate(ex_rows)
        ]
        _apply_radix_attribution(summaries, walk, info)
        for ex, r in zip(walk, ex_rows):
            metrics.COP_EXECUTOR_ROWS.labels(type(ex).__name__.lower()).inc(r)
        resp = CopResponse(chunk=chunk, exec_summaries=summaries, last_range=last_range)
        self._cop_cache_put(req, resp, write_ver=ver, flow=(in_bytes, in_rows))
        return resp

    # -- the batched coprocessor endpoint -----------------------------------
    def batch_coprocessor(self, reqs: list, group_capacity: int = DEFAULT_GROUP_CAPACITY) -> list:
        """Serve a store's region tasks with ONE execution of the
        region-batched program per (DAG, snapshot) group and power-of-two
        capacity bucket (ref: copr/batch_coprocessor.go — all regions of a
        store travel in one request). Each region decodes as usual, pads to
        its bucket's capacity and stacks on a leading region axis; each
        region's result slices back out, so the root-side merge is
        unchanged.

        Validation comes first: a missing region, a store fault, a stale
        epoch or a result-cache hit answers at once and falls out of the
        batch while the rest of the batch stands. Paging requests and armed
        cop failpoints take the single-request path (resume cursors and
        injection sites live there), as does a group of one. Responses come
        back in request order."""
        from ..util import failpoint, metrics

        responses: list = [None] * len(reqs)
        groups: dict = {}
        for i, req in enumerate(reqs):
            if (req.paging_size is not None or failpoint.is_armed("cop-region-error")
                    or failpoint.is_armed("cop-other-error")):
                responses[i] = self.coprocessor(req, group_capacity)
                continue
            region = self.cluster.region_snapshot(req.region_id)
            if region is None:
                metrics.COP_REQUESTS.inc()
                metrics.COP_ERRORS.inc()
                responses[i] = CopResponse(region_error=f"region {req.region_id} not found")
                continue
            err = self._region_fault(req.region_id, req.peer_store, req.replica_read, req.start_ts)
            if err is not None:
                # a typed store fault falls out like a stale epoch: the lane
                # answers now, the rest of the batch stands
                metrics.COP_REQUESTS.inc()
                metrics.COP_ERRORS.inc()
                responses[i] = CopResponse(region_error=str(err))
                continue
            if req.region_epoch != region.epoch:
                metrics.COP_REQUESTS.inc()
                metrics.COP_ERRORS.inc()
                responses[i] = CopResponse(region_error=f"epoch_not_match: have {region.epoch}, got {req.region_epoch}")
                continue
            self._count_replica_read(req)
            cached = self._cop_cache_get(req)
            if cached is not None:
                metrics.COP_REQUESTS.inc()
                self._count("result_cache_hits")
                responses[i] = cached
                continue
            key = (req.dag.fingerprint(), req.start_ts, req.small_groups, bool(req.mesh),
                   tuple(self._chunk_token(c) for c in req.aux_chunks))
            groups.setdefault(key, []).append((i, req, region))
        for entries in groups.values():
            if len(entries) == 1:  # nothing to amortize: the plain path
                i, req, _region = entries[0]
                responses[i] = self.coprocessor(req, group_capacity)
                continue
            if entries[0][1].mesh and self._run_cop_mesh(entries, responses, group_capacity):
                continue  # merged across the mesh; else degrade to the batched tier
            self._run_cop_batch(entries, responses, group_capacity)
        return responses

    # data-size floor for the mesh tier on the group's ACTUAL decoded rows
    # (the client's estimate only gated the attempt): below it the batched
    # tier serves. Environment-tunable for benches.
    MESH_MIN_GROUP_ROWS = int(os.environ.get("TIDB_TPU_MESH_MIN_ROWS", "0"))

    def _mesh_fallback(self) -> bool:
        from ..util import metrics

        metrics.MESH_COP_FALLBACKS.inc()
        self._count("mesh_fallbacks")
        return False

    def _run_cop_mesh(self, entries, responses, group_capacity: int) -> bool:
        """ONE mesh-program run for a same-DAG group of region tasks (the
        dispatch planner's MESH tier): decode every lane, stack to the
        group's max power-of-two capacity, pad the region axis to a
        multiple of the mesh width, and merge the per-region results
        across the shards — a sum / min / max of partial aggregate states,
        a merge-mode re-group for GROUP BY tables, a re-top-k for TopN. The
        group's first lane answers with the ONE merged chunk; the rest
        answer empty with the same mesh_merged marker, so the root merges a
        single state per store.

        Returns True when every lane was answered; False degrades the whole
        group to the batched tier (an ineligible DAG, too few rows, padding
        skew, overflow, or any failure of the mesh program), which owns the
        per-lane capacity ladder and the oracle fallback. The dispatch
        planner marks requests for the mesh only on two or more devices."""
        from ..distsql.planner import mesh_merge_kind
        from ..exec.dag import executor_walk
        from ..exec.executor import drive_mesh_program_info
        from ..parallel.mesh import region_mesh
        from ..topsql import record_device, split_by_rows
        from ..util import metrics, tracing

        req0 = entries[0][1]
        dag = req0.dag
        kind = mesh_merge_kind(dag)
        if kind is None:
            return False
        t0 = time.monotonic_ns()
        try:
            with tracing.span("cop.mesh_decode", regions=len(entries)) as dsp:
                chunks = [self.region_chunk(region, req.ranges, dag, req.start_ts) for (_i, req, region) in entries]
                if dsp is not None:
                    dsp.set("bytes_to_device", sum(ch.nbytes() for ch in chunks))
                aux_batches = [self._aux_batch(c) for c in req0.aux_chunks]
        except Exception:  # noqa: BLE001 — degrade, never lose the group
            return False
        floor = max(self.MESH_MIN_GROUP_ROWS, req0.mesh_min_rows)
        if sum(ch.num_rows() for ch in chunks) < floor:
            # the data-size tier rule: small groups ride the batched tier
            # (counted, so a decline shows apart from "never attempted")
            return self._mesh_fallback()
        caps = [_pow2(max(ch.num_rows(), 1)) for ch in chunks]
        cap = max(caps)
        # skew guard: every lane pads to the group's MAX capacity, so one
        # giant region among small ones would inflate the stack toward
        # lanes * max; past 4x the honest footprint the bucketed tier serves
        if cap * len(caps) > 4 * sum(caps):
            return self._mesh_fallback()
        D = min(len(self.mesh_devices), len(chunks))
        mesh = region_mesh(self.mesh_devices, D)
        R_pad = -(-len(chunks) // D) * D  # empty lanes pad the region axis
        lanes = list(chunks) + [Chunk.empty(chunks[0].field_types()) for _ in range(R_pad - len(chunks))]
        try:
            with tracing.span("cop.mesh_execute", regions=len(entries), devices=D, kind=kind) as xsp:
                t_launch = time.monotonic_ns()
                stacked = to_stacked_device_batch(lanes, cap, device=mesh.lead)
                merged, lane_counts, info = drive_mesh_program_info(self.programs, dag, stacked, aux_batches,
                                                                    group_capacity, kind, mesh,
                                                                    small_groups=req0.small_groups)
                launch_ns = time.monotonic_ns() - t_launch
                self._count("host_fetches", info["fetches"])
                if xsp is not None:
                    xsp.set("cache_hit", info["cache_hit"])
        except Exception:  # noqa: BLE001 — degrade, never lose the group
            return self._mesh_fallback()
        if merged is None:
            # the global overflow flag: the batched tier's PER-LANE ladder
            # isolates the overflowing region instead
            return self._mesh_fallback()
        elapsed = time.monotonic_ns() - t0
        # one run served every lane: its time splits by each lane's decoded
        # rows, and the shares sum exactly to the run's
        shares = split_by_rows(elapsed, [ch.num_rows() for ch in chunks])
        record_device(launch_ns, compile_ns=info["compile_ns"], bytes_to_device=sum(ch.nbytes() for ch in chunks))
        walk = executor_walk(dag.executors)
        out_fts = merged.field_types()
        metrics.MESH_COP_BATCHES.inc()
        self._count("mesh_batches")
        for k, (i, _req, region) in enumerate(entries):
            metrics.MESH_COP_LANES.inc()
            self._count("mesh_lanes")
            self._count("device_served")
            # the first lane carries the one merged state; the rest answer
            # empty, so the root sees one row block per store
            out_chunk = merged if k == 0 else Chunk.empty(out_fts)
            summaries = self._lane_attribution(region, chunks[k], out_chunk.nbytes() if k == 0 else 0, lane_counts[k],
                                               shares[k], compile_ns=info["compile_ns"] if k == 0 else 0,
                                               cache_hit=info["cache_hit"] if k == 0 else True, walk=walk,
                                               radix_info=info if k == 0 else None)
            # not result-cached: the merged state covers the whole group, not
            # one region's data version
            responses[i] = CopResponse(chunk=out_chunk, exec_summaries=summaries, batched=1,
                                       mesh_merged=len(entries))
        return True

    def _lane_attribution(self, region, in_chunk, out_bytes: int, counts, share: int, compile_ns: int,
                          cache_hit: bool, walk, radix_info=None) -> list:
        """One served lane's read flow into the PD heartbeat and its
        ExecSummary list: its share of the bucket's time on each executor,
        the compile attribution, and the bytes on the data movers (the
        scan's decoded region bytes in, the final executor's result out)."""
        from ..util import metrics

        self.pd.flow.record_read(region.region_id, in_chunk.nbytes(), in_chunk.num_rows())
        metrics.COP_REQUESTS.inc()
        metrics.COP_DURATION.observe(share / 1e9)
        in_b = in_chunk.nbytes()
        summaries = [
            ExecSummary(
                time_processed_ns=share, num_produced_rows=r,
                time_compile_ns=compile_ns, cache_hit=cache_hit,
                num_bytes=in_b if j == 0 else (out_bytes if j == len(counts) - 1 else 0),
            )
            for j, r in enumerate(counts)
        ]
        if radix_info:
            _apply_radix_attribution(summaries, walk, radix_info)
        for ex, r in zip(walk, counts):
            metrics.COP_EXECUTOR_ROWS.labels(type(ex).__name__.lower()).inc(r)
        return summaries

    def _run_cop_batch(self, entries, responses, group_capacity: int) -> None:
        """Decode a same-DAG group of region tasks, bucket them by
        power-of-two capacity, and run the region-batched program once per
        bucket. Without the buckets one large region would pad every lane
        to its size. A bucket of one takes the plain path; a decode failure
        sends the whole group through the single-request path, which owns
        the capacity ladder and the oracle fallback."""
        from ..util import tracing

        req0 = entries[0][1]
        ver = self._snapshot_write_ver()  # pre-read snapshot: gates the cache inserts
        try:
            with tracing.span("cop.batch_decode", regions=len(entries)) as dsp:
                chunks = [self.region_chunk(region, req.ranges, req.dag, req.start_ts)
                          for (_i, req, region) in entries]
                if dsp is not None:
                    dsp.set("bytes_to_device", sum(ch.nbytes() for ch in chunks))
                aux_batches = [self._aux_batch(c) for c in req0.aux_chunks]
        except Exception:  # noqa: BLE001 — degrade, never lose the batch
            self._count("batch_fallbacks")
            for i, req, _region in entries:
                responses[i] = self.coprocessor(req, group_capacity)
            return
        buckets: dict[int, list] = {}
        for k, ch in enumerate(chunks):
            buckets.setdefault(_pow2(max(ch.num_rows(), 1)), []).append(k)
        batch_id = 0
        for cap, idxs in buckets.items():
            if len(idxs) == 1:  # nothing to amortize at this capacity
                i, req, _region = entries[idxs[0]]
                responses[i] = self.coprocessor(req, group_capacity)
                continue
            batch_id += 1
            self._launch_cop_bucket([entries[k] for k in idxs], [chunks[k] for k in idxs], cap, aux_batches,
                                    responses, group_capacity, ver, batch_id)

    def _launch_cop_bucket(self, entries, chunks, cap: int, aux_batches, responses, group_capacity: int,
                           write_ver: int, batch_id: int) -> None:
        """ONE execution of the region-batched program for a capacity
        bucket of decoded regions."""
        from ..exec.dag import executor_walk
        from ..topsql import record_device, split_by_rows
        from ..util import metrics, tracing

        req0 = entries[0][1]
        dag = req0.dag
        t0 = time.monotonic_ns()  # the bucket's own clock
        try:
            with tracing.span("cop.batch_execute", regions=len(entries), capacity=cap) as xsp:
                # a power-of-two lane axis: vmap_batch is in the program key,
                # so batches of every size share a few programs; empty lanes
                # pad it
                lanes = list(chunks)
                lanes += [Chunk.empty(chunks[0].field_types()) for _ in range(_pow2(len(chunks)) - len(chunks))]
                stacked = to_stacked_device_batch(lanes, cap, device=self.device)
                per_region, info = drive_batched_program_info(self.programs, dag, stacked, aux_batches,
                                                              group_capacity, small_groups=req0.small_groups)
                self._count("host_fetches", info["fetches"])
                if xsp is not None:
                    xsp.set("cache_hit", info["cache_hit"])
        except Exception:  # noqa: BLE001 — degrade, never lose the bucket
            # an op the device program does not express, non-ASCII CI data,
            # any failure of the batched program: the single path answers
            # each region with its own fallback and error contract
            self._count("batch_fallbacks")
            for i, req, _region in entries:
                responses[i] = self.coprocessor(req, group_capacity)
            return
        elapsed = time.monotonic_ns() - t0
        # each lane's share by decoded rows (the shares sum to the elapsed
        # time); a lane that falls out keeps its share, its retry is billed
        # on its own
        shares = split_by_rows(elapsed, [ch.num_rows() for ch in chunks])
        record_device(elapsed, compile_ns=info["compile_ns"], bytes_to_device=sum(ch.nbytes() for ch in chunks))
        walk = executor_walk(dag.executors)
        metrics.BATCH_COP_BATCHES.inc()
        self._count("batch_batches")
        served = 0
        for lane, ((i, req, region), ch, res) in enumerate(zip(entries, chunks, per_region)):
            if res is None:
                # this lane's group / join / TopN flag fired: it alone rides
                # the single-request retry ladder
                responses[i] = self.coprocessor(req, group_capacity)
                continue
            chunk, ex_rows = res
            metrics.BATCH_COP_REGIONS.inc()
            self._count("batch_regions")
            self._count("device_served")
            lane_info = info
            if info.get("radix"):
                # the lane's own escape count
                lane_info = {"radix": dict(info["radix"], escapes=info["radix"]["escapes_by_lane"][lane])}
            # the one program's build time goes on the first served lane;
            # the others are cache hits by construction
            summaries = self._lane_attribution(region, ch, chunk.nbytes(), ex_rows, shares[lane],
                                               compile_ns=info["compile_ns"] if served == 0 else 0,
                                               cache_hit=info["cache_hit"] if served == 0 else True,
                                               walk=walk, radix_info=lane_info)
            served += 1
            resp = CopResponse(chunk=chunk, exec_summaries=summaries, batched=batch_id)
            self._cop_cache_put(req, resp, write_ver=write_ver, flow=(ch.nbytes(), ch.num_rows()))
            responses[i] = resp
        if served > 1:
            metrics.BATCH_COP_LAUNCHES_SAVED.inc(served - 1)
            self._count("batch_launches_saved", served - 1)

    def batch_coprocessor_bytes(self, req_bytes: bytes) -> bytes:
        """The batched endpoint from wire bytes to wire bytes: one frame of
        N cop requests in, one frame of N responses out (codec/wire.py
        batch frames)."""
        from ..codec.wire import decode_batch_cop_request, encode_batch_cop_response

        try:
            reqs = decode_batch_cop_request(req_bytes)
        except Exception as exc:  # malformed bytes must not kill the server
            self._count("other_errors")
            return encode_batch_cop_response([CopResponse(other_error=f"bad batch request: {exc}")])
        return encode_batch_cop_response(self.batch_coprocessor(reqs))
