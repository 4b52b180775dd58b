"""The columnar replica store — this framework's TiFlash (ref: TiDB: A
Raft-based HTAP Database, VLDB'20 §3: a log-replicated columnar replica
that serves analytics without disturbing OLTP; the delta/stable layering
follows TiFlash's DeltaTree design, where fresh log entries land in a
row-versioned DELTA layer and a background pass folds them into sorted,
deduplicated STABLE column chunks).

One `ColumnarReplica` per TPUStore. Each replicated table (one
`ColumnarTable` per PHYSICAL table id, like the row keyspace) holds:

  delta    a row-versioned append buffer — `(commit_ts, handle, row|None)`
           entries exactly as the changefeed's mounter produced them
           (typed datums, NO rowcodec anywhere in this tier: the mounter
           decoded once when the event entered the feed)
  stable   the folded form: one live row per handle, sorted by handle,
           held as a host `Chunk` AND a `DeviceBatch` resident on the
           store's device (chunk/device.py) so analytical scans ship zero
           bytes and decode nothing — the fused program reads HBM directly
  applied  the feed's flushed resolved-ts: every commit at or below it
           has been applied (the scan-readiness gate)
  floor    `stable_ts`, the compaction watermark: versions at or below it
           were folded, so a snapshot OLDER than the floor cannot be
           reconstructed here and falls back to the row store

Consistency contract (the chaos storm's oracle): a scan served at
`start_ts` requires `stable_ts <= start_ts <= applied_ts` and is then
byte-identical to a row-store scan at the same snapshot — stable rows all
predate the floor, and the delta overlay replays exactly the versions in
`(stable_ts, start_ts]`.

Lock order: replica._mu and each table._mu are leaves — nothing else is
acquired under them (the device upload in compact() runs under table._mu
but touches only torch, never another subsystem lock).

Port of `tidb_tpu/columnar/replica.py` (imports rewritten; it imports
nothing of tidb_tpu). What differs: a table uploads its stable batch to
the store's device (`ColumnarTable(..., device=store.device)`), where the
reference's `to_device_batch` has no device argument.
"""

from __future__ import annotations

import threading

from ..chunk import Chunk

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1


class ColumnarNotReady(RuntimeError):
    """DataIsNotReady's columnar shape (ref: TiKV's replica read answering
    errorpb.DataIsNotReady when `safe_ts < start_ts`): the replica cannot
    serve this snapshot — the resolved frontier trails it (`applied_ts <
    start_ts`) or compaction folded past it (`start_ts < stable_ts`). The
    route layer waits once on the data_not_ready backoff budget, then
    falls back to the row store."""

    def __init__(self, table: str, start_ts: int, applied_ts: int, stable_ts: int):
        super().__init__(
            f"columnar data_is_not_ready: table {table!r} start_ts={start_ts} "
            f"applied_ts={applied_ts} stable_ts={stable_ts}")
        self.table = table
        self.start_ts = start_ts
        self.applied_ts = applied_ts
        self.stable_ts = stable_ts


def _fold_newest(entries: list) -> dict:
    """Latest version per handle, with PUT beating DELETE on a commit-ts
    tie. The tie is real: an UPDATE that moves a row across partitions
    emits delete(old pid) + put(new pid) at the SAME commit ts, and the
    apply sink fans the value-less delete to EVERY pid — without the
    tie-break, the tombstone could erase the new partition's live row
    (the replay sink's `latest_ts(key) < commit_ts` skip, folded into
    the delta semantics; within ONE pid a txn never commits both a put
    and a delete of the same key at one ts, so the tie-break only ever
    fires on the cross-pid fan-out)."""
    newest: dict = {}
    for ts, h, row in sorted(entries, key=lambda e: (e[0], e[2] is not None)):
        newest[h] = row
    return newest


def _schema_sig(columns) -> tuple:
    """Stable identity of a scan schema: (col_id, eval type, charset) per
    column. The route layer declines when a DAG's scan no longer matches
    the replica's snapshot of the table (a mid-feed ALTER parked the feed;
    the replica keeps serving OLD-schema snapshots, never mixed ones)."""
    return tuple((c.col_id, c.ft.eval_type(), c.ft.charset or "") for c in columns)


class ColumnarTable:
    """Delta + stable layers of one physical table (ref: TiFlash's
    DeltaTree segment: delta appends, stable folded)."""

    def __init__(self, pid: int, meta, device="cuda"):
        self.pid = pid
        self.device = device  # where compact() uploads the stable batch
        self.meta = meta  # identity/current-name only — the row SHAPE
        # below snapshots at enable time (a live meta.columns read would
        # silently drift under DDL) and advances ONLY through
        # `reshape()`, driven by the feed's ordered SchemaEvents
        self.table_id = meta.table_id
        self.fts = [c.ft for c in meta.columns]
        self.schema_sig = _schema_sig(meta.columns)
        self.schema_version = meta.schema_version
        self.col_ids = [c.col_id for c in meta.columns]
        self.defaults = [c.origin_default for c in meta.columns]
        self._mu = threading.Lock()
        self.delta: list = []  # [(commit_ts, handle, row|None)]; guarded_by: _mu
        self.applied_ts = 0  # flushed resolved frontier; guarded_by: _mu
        self.stable_ts = 0  # compaction watermark (the floor); guarded_by: _mu
        self._stable_rows: dict = {}  # handle -> row datums; guarded_by: _mu
        self._stable_chunk: Chunk | None = None  # sorted by handle; guarded_by: _mu
        self._stable_handles: list = []  # sorted handles; guarded_by: _mu
        self._stable_batch = None  # device-resident stable; guarded_by: _mu
        self.applied_events = 0  # guarded_by: _mu
        self.compactions = 0  # guarded_by: _mu
        self.last_error = ""  # last compaction failure (GIL-atomic str swap)

    @property
    def name(self) -> str:
        """The table's CURRENT name — RENAME TABLE mutates meta in
        place, and views/routing must follow it (a name-keyed
        registry would orphan the feed across a rename)."""
        return self.meta.name

    # ------------------------------------------------------------ delta
    def apply(self, commit_ts: int, handle: int, row: list | None) -> None:
        """One mounted change into the delta layer (row None = delete).
        At-least-once delivery is fine: the fold is by max commit_ts per
        handle, so a redelivered (ts, handle) pair is idempotent."""
        with self._mu:
            self.delta.append((commit_ts, handle, row))
            self.applied_events += 1

    def set_applied(self, resolved_ts: int) -> None:
        """The feed's flush: every commit <= resolved_ts is in the delta."""
        with self._mu:
            if resolved_ts > self.applied_ts:
                self.applied_ts = resolved_ts

    # ---------------------------------------------------------- reshape
    def reshape(self, schema_version: int, columns) -> bool:
        """Remap every held row to a NEW column shape by col_id (a
        mid-feed ALTER arrives as an ordered SchemaEvent and the
        replica follows it instead of parking). Columns the old shape
        lacked fill from the column's origin default (NULL when none) —
        the same backfill the mounter applies to old row bytes.
        Idempotent by schema version (redelivered events no-op); returns
        True when the shape moved. `columns` is a sequence of
        ColumnSnap-shaped objects (.name/.col_id/.ft/.origin_default)."""
        from ..types import Datum

        with self._mu:
            if schema_version <= self.schema_version:
                return False
            old_idx = {cid: i for i, cid in enumerate(self.col_ids)}

            def remap(row):
                return [
                    row[old_idx[c.col_id]] if c.col_id in old_idx
                    else (c.origin_default if c.origin_default is not None
                          else Datum.NULL)
                    for c in columns
                ]

            self._stable_rows = {h: remap(r) for h, r in self._stable_rows.items()}
            self.delta = [(ts, h, None if r is None else remap(r))
                          for ts, h, r in self.delta]
            self.fts = [c.ft for c in columns]
            self.schema_sig = _schema_sig(columns)
            self.col_ids = [c.col_id for c in columns]
            self.defaults = [c.origin_default for c in columns]
            self.schema_version = schema_version
            self._stable_chunk = Chunk.from_rows(
                self.fts, [self._stable_rows[h] for h in self._stable_handles])
            # the host chunk serves until the next compact re-uploads;
            # a stale-shape device batch must never outlive the remap
            self._stable_batch = None
            return True

    # ------------------------------------------------------- compaction
    def compact(self) -> int:
        """Fold every delta entry at or below the applied frontier into
        the stable layer: latest version per handle wins, deletes remove
        the row, the result sorts by handle and re-uploads to device.
        Returns entries folded. The floor (`stable_ts`) advances to the
        frontier the fold ran at — snapshots older than that can no
        longer be served here (their overwritten versions are gone)."""
        from ..chunk.device import to_device_batch
        from ..exec.executor import _pow2

        with self._mu:
            fold_ts = self.applied_ts
            take = [e for e in self.delta if e[0] <= fold_ts]
            if not take:
                # nothing to fold: the floor must NOT creep to the
                # frontier — an unchanged stable layer still serves every
                # snapshot down to the floor it was folded at (floor
                # creep would decline stale reads for no reason)
                if self._stable_chunk is None:
                    # first pass over a never-written table: materialize
                    # the empty stable chunk so the scan fast path
                    # exists (floor stays 0 — empty at every snapshot)
                    self._stable_chunk = Chunk.from_rows(self.fts, [])
                return 0
            self.delta = [e for e in self.delta if e[0] > fold_ts]
            newest = _fold_newest(take)
            for h, row in newest.items():
                if row is None:
                    self._stable_rows.pop(h, None)
                else:
                    self._stable_rows[h] = row
            handles = sorted(self._stable_rows)
            chunk = Chunk.from_rows(self.fts, [self._stable_rows[h] for h in handles])
            batch = None
            try:
                # device-resident stable: scans drive the fused program
                # straight from HBM (non-ASCII CI columns can't ride the
                # device CI kernels — chunk-only, the scan's oracle
                # fallback serves)
                batch = to_device_batch(chunk, capacity=_pow2(max(chunk.num_rows(), 1)),
                                        device=self.device)
            except NotImplementedError:
                batch = None
            self._stable_chunk = chunk
            self._stable_handles = handles
            self._stable_batch = batch
            self.stable_ts = fold_ts
            self.compactions += 1
            return len(take)

    # ------------------------------------------------------------ scans
    def frontier(self) -> tuple:
        """(applied_ts, stable_ts) snapshot for the readiness gate."""
        with self._mu:
            return self.applied_ts, self.stable_ts

    def scan(self, start_ts: int, intervals: list | None):
        """Rows visible at `start_ts` as (chunk, device_batch|None).
        `intervals` is a list of inclusive (lo, hi) handle bounds (None =
        the whole table). The fast path — no unfolded delta at this
        snapshot, full-range scan — returns the cached stable chunk and
        its device-resident batch untouched; otherwise the delta overlay
        merges on the host (still typed datums, never rowcodec)."""
        with self._mu:
            if start_ts < self.stable_ts or start_ts > self.applied_ts:
                raise ColumnarNotReady(self.name, start_ts, self.applied_ts, self.stable_ts)
            overlay = [e for e in self.delta if e[0] <= start_ts]
            full = intervals is None or any(
                lo <= I64_MIN and hi >= I64_MAX for lo, hi in intervals)
            if not overlay and full and self._stable_chunk is not None:
                return self._stable_chunk, self._stable_batch
            merged = dict(self._stable_rows)
            newest = _fold_newest(overlay)
            for h, row in newest.items():
                if row is None:
                    merged.pop(h, None)
                else:
                    merged[h] = row
            handles = sorted(merged)
            if intervals is not None and not full:
                handles = [
                    h for h in handles
                    if any(lo <= h <= hi for lo, hi in intervals)
                ]
            return Chunk.from_rows(self.fts, [merged[h] for h in handles]), None

    def view(self) -> dict:
        with self._mu:
            return {
                "pid": self.pid,
                "delta_rows": len(self.delta),
                "stable_rows": len(self._stable_handles),
                "stable_chunk": self._stable_chunk is not None,
                "on_device": self._stable_batch is not None,
                "applied_ts": self.applied_ts,
                "stable_ts": self.stable_ts,
                "applied_events": self.applied_events,
                "compactions": self.compactions,
                "error": self.last_error,
            }


class ColumnarReplica:
    """All columnar tables of one store + their feeding changefeeds.
    `enable_table` creates one changefeed per logical table (sink =
    ColumnarSink) whose birth incremental scan backfills full history;
    `compact_tick` is the `pd.columnar` phase body."""

    def __init__(self, store):
        self.store = store
        self._mu = threading.Lock()
        self._by_pid: dict = {}  # pid -> ColumnarTable; guarded_by: _mu
        # keyed by the IMMUTABLE logical table id, not the name — RENAME
        # TABLE mutates meta.name in place, and a name-keyed registry
        # would orphan the feeding changefeed (a live GC safepoint) on
        # the disable under the new name
        self._feeds: dict = {}  # table_id -> changefeed name; guarded_by: _mu
        self._gauge_names: dict = {}  # table_id -> last gauge label; guarded_by: _mu

    # -------------------------------------------------------- lifecycle
    def enable_table(self, catalog, meta) -> None:
        """Attach a columnar replica to `meta`: register its physical
        tables and create the feeding changefeed (idempotent). The
        tables register BEFORE the feed exists — `cdc.create` makes the
        feed tickable immediately, and a background PD tick landing in
        the gap would hand the whole birth backfill to a sink whose
        `table_for` lookups miss (silently dropping every pre-existing
        row forever)."""
        from ..cdc import ChangefeedError
        from .sink import ColumnarSink

        tables = {pid: ColumnarTable(pid, meta, device=self.store.device) for pid in meta.physical_ids()}
        feed_name = f"columnar:{meta.name}"
        with self._mu:
            if meta.table_id in self._feeds:
                return
            self._feeds[meta.table_id] = feed_name  # reservation: a racing
            # enable sees it and returns; rolled back if create fails
            self._by_pid.update(tables)
        sink = ColumnarSink(self, catalog, meta)
        try:
            self.store.cdc.create(
                feed_name, sink, catalog,
                table_ids=set(meta.physical_ids()) | {meta.table_id}, start_ts=0)
        except ChangefeedError:
            with self._mu:
                self._feeds.pop(meta.table_id, None)
                for pid in tables:
                    self._by_pid.pop(pid, None)
            raise

    def disable_table(self, meta) -> None:
        from ..cdc import ChangefeedError
        from ..util import metrics

        with self._mu:
            feed_name = self._feeds.pop(meta.table_id, None)
            last_label = self._gauge_names.pop(meta.table_id, None)
            for pid in meta.physical_ids():
                self._by_pid.pop(pid, None)
        if last_label is not None and last_label != meta.name:
            from ..util import metrics

            metrics.COLUMNAR_RESOLVED_LAG.labels(last_label).set(0)
        if feed_name is not None:
            try:
                self.store.cdc.drop(feed_name)
            except ChangefeedError:
                pass  # the feed was dropped out from under us
            metrics.COLUMNAR_RESOLVED_LAG.labels(meta.name).set(0)

    def enabled(self, table_id: int) -> bool:
        with self._mu:
            return table_id in self._feeds

    def resume_all(self) -> None:
        """RESUME every columnar feed parked in `error` (the storm's
        recovery action after a columnar/apply-stall window)."""
        from ..cdc import ChangefeedError

        with self._mu:
            names = list(self._feeds.values())
        for n in names:
            try:
                self.store.cdc.get(n).resume()
            except ChangefeedError:
                pass

    # ----------------------------------------------------------- lookup
    def table_for(self, pid: int) -> ColumnarTable | None:
        with self._mu:
            return self._by_pid.get(pid)

    def tables(self) -> list:
        with self._mu:
            return list(self._by_pid.values())

    def has_tables(self) -> bool:
        with self._mu:
            return bool(self._by_pid)

    def feed_state(self, table_id: int) -> str:
        """Lifecycle state of the feed replicating one logical table."""
        from ..cdc import ChangefeedError

        with self._mu:
            feed_name = self._feeds.get(table_id)
        if feed_name is None:
            return "disabled"
        try:
            feed = self.store.cdc.get(feed_name)
        except ChangefeedError:
            return "removed"
        with feed._mu:
            return feed.state

    # ------------------------------------------------------- compaction
    def compact_tick(self) -> int:
        """One background compaction round (the `pd.columnar` tick phase
        body, riding the same Timer the pd/cdc ticks do): fold every
        table's delta into its stable layer and refresh the freshness
        gauges. `columnar/compact-stall` skips the fold — delta grows,
        scans keep serving (the floor just stops advancing)."""
        from ..util import failpoint, metrics, tracing

        if failpoint.eval("columnar/compact-stall"):
            return 0
        folded = 0
        for t in self.tables():
            with tracing.span("columnar.compact", table=t.name, pid=t.pid) as sp:
                try:
                    n = t.compact()
                except Exception as exc:  # noqa: BLE001 — one poisoned
                    # table must not abort the PD tick's remaining
                    # phases (schedule/dispatch run after pd.columnar);
                    # the error surfaces in the table view and the scan
                    # path keeps falling back safely
                    t.last_error = f"{type(exc).__name__}: {exc}"
                    if sp is not None:
                        sp.set("error", t.last_error)
                    continue
                if sp is not None:
                    sp.set("rows_folded", n)
            if n:
                metrics.COLUMNAR_COMPACTIONS.inc()
            folded += n
        self._refresh_gauges()
        return folded

    def _refresh_gauges(self) -> None:
        from ..util import metrics

        top = self.store.kv.max_committed()
        for tid, (name, applied) in self._applied_by_id().items():
            with self._mu:
                old = self._gauge_names.get(tid)
                self._gauge_names[tid] = name
            if old is not None and old != name:
                # RENAME TABLE moved the label: zero the stranded series
                # or its last lag value alerts forever
                metrics.COLUMNAR_RESOLVED_LAG.labels(old).set(0)
            metrics.COLUMNAR_RESOLVED_LAG.labels(name).set(max(top - applied, 0))

    def _applied_by_id(self) -> dict:
        """table_id -> (current name, min applied across its pids)."""
        out: dict = {}
        for t in self.tables():
            a, _f = t.frontier()
            prev = out.get(t.table_id)
            out[t.table_id] = (t.name, a if prev is None else min(prev[1], a))
        return out

    # ------------------------------------------------------------ views
    def views(self) -> list:
        """One row per logical table (SHOW COLUMNAR TABLES and the
        /columnar/api/v1/tables HTTP view)."""
        top = self.store.kv.max_committed()
        by_name: dict = {}
        for t in self.tables():
            v = t.view()
            agg = by_name.setdefault(t.name, {
                "table": t.name, "state": self.feed_state(t.table_id),
                "pids": 0, "delta_rows": 0, "stable_rows": 0,
                "stable_chunks": 0, "applied_events": 0, "compactions": 0,
                "applied_ts": v["applied_ts"], "stable_ts": v["stable_ts"],
            })
            agg["pids"] += 1
            agg["delta_rows"] += v["delta_rows"]
            agg["stable_rows"] += v["stable_rows"]
            agg["stable_chunks"] += 1 if v["stable_chunk"] else 0
            agg["applied_events"] += v["applied_events"]
            agg["compactions"] += v["compactions"]
            agg["applied_ts"] = min(agg["applied_ts"], v["applied_ts"])
            agg["stable_ts"] = max(agg["stable_ts"], v["stable_ts"])
        for agg in by_name.values():
            agg["resolved_ts_lag"] = max(top - agg["applied_ts"], 0)
        return [by_name[k] for k in sorted(by_name)]
