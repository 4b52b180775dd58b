"""The mounter: raw KV change -> typed row event (ref: TiCDC's
cdc/entry/mounter.go — it decodes the raft-log value bytes back into
column datums against the schema snapshot the row was WRITTEN under).

Only RECORD keys mount (`t{tid}_r{handle}`): index entries are derived
data the downstream rebuilds itself, and non-table keyspaces (the
m-prefix schema metadata) are not row changes — both return None and the
caller counts them as skipped. Partitioned tables mount through the
partition's physical id back to the LOGICAL table meta, exactly like the
reference resolves PartitionDefinition.ID -> TableInfo.

Schema tracking: the mounter keeps a per-feed SNAPSHOT of
every subscribed table's column shape (`SchemaSnapshot`, not just a
version int). Rows decode against the TRACKED snapshot; a schema-change
entry draining through the sorter calls `apply_schema`, which advances
the snapshot and yields a `SchemaEvent` for the sink — so a mid-feed
ALTER replicates as an ordered event instead of parking the feed.
`SchemaDriftError` survives only as a counted legacy fallback: a row
whose bytes no longer decode against the tracked snapshot (a schema
move the journal never explained) re-decodes against the live catalog
and counts CDC_SCHEMA_DRIFT_LEGACY instead of wedging the pipeline."""

from __future__ import annotations

import threading

from ..codec import tablecodec
from ..codec.rowcodec import decode_row_to_datum_map, fill_origin_default
from .events import RowEvent, SchemaEvent
from .schema import SchemaSnapshot, decode_payload, snapshot_from_meta, snapshot_from_payload


class SchemaDriftError(RuntimeError):
    """A table's ROW-SHAPE schema moved under a live changefeed with no
    schema-change entry in the log to explain it (the old park
    signal, kept as a TYPED name for the counted legacy-fallback path:
    the mounter re-snapshots the live catalog and keeps mounting instead
    of parking, but the drift is still visible in metrics)."""

    def __init__(self, table: str, stamped: int, current: int):
        super().__init__(
            f"schema drift: table {table!r} changed mid-feed "
            f"(tracked version {stamped}, now {current}) — "
            f"re-decoded against the live catalog (counted legacy fallback)")
        self.table = table
        self.stamped = stamped
        self.current = current


class Mounter:
    """Decodes change values against per-table tracked schema snapshots.
    The pid->meta map rebuilds whenever the catalog version moves. Each
    table's snapshot seeds from the CURRENT catalog the first time the
    mounter sees it (or up front via `stamp_tables` — the feed's birth
    snapshot) and then advances ONLY through `apply_schema` — the
    replicated DDL stream, not the live catalog, drives the decode
    shape."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._mu = threading.Lock()
        self._by_pid: dict = {}  # physical table id -> TableMeta; guarded_by: _mu
        self._cat_version = -1  # guarded_by: _mu
        self._tracked: dict = {}  # table_id -> SchemaSnapshot; guarded_by: _mu

    def _meta_for(self, pid: int):
        """-> (meta, tracked SchemaSnapshot) — (None, None) for an
        unknown pid. ONE critical section covers the map refresh, the
        lookup AND the first-sight snapshot (a second acquisition per
        event would double-lock the CDC hot mount loop)."""
        with self._mu:
            if self._cat_version != self.catalog.version:
                by_pid: dict = {}
                for name in self.catalog.tables():
                    try:
                        meta = self.catalog.table(name)
                    except Exception:  # noqa: BLE001 — a racing DROP TABLE
                        continue  # must not kill the mount loop
                    for p in meta.physical_ids():
                        by_pid[p] = meta
                self._by_pid = by_pid
                self._cat_version = self.catalog.version
            meta = self._by_pid.get(pid)
            if meta is None:
                return None, None
            snap = self._tracked.get(meta.table_id)
            if snap is None:
                snap = self._tracked[meta.table_id] = snapshot_from_meta(meta)
            return meta, snap

    def stamp_tables(self, table_ids=None) -> None:
        """Snapshot the CURRENT row shape of every (subscribed) table —
        the feed's birth schema snapshot. Tables first seen later
        snapshot lazily in mount()."""
        for name in self.catalog.tables():
            try:
                meta = self.catalog.table(name)
            except Exception:  # noqa: BLE001 — a racing DROP TABLE
                continue
            if table_ids is not None and meta.table_id not in table_ids and not any(
                    p in table_ids for p in meta.physical_ids()):
                continue
            with self._mu:
                self._tracked.setdefault(meta.table_id, snapshot_from_meta(meta))

    def restamp(self) -> None:
        """Drop every tracked snapshot: the next mount re-snapshots at
        the then-current catalog shape (RESUME's legacy escape hatch for
        feeds whose schema stream lapsed entirely)."""
        with self._mu:
            self._tracked.clear()

    def apply_schema(self, value: bytes, commit_ts: int) -> SchemaEvent | None:
        """One schema-change entry draining through the sorter: advance
        the tracked snapshot and return the SchemaEvent for the sink.
        Returns None (the caller counts a skip) when the entry is STALE —
        at or below the tracked version, e.g. a journal re-injection
        after the feed's birth snapshot already included the change, or
        a (key, ts) redelivery."""
        try:
            payload = decode_payload(value)
        except (ValueError, KeyError):
            return None  # malformed entry: skip, never wedge the feed
        tid = payload["table_id"]
        snap = snapshot_from_payload(payload)
        with self._mu:
            cur = self._tracked.get(tid)
            if cur is not None and snap.version <= cur.version:
                return None
            self._tracked[tid] = snap
        # the event wears the table's CURRENT name (RENAME TABLE mutates
        # meta in place and downstream lookups follow the live name)
        name = payload["table"]
        meta = self._by_pid.get(tid)  # vet: ignore[lock-discipline] — GIL-atomic probe
        if meta is not None:
            name = meta.name
        return SchemaEvent(name, tid, commit_ts, snap.version,
                           payload.get("op", "alter"),
                           payload.get("query", ""), payload)

    def _decode(self, meta, snap: SchemaSnapshot, value: bytes):
        fts_by_id = {c.col_id: c.ft for c in snap.columns}
        dmap = decode_row_to_datum_map(value, fts_by_id)
        return tuple(
            (c.name, fill_origin_default(value, c.col_id, c.origin_default, dmap[c.col_id]))
            for c in snap.columns
        )

    def mount(self, key: bytes, value: bytes | None, commit_ts: int) -> RowEvent | None:
        """One raw change -> RowEvent, or None when the key is not a row
        of a known table (index entry, meta keyspace, dropped table).
        Decodes against the TRACKED snapshot; on failure, falls back to
        the live catalog shape as a counted SchemaDriftError legacy
        fallback (never a park)."""
        try:
            pid, handle = tablecodec.decode_row_key(key)
        except ValueError:
            return None  # index/meta key: derived data, the caller skips
        meta, snap = self._meta_for(pid)
        if meta is None:
            return None
        if value is None:
            return RowEvent(meta.name, meta.table_id, handle, "delete", commit_ts)
        try:
            cols = self._decode(meta, snap, value)
        except Exception:  # noqa: BLE001 — bytes the tracked snapshot
            # cannot explain: a schema move the log never carried (the
            # old drift park). Fall back to the live catalog
            # shape, count it, and re-track so the next rows decode on
            # the first try.
            from ..util import metrics

            live = snapshot_from_meta(meta)
            try:
                cols = self._decode(meta, live, value)
            except Exception:  # noqa: BLE001 — undecodable either way:
                return None  # skip, never wedge the feed
            metrics.CDC_SCHEMA_DRIFT_LEGACY.inc()
            with self._mu:
                self._tracked[meta.table_id] = live
            snap = live
        return RowEvent(meta.name, meta.table_id, handle, "put", commit_ts, cols,
                        tuple(c.col_id for c in snap.columns))
