"""Changefeed sinks (ref: TiCDC's cdc/sink — MQ/blackhole/MySQL sinks
behind one interface). Three concrete sinks:

  MemorySink         buffered events + resolved marks (tests, SHOW-style
                     introspection; the blackhole sink with a memory)
  FileSink           JSON-lines segments under a directory, one
                     subdirectory per changefeed (the storage sink
                     analog; each flush writes ONE atomic segment ending
                     in a resolved mark, so a consumer can cut complete
                     prefixes and a crash can never leave a torn tail)
  SessionReplaySink  applies the stream into a SECOND cluster through
                     its store write path (the MySQL-sink analog; the
                     mirror-equality oracle rides this one); schema
                     events apply the replicated DDL to the mirror
                     catalog

The contract every sink honors: `write(events)` receives rows in
(commit_ts, key) order, all at or below the NEXT `flush(resolved_ts)` —
a flushed resolved ts promises the downstream holds a transactionally
complete prefix of the source."""

from __future__ import annotations

import json
import os
import threading


class SinkError(RuntimeError):
    """A sink rejected the stream (unknown downstream table, closed
    file): the changefeed parks in the `error` state with this message."""


def open_sink(uri: str, name: str):
    """Sink from a sink-uri (ref: TiCDC's --sink-uri schemes). Supported:
    `memory://` and `file://<dir>` (empty dir -> ./cdc-output). The
    session-replay sink needs a live target cluster and is registered via
    the hub API, not a URI."""
    scheme, _, rest = uri.partition("://")
    scheme = scheme.lower()
    if scheme == "memory":
        return MemorySink()
    if scheme == "file":
        return FileSink(rest or "cdc-output", name)
    raise SinkError(
        f"unsupported sink uri {uri!r} (memory:// | file://<dir>; "
        f"session-replay sinks attach via the changefeed API)")


class Sink:
    def write(self, events: list) -> None:
        raise NotImplementedError

    def flush(self, resolved_ts: int) -> None:
        """All events at or below `resolved_ts` are written: make them
        durable/visible downstream."""

    def close(self) -> None:
        pass

    def describe(self) -> str:
        return type(self).__name__


class MemorySink(Sink):
    def __init__(self):
        self._mu = threading.Lock()
        self.events: list = []  # guarded_by: _mu
        self.resolved: list = []  # flush watermarks, in order; guarded_by: _mu

    def write(self, events: list) -> None:
        with self._mu:
            self.events.extend(events)

    def flush(self, resolved_ts: int) -> None:
        with self._mu:
            self.resolved.append(resolved_ts)

    def rows(self) -> list:
        with self._mu:
            return list(self.events)

    def resolved_view(self) -> list:
        with self._mu:
            return list(self.resolved)

    def describe(self) -> str:
        return "memory://"


class SegmentWriter:
    """Atomic JSONL segment writer (ref: br/pkg/storage's
    write-then-rename local backend). Each segment is written whole to a
    `.tmp` sibling, fsync'd, then renamed into place — a segment is
    either fully present or absent, never a torn tail. Consumers read
    `seg-*.jsonl` in name order and ignore `*.tmp` leftovers."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._mu = threading.Lock()
        # resume past segments already durable (a re-attached sink must
        # never overwrite a committed segment); guarded_by: _mu
        self._next = 1 + max(
            (int(f[4:10]) for f in os.listdir(directory)
             if f.startswith("seg-") and f.endswith(".jsonl")), default=-1)

    def write_segment(self, lines: list) -> str:
        """One atomic segment of complete JSON lines; returns the file
        name. The tmp file is removed on failure so a crashed flush
        leaves nothing a consumer could mistake for data."""
        from ..util import failpoint

        with self._mu:
            fname = f"seg-{self._next:06d}.jsonl"
            tmp = os.path.join(self.directory, fname + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                f.write("".join(line + "\n" for line in lines))
                f.flush()
                os.fsync(f.fileno())
            if failpoint.eval("cdc/segment-crash"):
                # the kill-mid-flush drill: the process "dies" with the
                # tmp written but never renamed in — the leftover MUST be
                # invisible to consumers (the torn-tail crash this
                # writer exists to fix), so it deliberately stays behind
                raise SinkError(
                    "cdc/segment-crash: killed between write and rename")
            try:
                os.replace(tmp, os.path.join(self.directory, fname))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._next += 1
            return fname

    def segments(self) -> list:
        """Durable segment file names, in write order."""
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("seg-") and f.endswith(".jsonl"))

    def read_records(self) -> list:
        """Every record of every durable segment, in order — the
        consumer's view (tmp leftovers and torn tails cannot appear:
        only renamed-in segments are read)."""
        out = []
        for fname in self.segments():
            with open(os.path.join(self.directory, fname), encoding="utf-8") as f:
                out.extend(json.loads(line) for line in f if line.strip())
        return out


class FileSink(Sink):
    """JSON-lines segments: `write` buffers the batch, `flush` commits
    it as ONE atomic segment (SegmentWriter: write-temp + fsync +
    rename) ending in a `{"type":"resolved","ts":N}` mark — any prefix
    of segments is a consistent cut, and a kill mid-flush leaves only
    whole segments behind (the torn-tail crash bug this replaced: a
    partial JSON line in an append-mode file poisoned every later read).
    A failed flush drops the buffer — the feed re-queues the batch below
    its held checkpoint and redelivers it to a fresh flush, so exactly
    one durable copy ever lands."""

    def __init__(self, directory: str, name: str):
        self.directory = os.path.join(directory, name)
        self.writer = SegmentWriter(self.directory)
        self._mu = threading.Lock()
        self._buf: list = []  # pending event lines; guarded_by: _mu

    def write(self, events: list) -> None:
        with self._mu:
            self._buf.extend(json.dumps(ev.to_json(), default=str) for ev in events)

    def flush(self, resolved_ts: int) -> None:
        with self._mu:
            lines, self._buf = self._buf, []
            if not lines:
                return  # quiet window: no empty segment spam per tick
            lines.append(json.dumps({"type": "resolved", "ts": resolved_ts}))
            self.writer.write_segment(lines)

    def read_records(self) -> list:
        return self.writer.read_records()

    def describe(self) -> str:
        return f"file://{self.directory}"


class SessionReplaySink(Sink):
    """Replays the stream into a second cluster through its store write
    path (rows only — the downstream's schema owns its indexes; create
    the mirror's tables without secondary indexes or rebuild them after).
    `flush` fast-forwards the mirror's TSO past the resolved frontier so
    a fresh mirror snapshot sees the complete replayed prefix.

    Delivery after a sink failure is AT-LEAST-ONCE from the last
    checkpoint (the reference's contract — TiCDC re-sends on recovery),
    so this sink is idempotent by (key, commit_ts): a version the mirror
    already holds at or past the event's ts is skipped, exactly like the
    MySQL sink's REPLACE-by-commit-ts semantics."""

    def __init__(self, session):
        self.session = session

    def _apply_schema(self, ev) -> None:
        """One replicated DDL onto the mirror catalog: rebuild the
        table's column list from the event payload (idempotent — a
        redelivered event at or below the mirror's version is a no-op).
        The mirror keeps consuming instead of parking."""
        from ..sql.catalog import CatalogError, ColumnMeta
        from .schema import snapshot_from_payload

        catalog = self.session.catalog
        try:
            meta = catalog.table(ev.table)
        except CatalogError as exc:
            raise SinkError(f"replay: no downstream table for {ev.table!r}") from exc
        if meta.schema_version >= ev.schema_version:
            return  # redelivery / already applied
        snap = snapshot_from_payload(ev.payload)
        meta.columns = [
            ColumnMeta(c.name, c.col_id, c.ft, origin_default=c.origin_default)
            for c in snap.columns
        ]
        handle_col = ev.payload.get("handle_col")
        if handle_col:
            meta.handle_col = handle_col
        meta.next_col_id = max(meta.next_col_id,
                               ev.payload.get("next_col_id", 0),
                               max((c.col_id for c in snap.columns), default=0) + 1)
        meta.schema_version = ev.schema_version
        catalog.version += 1

    def write(self, events: list) -> None:
        from ..codec import tablecodec
        from ..sql.catalog import CatalogError
        from ..types import Datum
        from .events import SchemaEvent

        catalog = self.session.catalog
        store = self.session.store
        for ev in events:
            if isinstance(ev, SchemaEvent):
                self._apply_schema(ev)
                continue
            try:
                meta = catalog.table(ev.table)
            except CatalogError as exc:
                raise SinkError(f"replay: no downstream table for {ev.table!r}") from exc
            if ev.op == "delete":
                # the row's partition is value-dependent and deletes carry
                # no values: tombstone the handle in every physical id
                # (over-deleting is sound — absent keys tombstone to absent)
                for pid in meta.physical_ids():
                    key = tablecodec.encode_row_key(pid, ev.handle)
                    if store.kv.latest_ts(key) < ev.commit_ts:
                        store.delete_row(pid, ev.handle, ev.commit_ts)
                continue
            by_name = dict(ev.columns)
            datums = [by_name.get(c.name, Datum.NULL) for c in meta.columns]
            pid = meta.pid_for_row(datums)
            key = tablecodec.encode_row_key(pid, ev.handle)
            if store.kv.latest_ts(key) < ev.commit_ts:  # redelivery dedupe
                store.put_row(pid, ev.handle, meta.col_ids(), datums, ev.commit_ts)

    def flush(self, resolved_ts: int) -> None:
        self.session.store.advance_tso(resolved_ts)

    def describe(self) -> str:
        return "session-replay://"
