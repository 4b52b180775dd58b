"""Changefeed hub: the TiCDC-analog CDC pipeline over the replication
log (ref: TiDB VLDB'20's log-based HTAP replication + TiCDC's
puller -> sorter -> mounter -> sink pipeline; DBLog-style incremental
scans interleaved with the live log).

One `ChangefeedHub` per TPUStore. Each `Changefeed` is the full
pipeline for one subscription:

  puller     `ReplicaManager.propose` hands every committed write batch
             (the raft-lite log entry) to `capture()`; a changefeed
             additionally owns INCREMENTAL SCANS (`MemKV.scan_versions`)
             that backfill (checkpoint, candidate] for ranges whose live
             subscription was lost — the initial scan at `start_ts` is
             just the whole keyspace being "lost" at birth, and the
             `cdc/puller-drop` failpoint re-creates the mid-stream form.
             Dedupe is by (key, commit_ts): a live capture and a
             recovery scan of the same write collapse to one event.
  sorter     the pending map drains in (commit_ts, key) order, only up
             to the resolved frontier — downstream never sees a commit
             before everything below it.
  frontier   min over subscribed regions' watermarks. Watermarks advance
             to a TSO candidate proven SAFE by a quiescent sample of the
             store's WriteGuard: every write path brackets
             [commit-ts draw .. capture delivery] in `writing()`, so a
             candidate drawn with no write in flight (and none completing
             between two samples) dominates every delivered and every
             future commit ts. `cdc/resolved-stuck` pins the advance.
  mounter    cdc/mounter.py decodes rows against the feed's TRACKED
             schema snapshots; schema-change entries in the log
             (cdc/schema.py) advance the tracker in commit-ts
             order and emit SchemaEvents downstream — a mid-feed ALTER
             replicates through the feed instead of parking it. A RAW
             feed (the BR log backup) skips mounting entirely and hands
             the sink undecoded RawKVEvents, index entries included.
  sink       cdc/sink.py; `cdc/sink-stall` skips a tick's emission
             (the frontier may advance internally, the emitted
             checkpoint — and the sink — stay put).

Schema entries are not in KV, so the incremental-scan recovery path
cannot backfill them: every tick additionally injects the store's
SchemaJournal window (checkpoint, candidate] into the sorter — the
(key, ts) dedupe absorbs the overlap with live captures.

The emitted checkpoint doubles as the feed's GC service safepoint
(ref: TiCDC's service GC safepoint in PD): the hub keeps a registered
snapshot at the checkpoint so MVCC GC can never collect a version the
feed still has to scan.

Lock order: hub._tick_mu -> feed._mu -> (metrics/kv leaf locks). The
capture path takes feed._mu with no other subsystem lock held
(`propose` notifies after releasing ReplicaManager._mu; commit's
on_apply runs outside the kv critical section). Cluster topology hooks
(`on_split`/`on_merge`) arrive under Cluster._mu, so feed.tick
snapshots the region list BEFORE taking feed._mu — never the reverse.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from ..store.region import KEY_MAX
from .events import RawKVEvent
from .mounter import Mounter, SchemaDriftError
from .schema import is_schema_key, schema_key_table_id
from .sink import Sink, SinkError, open_sink


class ChangefeedError(ValueError):
    """Lifecycle misuse (duplicate name, unknown feed, bad state) — the
    session boundary maps it onto a plain SQLError."""


class WriteGuard:
    """In-flight write tracker — the resolved-ts sampler's proof
    obligation. Writers bracket [commit-ts draw .. capture delivery] in
    `writing()`; `sample()` returns (inflight, completion seq). A TSO
    candidate drawn between two identical quiescent samples is a sound
    resolved-ts bound: no write was in flight across the draw, and any
    later write draws a larger commit ts from the monotone TSO."""

    def __init__(self):
        self._mu = threading.Lock()
        self._inflight = 0  # guarded_by: _mu
        self._seq = 0  # completed windows; guarded_by: _mu

    @contextmanager
    def writing(self):
        with self._mu:
            self._inflight += 1
        try:
            yield
        finally:
            with self._mu:
                self._inflight -= 1
                self._seq += 1

    def sample(self) -> tuple:
        with self._mu:
            return self._inflight, self._seq


class Changefeed:
    """One subscription's pipeline state. States: normal -> paused
    (PAUSE CHANGEFEED; capture stops, resume re-scans from the
    checkpoint) -> normal, or -> error (a sink/mount failure parks the
    feed with the message; RESUME retries), or removed (DROP)."""

    def __init__(self, hub, name: str, sink: Sink, catalog,
                 table_ids=None, start_ts: int = 0, raw: bool = False):
        self.hub = hub
        self.name = name
        self.sink = sink
        self.catalog = catalog
        self.mounter = Mounter(catalog)
        self.table_ids = frozenset(table_ids) if table_ids is not None else None
        # raw feeds (the BR log backup) skip the mounter: the sink gets
        # undecoded RawKVEvents (index entries included) so PITR replay
        # re-ingests the exact bytes at the source commit ts
        self.raw = raw
        # birth schema snapshot: every subscribed table's
        # row SHAPE is snapshotted NOW; a mid-feed ALTER advances it via
        # a replicated schema entry instead of parking the feed
        self.mounter.stamp_tables(self.table_ids)
        self.start_ts = start_ts
        self._mu = threading.Lock()
        self.state = "normal"  # guarded_by: _mu
        self.last_error = ""  # guarded_by: _mu
        self.checkpoint = start_ts  # emitted resolved frontier; guarded_by: _mu
        self._pending: dict = {}  # (key, commit_ts) -> value|None; guarded_by: _mu
        self._watermark: dict = {}  # region_id -> resolved watermark; guarded_by: _mu
        # key ranges whose live subscription lapsed (birth, puller-drop,
        # resume): recovered by incremental scan at the next tick
        self._lost: list = list(self._full_spans())  # guarded_by: _mu
        self.emitted = 0  # rows handed to the sink; guarded_by: _mu
        self.skipped = 0  # entries the mounter skipped; guarded_by: _mu

    def _full_spans(self) -> list:
        """The feed's whole subscription as key ranges: per-table
        prefixes for a filtered feed (a recovery scan must not
        materialize every OTHER table's versions under kv.lock just to
        discard them in Python), the whole keyspace otherwise."""
        from ..codec import tablecodec

        if self.table_ids is None:
            return [(b"", KEY_MAX)]
        return [(tablecodec.table_prefix(tid),
                 tablecodec.table_prefix(tid) + b"\xff")
                for tid in sorted(self.table_ids)]

    # ------------------------------------------------------------- puller
    def _wants(self, key: bytes) -> bool:
        """Table filter: record/index keys of subscribed tables, plus
        schema-change entries of subscribed tables (None = every table;
        the rest of the m-prefix meta keyspace never streams)."""
        from ..codec import tablecodec

        if is_schema_key(key):
            if self.table_ids is None:
                return True
            try:
                return schema_key_table_id(key) in self.table_ids
            except ValueError:
                return False
        if key[:1] != b"t" or len(key) < 9:
            return False
        if self.table_ids is None:
            return True
        try:
            return tablecodec.decode_key_table_id(key) in self.table_ids
        except Exception:  # noqa: BLE001 — malformed key: not table data
            return False

    def capture(self, region_id: int, ts: int, entries: list) -> None:
        """Live log entry from a replication proposal. `cdc/puller-drop`
        simulates a lost region subscription: the span is remembered and
        re-scanned from the checkpoint at the next tick, so nothing is
        lost — only late (exactly the reference's re-subscribe +
        incremental scan recovery)."""
        from ..util import failpoint, metrics

        kept = [(k, v) for k, v in entries if self._wants(k)]
        if not kept:
            return
        if failpoint.eval("cdc/puller-drop"):
            lo = min(k for k, _ in kept)
            hi = max(k for k, _ in kept) + b"\x00"
            with self._mu:
                if self.state == "normal":
                    self._lost.append((lo, hi))
            return
        fresh = 0
        with self._mu:
            if self.state != "normal":
                return  # paused/errored: resume recovers from checkpoint
            for k, v in kept:
                if (k, ts) not in self._pending:
                    self._pending[(k, ts)] = v
                    fresh += 1
        if fresh:
            metrics.CDC_EVENTS.inc(fresh)

    # --------------------------------------------- topology hand-offs
    # (called under Cluster._mu, exactly like flow/replica hooks: the
    # feed lock nests inside the cluster lock, never the reverse)
    def on_split(self, parent_id: int, child_id: int) -> None:
        with self._mu:
            self._watermark[child_id] = self._watermark.get(parent_id, self.checkpoint)

    def on_merge(self, left_id: int, right_id: int) -> None:
        with self._mu:
            right = self._watermark.pop(right_id, None)
            if right is not None:
                left = self._watermark.get(left_id, self.checkpoint)
                self._watermark[left_id] = min(left, right)

    # ----------------------------------------------------------- frontier
    def tick(self, store, region_ids: list, cand: int) -> int:
        """One pipeline turn under the hub's tick lock: recover lost
        spans, advance watermarks to `cand`, drain the sorter up to the
        frontier, mount and flush. Returns rows emitted."""
        from ..util import failpoint, metrics, tracing

        with self._mu:
            state = self.state
            checkpoint = self.checkpoint
        lag = max(store.kv.max_committed() - checkpoint, 0)
        metrics.CDC_RESOLVED_LAG.labels(self.name).set(lag)
        if state != "normal":
            return 0
        self._recover_lost(store, checkpoint, cand)
        self._inject_schema(store, checkpoint, cand)
        stuck = bool(failpoint.eval("cdc/resolved-stuck"))
        with self._mu:
            live = set(region_ids)
            for rid in region_ids:
                cur = self._watermark.get(rid, checkpoint)
                self._watermark[rid] = cur if stuck else max(cur, cand)
            for rid in [r for r in self._watermark if r not in live]:
                # a region that vanished between the topology snapshot and
                # now (merge) was folded by on_merge; anything left is a
                # stale entry that would pin the frontier forever
                del self._watermark[rid]
            frontier = min(self._watermark.values(), default=cand)
            frontier = max(frontier, checkpoint)
        if failpoint.eval("cdc/sink-stall"):
            return 0  # the sorter keeps the backlog; checkpoint holds
        with self._mu:
            batch = sorted(
                (ts, k, v) for (k, ts), v in self._pending.items() if ts <= frontier
            )
            for ts, k, _v in batch:
                del self._pending[(k, ts)]
        rows, skipped = [], 0
        try:
            for ts, k, v in batch:
                if self.raw:
                    # the log-backup feed: no mounting, exact bytes out
                    rows.append(RawKVEvent(k, v, ts))
                    continue
                if is_schema_key(k):
                    # a replicated DDL draining in commit-ts order:
                    # advance the tracked snapshot so later rows in THIS
                    # batch already decode against the new shape
                    ev = self.mounter.apply_schema(v, ts)
                    if ev is None:
                        skipped += 1  # stale/duplicate schema entry
                    else:
                        rows.append(ev)
                        metrics.CDC_SCHEMA_EVENTS.inc()
                    continue
                ev = self.mounter.mount(k, v, ts)
                if ev is None:
                    skipped += 1
                else:
                    rows.append(ev)
        except SchemaDriftError as exc:
            # the legacy park path: the mounter now
            # resolves drift as a counted fallback and should never
            # raise, but a feed that still does parks safely with the
            # typed reason and re-queues the batch below the held
            # checkpoint — nothing is lost, sinks dedupe on redelivery
            with self._mu:
                self.state = "error"
                self.last_error = f"{type(exc).__name__}: {exc}"
                for ts, k, v in batch:
                    self._pending[(k, ts)] = v
            return 0
        t0 = time.monotonic()
        try:
            with tracing.span("cdc.flush", changefeed=self.name,
                              events=len(rows), resolved_ts=frontier):
                if rows:
                    self.sink.write(rows)
                self.sink.flush(frontier)
        except Exception as exc:  # noqa: BLE001 — a sink failure parks the
            # feed in `error` (ref: TiCDC changefeed error state); the
            # batch is NOT lost: it re-queues below the held checkpoint.
            # A partially-written batch therefore redelivers on RESUME —
            # AT-LEAST-ONCE across sink failures, the reference's
            # contract; sinks dedupe by (key, commit_ts)
            with self._mu:
                self.state = "error"
                self.last_error = f"{type(exc).__name__}: {exc}"
                for ts, k, v in batch:
                    self._pending[(k, ts)] = v
            return 0
        metrics.CDC_SINK_FLUSH.observe(time.monotonic() - t0)
        if rows:
            metrics.CDC_EVENTS_EMITTED.inc(len(rows))
        if skipped:
            metrics.CDC_EVENTS_SKIPPED.inc(skipped)
        self._advance_checkpoint(store, frontier, len(rows), skipped)
        return len(rows)

    def _recover_lost(self, store, checkpoint: int, cand: int) -> None:
        """Incremental scans for spans whose live subscription lapsed:
        every version in (checkpoint, cand] re-enters the sorter (dedupe
        by (key, commit_ts) absorbs the overlap with live captures)."""
        from ..util import metrics

        with self._mu:
            lost, self._lost = self._lost, []
        fresh = 0
        for lo, hi in lost:
            metrics.CDC_RECOVERY_SCANS.inc()
            versions = store.kv.scan_versions(lo, hi, checkpoint, cand)
            with self._mu:
                for k, ts, v in versions:
                    if self._wants(k) and (k, ts) not in self._pending:
                        self._pending[(k, ts)] = v
                        fresh += 1
        if fresh:
            metrics.CDC_EVENTS.inc(fresh)

    def _inject_schema(self, store, checkpoint: int, cand: int) -> None:
        """Schema entries in (checkpoint, cand] from the store journal:
        the live capture path delivers them too, but a feed whose
        subscription lapsed (pause, puller-drop, birth) cannot recover
        them by KV scan — the journal is the durable source. Dedupe by
        (key, commit_ts) absorbs the overlap."""
        journal = getattr(store, "schema_journal", None)
        if journal is None or not len(journal):
            return
        with self._mu:
            for k, ts, v in journal.entries_in(checkpoint, cand):
                if self._wants(k) and (k, ts) not in self._pending:
                    self._pending[(k, ts)] = v

    def _advance_checkpoint(self, store, frontier: int, emitted: int,
                            skipped: int) -> None:
        with self._mu:
            old = self.checkpoint
            self.checkpoint = max(self.checkpoint, frontier)
            new = self.checkpoint
            self.emitted += emitted
            self.skipped += skipped
            # the dedupe window below the checkpoint is closed: recovery
            # scans start above it, so those (key, ts) pairs cannot recur
            for key_ts in [kt for kt in self._pending if kt[1] <= new]:
                del self._pending[key_ts]
        if new != old:
            # slide the GC service safepoint (register-then-unregister:
            # the pin must never be absent in between)
            store.register_snapshot(new)
            store.unregister_snapshot(old)

    # ----------------------------------------------------------- lifecycle
    def pause(self) -> None:
        with self._mu:
            if self.state == "normal":
                self.state = "paused"

    def resume(self) -> None:
        """Back to normal with the whole keyspace marked lost: the next
        tick's incremental scan replays (checkpoint, now] — the pause
        window — before the frontier moves (ref: TiCDC resume doing an
        incremental catch-up from the checkpoint)."""
        drift_park = False
        with self._mu:
            if self.state in ("paused", "error"):
                drift_park = self.last_error.startswith("SchemaDriftError")
                self.state = "normal"
                self.last_error = ""
                self._lost.extend(self._full_spans())
        if drift_park:
            # RESUME doubles as the schema acknowledgment ONLY when the
            # park reason WAS the drift: the operator saw the typed
            # reason and accepted the new shape. A feed parked for an
            # unrelated reason (pause, a sink failure) keeps its birth
            # stamps — an ALTER that landed while it was parked must
            # still park it at the next mount, never mount the old-shape
            # backlog against the new catalog silently
            self.mounter.restamp()

    def view(self, store) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "state": self.state,
                "sink": self.sink.describe(),
                "start_ts": self.start_ts,
                "checkpoint_ts": self.checkpoint,
                "resolved_lag": max(store.kv.max_committed() - self.checkpoint, 0),
                "pending": len(self._pending),
                "emitted": self.emitted,
                "skipped": self.skipped,
                "error": self.last_error,
                "tables": sorted(self.table_ids) if self.table_ids is not None else "all",
            }


class ChangefeedHub:
    """All changefeeds of one store + the shared WriteGuard. `tick()` is
    the `pd.cdc` phase's body and the sink flush loop's driver."""

    def __init__(self, store):
        self.store = store
        self.guard = WriteGuard()
        self._mu = threading.Lock()
        self._feeds: dict = {}  # name -> Changefeed; guarded_by: _mu
        # lock-free capture fast path: an immutable tuple swapped under
        # _mu, read GIL-atomically by every write's delivery
        self._capturing: tuple = ()
        self._tick_mu = threading.Lock()  # serializes whole ticks (sink
        # emission order is the resolved contract; concurrent ticks could
        # interleave two batches)
        store.cluster.cdc = self

    # ------------------------------------------------------------ capture
    def on_proposal(self, region_id: int, ts: int, entries: list) -> None:
        """Replication-log subscription: every committed write batch
        lands here (called by ReplicaManager.propose AFTER it releases
        its own lock)."""
        for feed in self._capturing:
            feed.capture(region_id, ts, entries)

    def on_split(self, parent_id: int, child_id: int) -> None:
        for feed in self._capturing:
            feed.on_split(parent_id, child_id)

    def on_merge(self, left_id: int, right_id: int) -> None:
        for feed in self._capturing:
            feed.on_merge(left_id, right_id)

    # ---------------------------------------------------------- lifecycle
    def create(self, name: str, sink, catalog, table_ids=None,
               start_ts: int = 0, raw: bool = False):
        """`sink` is a Sink instance or a sink-uri string. The new feed's
        first tick runs the initial incremental scan at `start_ts`.
        `raw=True` makes a log-backup-style feed that skips the mounter
        (the sink receives RawKVEvents, index entries included)."""
        opened_here = isinstance(sink, str)
        if opened_here:
            sink = open_sink(sink, name)
        feed = Changefeed(self, name, sink, catalog, table_ids, start_ts, raw=raw)
        # GC service safepoint at the checkpoint BEFORE the feed becomes
        # tickable (TiCDC's PD service safepoint): _advance_checkpoint's
        # register-new/unregister-old slide assumes the old pin exists —
        # registering after publication raced an in-flight tick and left
        # a refcounted pin behind forever
        self.store.register_snapshot(feed.checkpoint)
        with self._mu:
            if name in self._feeds:
                self.store.unregister_snapshot(feed.checkpoint)
                if opened_here:  # a caller-owned sink stays the caller's
                    sink.close()
                raise ChangefeedError(f"changefeed {name!r} already exists")
            self._feeds[name] = feed
            self._capturing = tuple(self._feeds.values())
        return feed

    def get(self, name: str):
        with self._mu:
            feed = self._feeds.get(name)
        if feed is None:
            raise ChangefeedError(f"unknown changefeed {name!r}")
        return feed

    def pause(self, name: str) -> None:
        self.get(name).pause()

    def resume(self, name: str) -> None:
        self.get(name).resume()

    def drop(self, name: str) -> None:
        with self._mu:
            feed = self._feeds.pop(name, None)
            self._capturing = tuple(self._feeds.values())
        if feed is None:
            raise ChangefeedError(f"unknown changefeed {name!r}")
        # serialize against an in-flight tick (the PD timer thread):
        # its _advance_checkpoint slides the GC pin and its emission
        # writes the sink — both must finish (or see `removed` and never
        # start) before the pin is released and the sink closed, else
        # the pin double-releases at the old ts and re-registers at the
        # new one forever
        with self._tick_mu:
            with feed._mu:
                checkpoint = feed.checkpoint
                feed.state = "removed"
            self.store.unregister_snapshot(checkpoint)
            feed.sink.close()
        from ..util import metrics

        # a dropped feed must not haunt dashboards with its last lag
        metrics.CDC_RESOLVED_LAG.labels(name).set(0)

    def feeds(self) -> list:
        with self._mu:
            return list(self._feeds.values())

    def views(self) -> list:
        return [f.view(self.store) for f in self.feeds()]

    # ----------------------------------------------------------- frontier
    def _safe_candidate(self) -> int | None:
        """A TSO candidate proven to dominate every delivered commit:
        sampled between two identical quiescent WriteGuard states.
        Bounded attempts, no sleep — a write-saturated interval simply
        keeps the previous frontier until the next tick."""
        for _attempt in range(8):
            inflight, seq = self.guard.sample()
            if inflight:
                continue
            cand = self.store.next_ts()
            inflight2, seq2 = self.guard.sample()
            if inflight2 == 0 and seq2 == seq:
                return cand
        return None

    def tick(self) -> int:
        """One frontier round for every feed (the `pd.cdc` phase body
        and the sink flush loop). Returns total rows emitted."""
        if not self.feeds():
            return 0
        with self._tick_mu:
            feeds = self.feeds()  # re-snapshot under the tick lock so a
            # feed dropped while we waited is never ticked post-close
            cand = self._safe_candidate()
            if cand is None:
                return 0
            # topology snapshot BEFORE any feed lock (Cluster._mu ->
            # feed._mu is the hook path's order; never invert it)
            region_ids = [r.region_id for r in self.store.cluster.regions()]
            return sum(f.tick(self.store, region_ids, cand) for f in feeds)
