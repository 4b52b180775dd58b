"""The columnar apply sink — a sibling of `SessionReplaySink`
(cdc/sink.py) that applies mounted TYPED rows into the columnar replica's
delta layer instead of replaying them through a second cluster's write
path (ref: TiFlash learner apply: raft log entries decode once and land
in the DeltaTree's delta; TiDB VLDB'20 §3.2).

No rowcodec anywhere: the changefeed's mounter already produced typed
column datums, and the delta stores them as-is — the whole analytical
read path is codec-free by design.

The sink honors the standard contract (`write` receives rows in
(commit_ts, key) order at or below the NEXT `flush(resolved_ts)`), so
`flush` advancing the tables' applied frontier is exactly the
transactionally-complete-prefix promise the scan-readiness gate relies
on. Delivery is AT-LEAST-ONCE across sink failures (the feed re-queues on
error); the delta fold is idempotent by (commit_ts, handle)."""

from __future__ import annotations

from ..cdc.sink import Sink, SinkError


class ColumnarSink(Sink):
    def __init__(self, replica, catalog, meta):
        self.replica = replica
        self.catalog = catalog
        self.meta = meta
        self.pids = tuple(meta.physical_ids())

    @property
    def table_name(self) -> str:
        return self.meta.name  # follows RENAME TABLE (meta mutates in place)

    def write(self, events: list) -> None:
        from ..cdc.events import SchemaEvent
        from ..cdc.schema import snapshot_from_payload
        from ..sql.catalog import CatalogError
        from ..types import Datum
        from ..util import failpoint, metrics

        if failpoint.eval("columnar/apply-stall"):
            # the apply loop wedges: the feed parks in `error`, the
            # backlog re-queues below the held checkpoint, and RESUME
            # (ColumnarReplica.resume_all) replays it — at-least-once,
            # absorbed by the idempotent delta fold
            raise SinkError("columnar/apply-stall: replica apply loop stalled")
        applied = 0
        for ev in events:
            if isinstance(ev, SchemaEvent):
                # a mid-feed ALTER, ordered between the rows committed
                # before and after it: remap the replica's layers to the
                # new shape and KEEP consuming (the old
                # behavior parked the feed here with a rebuild message)
                snap = snapshot_from_payload(ev.payload)
                reshaped = False
                for pid in self.pids:
                    t = self.replica.table_for(pid)
                    if t is not None and t.reshape(snap.version, snap.columns):
                        reshaped = True
                if reshaped:
                    metrics.COLUMNAR_RESHAPES.inc()
                continue
            try:
                meta = self.catalog.table(ev.table)
            except CatalogError:
                continue  # table dropped under the feed: nothing to apply to
            if ev.op == "delete":
                # deletes carry no values, so the partition is unknown:
                # tombstone the handle in every physical table (absent
                # handles fold to nothing — over-deleting is sound).
                # ONE event counts once no matter how many pids the
                # tombstone fans to (counting each fan-out would
                # over-report an 8-partition table's deletes 8x)
                hit = False
                for pid in self.pids:
                    t = self.replica.table_for(pid)
                    if t is not None:
                        t.apply(ev.commit_ts, ev.handle, None)
                        hit = True
                if hit:
                    applied += 1
                continue
            by_name = dict(ev.columns)
            # live-meta name alignment is used ONLY to route the row to
            # its partition; the applied row maps by col_id below
            route = [by_name.get(c.name, Datum.NULL) for c in meta.columns]
            pid = meta.pid_for_row(route)
            t = self.replica.table_for(pid)
            if t is None:
                continue  # a partition added after enable: not replicated
            # remap by col_id against the TABLE's tracked shape (which a
            # schema event earlier in this same ordered stream may have
            # reshaped): a row mounted under the pre-ALTER snapshot still
            # lands in the right columns, missing ones fill from the
            # column's origin default. Only this feed thread reshapes, so
            # the unlocked col_ids/defaults reads cannot race.
            if ev.col_ids:
                by_id = dict(zip(ev.col_ids, (d for _n, d in ev.columns)))
                row = [by_id.get(cid, dflt if dflt is not None else Datum.NULL)
                       for cid, dflt in zip(t.col_ids, t.defaults)]
            else:  # a legacy event with no ids: trust live-name order
                row = route
            t.apply(ev.commit_ts, ev.handle, row)
            applied += 1
        if applied:
            metrics.COLUMNAR_APPLIED.inc(applied)

    def flush(self, resolved_ts: int) -> None:
        from ..util import metrics

        for pid in self.pids:
            t = self.replica.table_for(pid)
            if t is not None:
                t.set_applied(resolved_ts)
        top = self.replica.store.kv.max_committed()
        metrics.COLUMNAR_RESOLVED_LAG.labels(self.table_name).set(
            max(top - resolved_ts, 0))

    def describe(self) -> str:
        return f"columnar://{self.table_name}"
