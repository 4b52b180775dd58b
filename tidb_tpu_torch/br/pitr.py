"""Point-in-time recovery (ref: br/pkg/stream — log backup as
a persistent change stream — and br/pkg/restore's PiTR path: full
snapshot + log replay to an exact ts).

Log backup
----------
`BACKUP LOG TO 'file://dir'` attaches a RAW changefeed (no mounting —
the sink receives undecoded RawKVEvents, index entries and schema
entries included) whose `LogBackupSink` commits each flush as ONE atomic
segment (cdc/sink.py's SegmentWriter: write-temp + fsync + rename) under
`<dir>/log/`, ending in a resolved mark. `manifest.json` (also written
atomically) chains the segments: each entry carries `base_ts` (the
previous resolved point) and `resolved_ts`, so ANY prefix of verified
segments is a transactionally consistent cut and a missing link is
DETECTABLE, never a silently-short restore. The feed's emitted
checkpoint doubles as a sliding GC service safepoint (the changefeed hub
registers it), so MVCC GC can never collect a version the backup still
has to stream.

Replay-to-ts restore
--------------------
`RESTORE FROM 'file://dir' UNTIL TS = <ts>` picks the newest full backup
at or below <ts> (`<dir>` itself or `<dir>/full/*/`), restores it, then
replays the log segments IN ORDER at their SOURCE commit timestamps —
raw bytes back into the target's KV through `bulk_ingest`, schema
entries as catalog DDL. Every discontinuity is a typed `LogGapError`:
no full backup under <ts>, a segment whose `base_ts` overshoots the
covered point, a missing/corrupt segment file, or a log that ends before
<ts>. A per-segment checkpoint file makes a mid-replay crash
(`restore/replay-crash`) resumable: the re-run skips already-applied
segments (idempotent — replay at fixed source ts makes re-application a
no-op anyway, the checkpoint just makes the resume observable and
cheap). `br/log-gap` drops one manifest link to drill the gap detector.

Copy of `tidb_tpu/br/pitr.py` for the PyTorch port (it imports nothing of
tidb_tpu). Segments and manifests are byte-compatible with the JAX
package's. A replay writes raw bytes at their source commit ts; the final
write-version bump drops the store's decoded-region, device-batch and
result caches, so the first read after a restore decodes the replayed
rows afresh.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

from ..cdc.schema import decode_payload, is_schema_key
from ..cdc.sink import SegmentWriter, Sink


class LogGapError(RuntimeError):
    """The log cannot prove continuous coverage up to the requested ts —
    a restore MUST fail typed rather than return a silently-short
    cluster (ref: BR's PiTR erroring on a checkpoint gap)."""

    def __init__(self, msg: str, covered_ts: int = 0, target_ts: int = 0):
        super().__init__(msg)
        self.covered_ts = covered_ts
        self.target_ts = target_ts


class ReplayInterrupted(RuntimeError):
    """The replay loop died mid-restore (the `restore/replay-crash`
    drill): the per-segment checkpoint survives, and a re-run of the
    same `restore_until` resumes past every already-applied segment."""


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class LogBackupSink(Sink):
    """The log backup's sink: buffers raw KV records, commits each flush
    as one atomic segment + an atomic manifest rewrite. Records at or
    below the manifest checkpoint are dropped on arrival — a redelivered
    batch (sink failure, re-attach) can never duplicate an event in the
    durable log (the manifest IS the dedupe floor)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.writer = SegmentWriter(directory)
        self._mu = threading.Lock()
        self._buf: list = []  # [(ts, record dict)]; guarded_by: _mu
        self._manifest_path = os.path.join(directory, "manifest.json")
        self.manifest = self._load_manifest()  # guarded_by: _mu

    def _load_manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            try:
                m = json.load(open(self._manifest_path, encoding="utf-8"))
                m.setdefault("start_ts", 0)
                m.setdefault("checkpoint_ts", 0)
                m.setdefault("segments", [])
                return m
            except (ValueError, KeyError):
                pass  # unreadable manifest: start a fresh chain
        return {"start_ts": 0, "checkpoint_ts": 0, "segments": []}

    @property
    def checkpoint_ts(self) -> int:
        with self._mu:
            return self.manifest["checkpoint_ts"]

    def segment_count(self) -> int:
        with self._mu:
            return len(self.manifest["segments"])

    def event_count(self) -> int:
        with self._mu:
            return sum(s["events"] for s in self.manifest["segments"])

    def write(self, events: list) -> None:
        with self._mu:
            floor = self.manifest["checkpoint_ts"]
            for ev in events:
                if ev.commit_ts <= floor:
                    continue  # redelivery below the durable checkpoint
                self._buf.append((ev.commit_ts, {
                    "t": "kv",
                    "k": ev.key.hex(),
                    "v": None if ev.value is None else ev.value.decode("latin1"),
                    "ts": ev.commit_ts,
                }))

    def flush(self, resolved_ts: int) -> None:
        """Commit the buffered window: one atomic segment ending in a
        resolved mark, then the manifest rewrite that links it into the
        chain. The manifest only advances AFTER the segment is durable —
        a crash between the two re-sends the window (the write()-side
        dedupe floor is the OLD checkpoint, so re-buffered events land
        in the next segment exactly once). An empty window advances the
        manifest checkpoint alone — the implicit trailing resolved mark
        a quiet log still extends."""
        from ..util import metrics

        with self._mu:
            if resolved_ts <= self.manifest["checkpoint_ts"]:
                return
            # a failed write_segment DROPS the window (the buffer stays
            # swapped out): the feed re-queues the batch below its held
            # checkpoint and REDELIVERS it through write() — the dedupe
            # floor is still the old checkpoint, so exactly one durable
            # copy ever lands (same contract as FileSink)
            take, self._buf = self._buf, []
            # the chain links segment to segment, NOT to the checkpoint:
            # an empty flush advances the checkpoint without a segment,
            # which PROVES no events landed in between — so the next
            # segment still covers continuously from the last segment's
            # resolved point (the dedupe floor above stays the
            # checkpoint; only the recorded chain base differs)
            segs = self.manifest["segments"]
            base_ts = segs[-1]["resolved_ts"] if segs else 0
            if take:
                take.sort(key=lambda p: p[0])
                lines = [json.dumps(rec) for _ts, rec in take]
                lines.append(json.dumps({"t": "resolved", "ts": resolved_ts}))
                body = "".join(line + "\n" for line in lines).encode()
                fname = self.writer.write_segment(lines)
                self.manifest["segments"].append({
                    "file": fname,
                    "sha256": hashlib.sha256(body).hexdigest(),
                    "base_ts": base_ts,
                    "resolved_ts": resolved_ts,
                    "min_ts": take[0][0],
                    "max_ts": take[-1][0],
                    "events": len(take),
                })
                metrics.LOG_BACKUP_SEGMENTS.inc()
                metrics.LOG_BACKUP_EVENTS.inc(len(take))
            self.manifest["checkpoint_ts"] = resolved_ts
            _atomic_json(self._manifest_path, self.manifest)

    def describe(self) -> str:
        return f"log-backup://{self.directory}"


class LogBackup:
    """One attached log backup: the destination, its raw changefeed and
    its sink (registered in `store.log_backups`, surfaced by SHOW BACKUP
    LOGS and refreshed by the pd.pitr tick)."""

    def __init__(self, uri: str, directory: str, feed_name: str,
                 sink: LogBackupSink, start_ts: int):
        self.uri = uri
        self.directory = directory
        self.feed_name = feed_name
        self.sink = sink
        self.start_ts = start_ts


def _log_dir(uri: str) -> str:
    """`file://<dir>` or a bare path (the plain BACKUP/RESTORE SQL takes
    bare paths; the uri form matches the changefeed sink scheme)."""
    scheme, sep, rest = uri.partition("://")
    if not sep:
        return uri
    if scheme.lower() != "file" or not rest:
        raise ValueError(f"log backup destination must be file://<dir>, got {uri!r}")
    return rest


def start_log_backup(store, catalog, uri: str) -> LogBackup:
    """Attach a durable log backup at `uri` (idempotent re-attach: an
    existing `<dir>/log/manifest.json` resumes the chain from its
    checkpoint — the raw feed's initial incremental scan backfills
    (checkpoint, now] and the sink's dedupe floor drops the overlap)."""
    root = _log_dir(uri)
    if uri in store.log_backups:
        raise ValueError(f"log backup to {uri!r} already running")
    sink = LogBackupSink(os.path.join(root, "log"))
    start_ts = sink.checkpoint_ts
    name = f"log-backup:{hashlib.sha256(root.encode()).hexdigest()[:8]}"
    store.cdc.create(name, sink, catalog, table_ids=None,
                     start_ts=start_ts, raw=True)
    lb = LogBackup(uri, root, name, sink, start_ts)
    store.log_backups[uri] = lb
    return lb


def stop_log_backup(store, uri: str) -> None:
    lb = store.log_backups.pop(uri, None)
    if lb is None:
        raise ValueError(f"no log backup to {uri!r}")
    store.cdc.drop(lb.feed_name)


def log_backup_views(store) -> list:
    """One row per attached log backup (SHOW BACKUP LOGS)."""
    from ..cdc import ChangefeedError

    out = []
    for uri, lb in sorted(store.log_backups.items()):
        try:
            state = store.cdc.get(lb.feed_name).view(store)["state"]
        except ChangefeedError:
            state = "removed"
        ckpt = lb.sink.checkpoint_ts
        out.append({
            "destination": uri,
            "changefeed": lb.feed_name,
            "state": state,
            "start_ts": lb.sink.manifest.get("start_ts", 0),
            "checkpoint_ts": ckpt,
            "resolved_lag": max(store.kv.max_committed() - ckpt, 0),
            "segments": lb.sink.segment_count(),
            "events": lb.sink.event_count(),
        })
    return out


def pitr_tick(store) -> None:
    """The `pd.pitr` phase body: refresh the log-backup freshness gauges
    and trim the schema journal below the floor every live feed has
    passed (a feed only ever injects (checkpoint, cand], and feeds born
    later snapshot the live catalog, so nothing can still need the
    trimmed window)."""
    from ..util import metrics

    backups = getattr(store, "log_backups", None)
    hub = getattr(store, "cdc", None)
    if backups is None or hub is None:
        return  # a bare store without the CDC/PITR surfaces
    top = store.kv.max_committed()
    for lb in list(backups.values()):
        ckpt = lb.sink.checkpoint_ts
        metrics.LOG_BACKUP_CHECKPOINT_TS.labels(lb.feed_name).set(ckpt)
        metrics.LOG_BACKUP_LAG.labels(lb.feed_name).set(max(top - ckpt, 0))
    feeds = hub.feeds()
    if feeds:
        floor = min(f.view(store)["checkpoint_ts"] for f in feeds)
        store.schema_journal.trim(floor)


# --------------------------------------------------------------- restore

def _full_backup_candidates(root: str) -> list:
    """(snapshot_ts, dir) of every full backup under the PITR root:
    `<root>` itself and `<root>/full/<anything>/`."""
    dirs = [root]
    full = os.path.join(root, "full")
    if os.path.isdir(full):
        dirs += [os.path.join(full, d) for d in sorted(os.listdir(full))]
    out = []
    for d in dirs:
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            continue
        try:
            m = json.load(open(mpath, encoding="utf-8"))
            out.append((int(m["snapshot_ts"]), d))
        except (ValueError, KeyError):
            continue  # not a full-backup manifest (e.g. the log's own)
    return out


def _apply_schema_record(catalog, payload: dict) -> bool:
    """One replayed schema entry onto the target catalog (idempotent by
    schema version; the table is matched by its IMMUTABLE id — the full
    restore recreated it with original ids)."""
    from ..cdc.schema import _datum_from_dict, _ft_from_dict
    from ..sql.catalog import ColumnMeta

    meta = None
    for name in catalog.tables():
        m = catalog.table(name)
        if m.table_id == payload["table_id"]:
            meta = m
            break
    if meta is None or meta.schema_version >= payload["schema_version"]:
        return False
    meta.columns = [
        ColumnMeta(c["name"], c["col_id"], _ft_from_dict(c["ft"]),
                   origin_default=_datum_from_dict(c.get("origin_default")))
        for c in payload["columns"]
    ]
    if payload.get("handle_col"):
        meta.handle_col = payload["handle_col"]
    meta.next_col_id = max(meta.next_col_id, payload.get("next_col_id", 0))
    meta.schema_version = payload["schema_version"]
    catalog.version += 1
    return True


def _ckpt_path(root: str, until_ts: int) -> str:
    return os.path.join(root, f"restore-ckpt-{until_ts}.json")


def restore_until(store, catalog, uri: str, until_ts: int) -> dict:
    """PITR restore: newest full backup at or below `until_ts`, then log
    replay to exactly `until_ts` at source commit timestamps. Resumable
    and idempotent after a mid-replay crash (per-segment checkpoint);
    every coverage break is a typed LogGapError."""
    from ..util import failpoint, metrics
    from ..tools import br as full_br

    root = _log_dir(uri)
    log_dir = os.path.join(root, "log")
    manifest_path = os.path.join(log_dir, "manifest.json")

    candidates = [(ts, d) for ts, d in _full_backup_candidates(root)
                  if ts <= until_ts]
    if not candidates:
        metrics.PITR_LOG_GAPS.inc()
        raise LogGapError(
            f"no full backup at or below ts {until_ts} under {root!r}",
            covered_ts=0, target_ts=until_ts)
    full_ts, full_dir = max(candidates)

    ckpt_path = _ckpt_path(root, until_ts)
    ckpt = {"full_done": False, "replayed": [], "covered_ts": full_ts}
    resumed = False
    if os.path.exists(ckpt_path):
        try:
            ckpt = json.load(open(ckpt_path, encoding="utf-8"))
            resumed = True
            metrics.PITR_REPLAY_RESUMES.inc()
        except (ValueError, KeyError):
            pass  # torn checkpoint: restart from the full backup

    if not ckpt.get("full_done"):
        full_br.restore(store, catalog, full_dir)
        ckpt["full_done"] = True
        _atomic_json(ckpt_path, ckpt)

    segments = []
    log_checkpoint = full_ts
    if os.path.exists(manifest_path):
        log_manifest = json.load(open(manifest_path, encoding="utf-8"))
        segments = list(log_manifest.get("segments", []))
        log_checkpoint = max(log_checkpoint, log_manifest.get("checkpoint_ts", 0))
    if failpoint.eval("br/log-gap") and len(segments) > 1:
        # chaos drill: drop one mid-chain link — the base_ts/covered
        # check below must refuse, typed, never restore short
        segments.pop(len(segments) // 2)

    covered = ckpt.get("covered_ts", full_ts)
    replayed = set(ckpt.get("replayed", []))
    events_applied = 0
    segments_replayed = 0
    for seg in segments:
        if seg["resolved_ts"] <= covered and seg["file"] in replayed:
            continue
        if seg["resolved_ts"] <= full_ts:
            # wholly below the full snapshot: the snapshot already holds
            # every effect; the chain stays continuous through it
            covered = max(covered, seg["resolved_ts"])
            continue
        if covered >= until_ts:
            break  # target reached: later segments are beyond the cut
        if seg["base_ts"] > covered:
            metrics.PITR_LOG_GAPS.inc()
            raise LogGapError(
                f"log gap: segment {seg['file']} starts at base_ts "
                f"{seg['base_ts']} but coverage ends at {covered}",
                covered_ts=covered, target_ts=until_ts)
        fpath = os.path.join(log_dir, seg["file"])
        if not os.path.exists(fpath):
            metrics.PITR_LOG_GAPS.inc()
            raise LogGapError(
                f"log gap: segment {seg['file']} missing from {log_dir!r}",
                covered_ts=covered, target_ts=until_ts)
        body = open(fpath, "rb").read()
        if hashlib.sha256(body).hexdigest() != seg["sha256"]:
            metrics.PITR_LOG_GAPS.inc()
            raise LogGapError(
                f"log gap: segment {seg['file']} fails its checksum",
                covered_ts=covered, target_ts=until_ts)
        if seg["file"] not in replayed:
            by_ts: dict = {}
            for line in body.decode("utf-8").splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("t") != "kv":
                    continue  # resolved mark
                ts = rec["ts"]
                if ts <= full_ts or ts > until_ts:
                    continue  # below the snapshot / beyond the cut
                by_ts.setdefault(ts, []).append(rec)
            for ts in sorted(by_ts):
                batch = []
                for rec in by_ts[ts]:
                    key = bytes.fromhex(rec["k"])
                    val = None if rec["v"] is None else rec["v"].encode("latin1")
                    if is_schema_key(key):
                        if val is not None and _apply_schema_record(
                                catalog, decode_payload(val)):
                            events_applied += 1
                        continue
                    batch.append((key, val))
                if batch:
                    # replay at the SOURCE commit ts: versions land
                    # byte-identical and in the original order, so a
                    # re-run after a crash re-puts the same (key, ts)
                    # versions — idempotent by construction
                    store.txn.bulk_ingest(batch, ts)
                    events_applied += len(batch)
            replayed.add(seg["file"])
            segments_replayed += 1
            metrics.PITR_SEGMENTS_REPLAYED.inc()
        covered = max(covered, min(seg["resolved_ts"], until_ts))
        ckpt["covered_ts"] = covered
        ckpt["replayed"] = sorted(replayed)
        _atomic_json(ckpt_path, ckpt)
        if failpoint.eval("restore/replay-crash"):
            raise ReplayInterrupted(
                "restore/replay-crash: killed mid-replay after "
                f"{seg['file']} (re-run resumes from the checkpoint)")
    # the manifest checkpoint is the implicit trailing resolved mark: a
    # quiet log still proves coverage up to it
    if covered < until_ts and log_checkpoint >= until_ts:
        covered = until_ts
    if covered < until_ts:
        metrics.PITR_LOG_GAPS.inc()
        raise LogGapError(
            f"log ends at ts {covered}, cannot restore to {until_ts}",
            covered_ts=covered, target_ts=until_ts)
    store.advance_tso(until_ts)
    store._bump_write_ver()
    metrics.PITR_RESTORES.inc()
    if events_applied:
        metrics.PITR_REPLAYED_EVENTS.inc(events_applied)
    try:
        os.unlink(ckpt_path)  # done: a fresh run must start clean
    except OSError:
        pass
    return {
        "full_backup_ts": full_ts,
        "until_ts": until_ts,
        "segments_replayed": segments_replayed,
        "events_applied": events_applied,
        "resumed": resumed,
    }
