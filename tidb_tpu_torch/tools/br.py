"""Physical backup/restore — the BR analog (ref: br/pkg/backup snapshot
SST export, br/pkg/restore ingest, br/pkg/checkpoint resumable progress).

Backup walks the whole KV space at one snapshot ts and writes fixed-size
segments of length-prefixed (key, value) records, each with a SHA-256
recorded in `manifest.json` alongside the full schema (table ids, columns,
indices, autoid cursors) and the snapshot ts. A crashed backup resumes:
segments already on disk with matching checksums are skipped. Restore
recreates the schema with the ORIGINAL ids (keys embed them) and ingests
the segments at a fresh commit ts, verifying each checksum first.

Copy of `tidb_tpu/tools/br.py` for the PyTorch port (it imports nothing of
tidb_tpu). The manifest and the segments are byte-compatible with the JAX
package's: each package restores the other's backup. The restored rows
reach the device on their first read: the restore bumps the store's write
version, which drops every decoded-region, device-batch and result cache
entry."""

from __future__ import annotations

import hashlib
import json
import os
import struct

# the field-type / datum dict codecs are the ones the log-backup segments
# already persist (cdc/schema.py); _apply_schema_record imports them from here
from ..cdc.schema import _datum_from_dict, _datum_to_dict, _ft_from_dict, _ft_to_dict
from ..sql.catalog import ColumnMeta, IndexMeta, TableMeta

SEGMENT_KEYS = 4096


def _schema_dict(catalog) -> list:
    out = []
    for name in catalog.tables():
        if name.startswith("mysql."):
            continue  # system schema excluded, like BR's default filter
        m = catalog.table(name)
        out.append({
            "name": m.name,
            "table_id": m.table_id,
            "handle_col": m.handle_col,
            "row_count": m.row_count,
            "next_handle": m.peek_handle(),  # cursor survives the round trip
            "next_col_id": m.next_col_id,
            "columns": [
                {"name": c.name, "col_id": c.col_id, "ft": _ft_to_dict(c.ft),
                 "origin_default": _datum_to_dict(c.origin_default),
                 "auto_increment": c.auto_increment}
                for c in m.columns
            ],
            "indices": [
                {"name": i.name, "index_id": i.index_id, "col_names": i.col_names,
                 "unique": i.unique, "state": i.state}
                for i in m.indices
            ],
            "partition": None if m.partition is None else {
                "method": m.partition.method,
                "col": m.partition.col,
                "parts": [{"name": p.name, "pid": p.pid, "upper": p.upper}
                          for p in m.partition.parts],
            },
        })
    return out


def _views_dict(catalog) -> dict:
    return {
        v.name: {"columns": v.columns, "select": v.select_sql}
        for v in catalog.view_snapshot()
    }


def backup(store, catalog, dest_dir: str) -> dict:
    """Full backup; returns the manifest. Resumable: re-running skips
    segments whose files already verify."""
    os.makedirs(dest_dir, exist_ok=True)
    ts = store.next_ts()
    manifest_path = os.path.join(dest_dir, "manifest.json")
    prior = {}
    if os.path.exists(manifest_path):
        try:
            prior = {s["file"]: s["sha256"] for s in json.load(open(manifest_path)).get("segments", [])}
        except (ValueError, KeyError):
            prior = {}
    segments = []
    seg_idx = 0
    buf = bytearray()
    count = 0
    n_keys = 0

    def flush():
        nonlocal seg_idx, buf, count
        if not count:
            return
        fname = f"seg-{seg_idx:06d}.bak"
        digest = hashlib.sha256(bytes(buf)).hexdigest()
        fpath = os.path.join(dest_dir, fname)
        if prior.get(fname) == digest and os.path.exists(fpath):
            pass  # resume: identical segment already durable
        else:
            with open(fpath + ".tmp", "wb") as f:
                f.write(bytes(buf))
            os.replace(fpath + ".tmp", fpath)
        segments.append({"file": fname, "sha256": digest, "keys": count})
        seg_idx += 1
        buf = bytearray()
        count = 0

    # pin the snapshot while copying: a concurrent GC pass must not
    # collect versions the backup's read view still needs
    store.register_snapshot(ts)
    try:
        for key, val in store.kv.scan(b"", b"\xff" * 40, ts):
            # live values only: kv.scan filters tombstones, so the format
            # has no delete representation (a full backup needs none)
            buf += struct.pack("<I", len(key)) + key
            buf += struct.pack("<I", len(val)) + val
            count += 1
            n_keys += 1
            if count >= SEGMENT_KEYS:
                flush()
        flush()
    finally:
        store.unregister_snapshot(ts)
    manifest = {
        "snapshot_ts": ts,
        "total_keys": n_keys,
        "schema": _schema_dict(catalog),
        "views": _views_dict(catalog),
        "segments": segments,
    }
    with open(manifest_path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(manifest_path + ".tmp", manifest_path)
    return manifest


def restore(store, catalog, src_dir: str) -> dict:
    """Restore a backup into an (empty-enough) store/catalog. Table names
    already present in the catalog are an error — no silent merges."""
    manifest = json.load(open(os.path.join(src_dir, "manifest.json")))
    existing = set(catalog.tables())
    for t in manifest["schema"]:
        if t["name"] in existing:
            raise ValueError(f"restore: table {t['name']!r} already exists")
    # schema first (original ids — the KV bytes embed them)
    for t in manifest["schema"]:
        cols = [
            ColumnMeta(
                c["name"], c["col_id"], _ft_from_dict(c["ft"]),
                auto_increment=c.get("auto_increment", False),
                origin_default=_datum_from_dict(c.get("origin_default")),
            )
            for c in t["columns"]
        ]
        idxs = [IndexMeta(i["name"], i["index_id"], list(i["col_names"]), i["unique"],
                          i.get("state", "public")) for i in t["indices"]]
        meta = TableMeta(t["name"], t["table_id"], cols, idxs, t["handle_col"])
        pd = t.get("partition")
        if pd is not None:
            from ..sql.catalog import PartitionDef, PartitionInfo

            meta.partition = PartitionInfo(
                pd["method"], pd["col"],
                [PartitionDef(p["name"], p["pid"], p["upper"]) for p in pd["parts"]],
            )
        meta.row_count = t["row_count"]
        meta._next_handle = t["next_handle"]
        if t.get("next_col_id"):
            meta.next_col_id = t["next_col_id"]
        with catalog._lock:
            catalog._tables[t["name"]] = meta
            catalog.version += 1
    from ..sql.catalog import ViewMeta

    for vn in manifest.get("views", {}):
        if vn in existing or catalog.view_of(vn) is not None:
            raise ValueError(f"restore: view {vn!r} already exists")
    for vn, vd in manifest.get("views", {}).items():
        with catalog._lock:
            catalog.views[vn] = ViewMeta(vn, vd["columns"], vd["select"])
            catalog.version += 1
    max_id = 0
    for t in manifest["schema"]:
        ids = [t["table_id"]] + [i["index_id"] for i in t["indices"]]
        ids += [p["pid"] for p in (t.get("partition") or {}).get("parts", [])]
        max_id = max(max_id, *ids)
    catalog.ensure_id_above(max_id)
    n = 0
    # the restore ts is drawn INSIDE the CDC WriteGuard window so the
    # resolved-ts sampler counts the whole restore as an in-flight write:
    # a frontier candidate can never pass the restore ts before its
    # change events are delivered (the guard nests fine around
    # bulk_ingest's own writing() bracket — it is a plain counter)
    with store.cdc.guard.writing():
        ts = store.next_ts()
        # pin the ingest ts while copying (released on completion OR
        # failure): a GC pass racing a half-done restore must not collect
        # at or above the versions still being written
        store.register_snapshot(ts)
        try:
            for seg in manifest["segments"]:
                data = open(os.path.join(src_dir, seg["file"]), "rb").read()
                if hashlib.sha256(data).hexdigest() != seg["sha256"]:
                    raise ValueError(f"restore: checksum mismatch in {seg['file']}")
                pos = 0
                batch = []
                for _ in range(seg["keys"]):
                    (klen,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    key = data[pos : pos + klen]
                    pos += klen
                    (vlen,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    val = data[pos : pos + vlen]
                    pos += vlen
                    batch.append((bytes(key), bytes(val)))
                # restore must not overwrite keys locked by an in-flight
                # 2PC: lock-check + apply in one engine critical section
                store.txn.bulk_ingest(batch, ts)
                n += len(batch)
        finally:
            store.unregister_snapshot(ts)
    store._bump_write_ver()
    return {"tables": len(manifest["schema"]), "keys": n, "snapshot_ts": manifest["snapshot_ts"]}
