"""Bulk import — the Lightning analog (ref: pkg/lightning local backend:
parse -> encode KV -> ingest, bypassing the SQL executor; checkpoints
pkg/lightning/checkpoints keep imports resumable).

`load_data` serves `LOAD DATA INFILE` (session routes LoadDataStmt here):
CSV-ish lines are parsed, coerced to column types, encoded with rowcodec,
and written in batches directly to the store (rows + index entries) — each
batch commits at its own TSO tick and advances a sidecar checkpoint file
(`<path>.ckpt`), so a crashed import resumes at the last durable batch.

Port of `tidb_tpu/tools/lightning.py` (imports rewritten; it imports nothing of
tidb_tpu).
"""

from __future__ import annotations

import os

from ..codec import tablecodec
from ..sql.planner import _coerce_datum
from ..types import Datum

BATCH = 1024


def _parse_line(line: str, sep: str, enclosed: str) -> list:
    """Split one data line (supports the enclosure char and \\N nulls)."""
    fields = []
    cur = []
    i, n = 0, len(line)
    in_enc = False
    while i < n:
        ch = line[i]
        if in_enc:
            if ch == enclosed:
                if i + 1 < n and line[i + 1] == enclosed:
                    cur.append(enclosed)
                    i += 1
                else:
                    in_enc = False
            else:
                cur.append(ch)
        elif enclosed and ch == enclosed and not cur:
            in_enc = True
        elif line.startswith(sep, i):
            fields.append("".join(cur))
            cur = []
            i += len(sep) - 1
        elif ch == "\\" and i + 1 < n:
            nxt = line[i + 1]
            if (nxt == "N" and not cur
                    and (i + 2 >= n or line.startswith(sep, i + 2))):
                # \N is NULL only when it constitutes the whole field
                cur.append("\x00NULL")
            else:
                cur.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
            i += 1
        else:
            cur.append(ch)
        i += 1
    fields.append("".join(cur))
    return fields


def load_data(session, stmt) -> int:
    """Execute a LoadDataStmt; returns imported row count (resumed rows
    excluded). Duplicate primary keys fail the batch loudly."""
    from ..sql.session import SQLError

    meta = session.catalog.table(stmt.table.name)
    path = stmt.path
    if not os.path.exists(path):
        raise SQLError(f"LOAD DATA: file not found: {path!r}")
    col_names = [c.lower() for c in stmt.columns] or [c.name for c in meta.columns]
    positions = []
    for cn in col_names:
        positions.append(meta.col(cn))
    ckpt_path = path + ".ckpt"
    done = 0
    if os.path.exists(ckpt_path):
        try:
            done = int(open(ckpt_path).read().strip() or 0)
        except ValueError:
            done = 0

    sep = stmt.fields_terminated or "\t"
    enc = stmt.fields_enclosed or ""
    imported = 0
    batch_rows: list = []

    pos = {c.name: i for i, c in enumerate(meta.columns)}
    uniq_idxs = [i for i in meta.indices if i.unique]

    def flush():
        nonlocal imported
        if not batch_rows:
            return
        # the WHOLE batch — timestamp draw, duplicate checks, lock check,
        # writes — runs in one engine critical section, so no concurrent
        # commit can land between the unique scan and the apply (a
        # read_ts drawn before the lock would let duplicates in)
        # the CDC WriteGuard brackets [ts draw .. record_applied_writes]
        # so a changefeed's resolved-ts sampler counts the batch as in
        # flight until its change events are delivered
        with session.store.cdc.guard.writing():
            with session.store.txn.ingest_guard():
                ts = session.store.next_ts()
                read_ts = session.store.next_ts()
                # ALL conflict checks before ANY write: a mid-batch duplicate
                # must not leave half a batch durable below the checkpoint
                # (re-running would then collide with the crashed run's rows)
                seen_pk: set = set()
                seen_uk: set = set()
                for handle, datums in batch_rows:
                    if handle in seen_pk:
                        raise SQLError(f"LOAD DATA: duplicate primary key {handle} within the file")
                    seen_pk.add(handle)
                    key = tablecodec.encode_row_key(meta.pid_for_row(datums), handle)
                    if session.store.kv.get(key, read_ts) is not None:
                        raise SQLError(f"LOAD DATA: duplicate primary key {handle}")
                    for idx in uniq_idxs:
                        vals = [datums[pos[cn]] for cn in idx.col_names]
                        if any(d.is_null() for d in vals):
                            continue
                        prefix = tablecodec.encode_index_key(meta.table_id, idx.index_id, vals)
                        if (idx.index_id, prefix) in seen_uk:
                            raise SQLError(f"LOAD DATA: duplicate entry for unique key {idx.name!r} within the file")
                        seen_uk.add((idx.index_id, prefix))
                        if next(iter(session.store.kv.scan(prefix, prefix + b"\xff", read_ts)), None) is not None:
                            raise SQLError(f"LOAD DATA: duplicate entry for unique key {idx.name!r}")
                items = []
                for handle, datums in batch_rows:
                    items.append((
                        # partition-aware key routing (partitioned tables store
                        # rows under their PartitionDef pid)
                        tablecodec.encode_row_key(meta.pid_for_row(datums), handle),
                        session.store._row_encoder.encode(meta.col_ids(), datums),
                    ))
                    for idx in meta.indices:
                        vals = [datums[pos[cn]] for cn in idx.col_names] + [Datum.i64(handle)]
                        items.append((tablecodec.encode_index_key(meta.table_id, idx.index_id, vals), b"\x00"))
                # raises KeyIsLocked on a conflict with a live 2PC; the
                # session's LOAD DATA branch maps it to a SQLError (vet
                # dataflow-error-escape: it used to escape the boundary raw)
                session.store.txn.check_unlocked([k for k, _ in items])
                # quorum-lost regions refuse bulk writes too;
                # raises BEFORE anything turns durable
                session.store._check_write_quorum([k for k, _ in items])
                applied = [(k, v, session.store.kv.put(k, v, ts)) for k, v in items]
            # PD write flow AFTER the engine guard (bulk-loaded regions
            # must report their size/keys or the merge-checker sees them
            # as empty) but INSIDE the write window: the replication
            # proposal carries this batch's change events at its real ts
            session.store.record_applied_writes(applied, ts)
        session.store._bump_write_ver()
        # stats track per durable batch (a later failed batch must not
        # leave committed rows uncounted)
        meta.row_count += len(batch_rows)
        imported += len(batch_rows)
        batch_rows.clear()
        # durable progress marker AFTER the batch lands (resume skips it)
        with open(ckpt_path, "w") as f:
            f.write(str(done + imported))

    with open(path) as f:
        lineno = 0
        data_lineno = 0
        for raw in f:
            lineno += 1
            if lineno <= stmt.ignore_lines:
                continue
            line = raw.rstrip("\n").rstrip("\r")
            if not line:
                continue
            data_lineno += 1
            if data_lineno <= done:
                continue  # resumed past the checkpoint
            fields = _parse_line(line, sep, enc)
            if len(fields) != len(positions):
                raise SQLError(
                    f"LOAD DATA: line {lineno} has {len(fields)} fields, expected {len(positions)}"
                )
            datums = [Datum.NULL] * len(meta.columns)
            name_to_i = {c.name: i for i, c in enumerate(meta.columns)}
            handle = None
            for cm, text in zip(positions, fields):
                if text == "\x00NULL" or text == "\\N":
                    d = Datum.NULL
                else:
                    d = _coerce_datum(Datum.string(text), cm.ft)
                datums[name_to_i[cm.name]] = d
                if meta.handle_col == cm.name and not d.is_null():
                    handle = int(d.val)
                    meta.observe_handle(handle)
            if handle is None:
                handle = meta.alloc_handle()
                if meta.handle_col is not None:
                    i = name_to_i[meta.handle_col]
                    datums[i] = Datum.i64(handle)
            batch_rows.append((handle, datums))
            if len(batch_rows) >= BATCH:
                flush()
    flush()
    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # complete: clear the resume marker
    return imported
