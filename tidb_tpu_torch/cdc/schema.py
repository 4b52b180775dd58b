"""Schema-change entries in the replication log (DDL replication
through the feed; ref: TiCDC's schema storage /
schemaStorage.HandleDDLJob keeping a multi-version schema snapshot so
rows mount against the version they were WRITTEN under, not the current
catalog).

A row-shape DDL (add/drop/modify/rename column) proposes a synthetic
log entry through `ReplicaManager.propose` exactly like a row write:
key = `m_schema_<table_id>_<version>` (the `m` meta keyspace — never a
real KV key), value = the JSON payload below, commit ts drawn from the
TSO inside the CDC WriteGuard so the resolved-ts frontier cannot pass
an undelivered schema change. The sorter orders it between the rows
committed before and after the ALTER, and the mounter's schema tracker
advances when the entry drains — a mid-feed ALTER is an ordered event,
not a park.

Schema entries are NOT in KV, so a feed whose live subscription lapsed
(pause, puller-drop, birth) cannot recover them with an incremental
`scan_versions` — that is what the store-level `SchemaJournal` is for:
every feed tick injects the journal's (checkpoint, candidate] window
into its sorter, and the (key, ts) dedupe absorbs the overlap with live
captures.

Payload wire shape (the log-backup segments persist it verbatim):

    {"table_id": N, "table": name, "schema_version": V,
     "op": job type, "query": DDL text, "handle_col": name|null,
     "next_col_id": N,
     "columns": [{"name", "col_id", "ft": {...}, "origin_default": {...}}]}
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass

SCHEMA_PREFIX = b"m_schema_"


def encode_schema_key(table_id: int, version: int) -> bytes:
    return SCHEMA_PREFIX + f"{table_id}_{version}".encode()


def is_schema_key(key: bytes) -> bool:
    return key.startswith(SCHEMA_PREFIX)


def schema_key_table_id(key: bytes) -> int:
    """Logical table id a schema entry belongs to — the feed's table
    filter routes on it. Raises ValueError on a malformed key (the
    caller treats that as not-wanted)."""
    rest = key[len(SCHEMA_PREFIX):]
    return int(rest.split(b"_", 1)[0])


@dataclass(frozen=True)
class ColumnSnap:
    """One column of a tracked schema snapshot — everything the mounter
    needs to decode row bytes written under this version."""

    name: str
    col_id: int
    ft: object  # FieldType
    origin_default: object  # Datum | None


@dataclass(frozen=True)
class SchemaSnapshot:
    """One table's row shape at one schema version (the mounter's
    per-feed tracked state; ref: TiCDC schema-tracker snapshot)."""

    version: int
    columns: tuple  # (ColumnSnap, ...)


def snapshot_from_meta(meta) -> SchemaSnapshot:
    return SchemaSnapshot(
        meta.schema_version,
        tuple(ColumnSnap(c.name, c.col_id, c.ft, c.origin_default)
              for c in meta.columns))


# The field-type / datum dict codecs of the full-backup manifest (copies of
# tidb_tpu/tools/br.py's): the log-backup segments persist these dicts
# verbatim, and the port's tools/br.py imports them from here.

def _ft_to_dict(ft) -> dict:
    return {
        "tp": int(ft.tp), "flag": int(ft.flag), "flen": ft.flen,
        "decimal": ft.decimal, "charset": ft.charset, "collate": int(ft.collate),
    }


def _ft_from_dict(d: dict):
    from ..types import Collation, FieldType, Flag, TypeCode

    return FieldType(
        TypeCode(d["tp"]), Flag(d["flag"]), d["flen"], d["decimal"],
        d["charset"], Collation(d["collate"]),
    )


def _datum_to_dict(d) -> dict | None:
    from ..types import DatumKind

    if d is None:
        return None
    if d.is_null():
        return {"k": "null"}
    if d.kind == DatumKind.MysqlDecimal:
        return {"k": "dec", "v": str(d.val), "s": d.val.scale}
    if d.kind == DatumKind.MysqlTime:
        return {"k": "time", "v": d.val.packed, "fsp": d.val.fsp}
    if d.kind == DatumKind.Bytes:
        return {"k": "bytes", "v": d.val.decode("latin1")}
    if d.kind == DatumKind.Uint64:
        return {"k": "u64", "v": d.val}
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        return {"k": "f64", "v": float(d.val)}
    if d.kind == DatumKind.String:
        return {"k": "str", "v": d.val}
    return {"k": "i64", "v": int(d.val)}


def _datum_from_dict(d: dict | None):
    from ..types import Datum, MyDecimal, MyTime

    if d is None:
        return None
    k = d["k"]
    if k == "null":
        return Datum.NULL
    if k == "dec":
        return Datum.dec(MyDecimal(d["v"], d["s"]))
    if k == "time":
        return Datum.time(MyTime(d["v"], d.get("fsp", 0)))
    if k == "bytes":
        return Datum.bytes_(d["v"].encode("latin1"))
    if k == "u64":
        return Datum.u64(d["v"])
    if k == "f64":
        return Datum.f64(d["v"])
    if k == "str":
        return Datum.string(d["v"])
    return Datum.i64(d["v"])


def schema_payload(meta, op: str, query: str) -> dict:
    """The wire dict for one schema-change entry (see module doc), in the
    full-backup manifest's field-type / datum codecs."""
    return {
        "table_id": meta.table_id,
        "table": meta.name,
        "schema_version": meta.schema_version,
        "op": op,
        "query": query,
        "handle_col": meta.handle_col,
        "next_col_id": meta.next_col_id,
        "columns": [
            {"name": c.name, "col_id": c.col_id, "ft": _ft_to_dict(c.ft),
             "origin_default": _datum_to_dict(c.origin_default)}
            for c in meta.columns
        ],
    }


def decode_payload(value: bytes) -> dict:
    return json.loads(value.decode())


def snapshot_from_payload(payload: dict) -> SchemaSnapshot:
    return SchemaSnapshot(
        payload["schema_version"],
        tuple(ColumnSnap(c["name"], c["col_id"], _ft_from_dict(c["ft"]),
                         _datum_from_dict(c.get("origin_default")))
              for c in payload["columns"]))


class SchemaJournal:
    """Store-level ordered log of schema-change entries — the recovery
    source for schema events (they are not in KV, so incremental scans
    cannot backfill them; see module doc). Append-only, tiny (one entry
    per row-shape DDL), trimmed below the GC safepoint by the pd.pitr
    tick once no feed can still need the window."""

    def __init__(self):
        self._mu = threading.Lock()
        self._entries: list = []  # [(ts, table_id, key, value)] ascending ts; guarded_by: _mu

    def append(self, ts: int, table_id: int, key: bytes, value: bytes) -> None:
        with self._mu:
            self._entries.append((ts, table_id, key, value))

    def entries_in(self, lo: int, hi: int) -> list:
        """Entries with lo < ts <= hi as [(key, ts, value)] — the same
        triple shape `scan_versions` hands the recovery path."""
        with self._mu:
            return [(k, ts, v) for ts, _tid, k, v in self._entries
                    if lo < ts <= hi]

    def trim(self, below_ts: int) -> int:
        """Drop entries at or below `below_ts` (every feed's checkpoint
        passed them and no log backup can still replay them). Returns
        entries dropped."""
        with self._mu:
            n0 = len(self._entries)
            self._entries = [e for e in self._entries if e[0] > below_ts]
            return n0 - len(self._entries)

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)
