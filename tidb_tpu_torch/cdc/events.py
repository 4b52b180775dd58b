"""Changefeed event shapes (ref: TiCDC's model.RowChangedEvent — the
mounted, typed form of one row's change — and model.ResolvedTs).

A raw change enters the subsystem as a (key, value|None, commit_ts)
triple riding a replication proposal; the mounter decodes it back into a
`RowEvent` with the table's typed column values. Resolved timestamps are
not events in the sorter — they are the frontier the sink's `flush`
receives once every row at or below it has been emitted."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class RowEvent:
    """One row's change, decoded (ref: model.RowChangedEvent). `columns`
    is ((name, Datum), ...) in table column order — empty for deletes
    (the reference also omits new-values on delete; the old value is the
    downstream's to look up if it cares)."""

    table: str
    table_id: int
    handle: int
    op: str  # "put" | "delete"
    commit_ts: int
    columns: tuple = field(default=())
    col_ids: tuple = field(default=())  # column ids aligned with `columns`
    # — the shape the mounter's schema tracker decoded against, so sinks
    # that hold their OWN schema snapshot (the columnar replica) can remap
    # by id instead of trusting the live catalog's column order

    def to_json(self) -> dict:
        """JSON-lines shape for the file sink (ref: TiCDC's canal-json /
        simple protocol: type + commit ts + column map)."""
        return {
            "type": "row",
            "table": self.table,
            "handle": self.handle,
            "op": self.op,
            "commit_ts": self.commit_ts,
            "columns": {
                name: (None if d.is_null() else d.val) for name, d in self.columns
            },
        }


@dataclass(frozen=True)
class SchemaEvent:
    """A schema change replicated THROUGH the feed as an ordered event
    (ref: TiCDC's DDLEvent riding the same sorted stream as row
    changes). `payload` is the full post-change column snapshot
    (cdc/schema.py's wire dict) — enough for a downstream to rebuild the
    table shape without consulting the source catalog. Rows before this
    event's commit_ts mounted against the PREVIOUS snapshot; rows after
    it mount against this one."""

    table: str
    table_id: int
    commit_ts: int
    schema_version: int
    op: str  # "add column" | "drop column" | ... (the DDL job type)
    query: str
    payload: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "type": "schema",
            "table": self.table,
            "table_id": self.table_id,
            "commit_ts": self.commit_ts,
            "schema_version": self.schema_version,
            "op": self.op,
            "query": self.query,
            "payload": self.payload,
        }


@dataclass(frozen=True)
class RawKVEvent:
    """One raw (undecoded) KV change for the log-backup feed (ref: BR's
    log backup streaming raw KV write batches, br/pkg/stream): PITR
    replay re-ingests these bytes at the source commit ts, so index
    entries and row bytes survive byte-exactly — no mount/re-encode
    round trip to drift through."""

    key: bytes
    value: bytes | None
    commit_ts: int

    def to_json(self) -> dict:
        return {
            "type": "kv",
            "k": self.key.hex(),
            "v": None if self.value is None else self.value.decode("latin1"),
            "commit_ts": self.commit_ts,
        }
