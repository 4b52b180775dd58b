"""DDL job framework + ALTER TABLE execution (ref: pkg/ddl — the F1-style
online schema change. The reference queues jobs in system tables, an owner
schedules them, and each state transition bumps the schema version while
the domain reload loop syncs every node; in one process the executor is
synchronous, but jobs still step through the recorded states so EVERY
schema change is auditable via ADMIN SHOW DDL JOBS, and index builds pass
through delete-only -> write-only -> write-reorg -> public exactly like
pkg/ddl/index.go).

ALTER TABLE actions (ref: ddl_api.go):
  ADD COLUMN      metadata + origin default (old rows fill it at read
                  time — no table rewrite, the reference's fast path)
  DROP COLUMN     metadata removal (stored bytes become unreachable;
                  indexes on the column must be dropped first)
  MODIFY/CHANGE   same-class type changes only (widening); re-typing that
                  would reinterpret stored bytes is rejected loudly
  RENAME COLUMN / RENAME TABLE / ADD INDEX / DROP INDEX

Port of `tidb_tpu/sql/ddl.py` (imports rewritten; it imports nothing of
tidb_tpu).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..parser import ast as A
from ..types import Datum
from .catalog import Catalog, CatalogError, ColumnMeta, field_type_from_spec

class DDLError(ValueError):
    pass


@dataclass
class DDLJob:
    """(ref: pkg/meta/model Job)."""

    job_id: int
    job_type: str
    table: str
    query: str
    state: str = "queueing"  # queueing -> running -> (synced | cancelled)
    schema_state: str = "none"
    start_time: float = 0.0
    end_time: float = 0.0
    error: str = ""
    states_seen: list = field(default_factory=list)


class DDLJobLog:
    """Job history (ref: the ddl job + history system tables)."""

    def __init__(self):
        self.jobs: list[DDLJob] = []  # guarded_by: _lock
        self._next = 1  # guarded_by: _lock
        self._lock = threading.Lock()

    def begin(self, job_type: str, table: str, query: str) -> DDLJob:
        with self._lock:
            job = DDLJob(self._next, job_type, table, query, start_time=time.time())
            self._next += 1
            self.jobs.append(job)
        job.state = "running"
        return job

    def step(self, job: DDLJob, schema_state: str):
        job.schema_state = schema_state
        job.states_seen.append(schema_state)

    def view(self) -> list:
        """Locked snapshot for readers on other threads (HTTP /ddl/history,
        ADMIN SHOW DDL JOBS) — `jobs` itself is guarded."""
        with self._lock:
            return list(self.jobs)

    def finish(self, job: DDLJob, error: str = ""):
        job.state = "cancelled" if error else "synced"
        job.error = error
        job.end_time = time.time()


def run_job(catalog: Catalog, job_type: str, table: str, query: str, fn, index_states: bool = False):
    """Execute one schema change as a recorded job. Index builds receive a
    `step` callback and drive the four online states THEMSELVES (the
    IndexMeta.state walk in session._build_index — each transition is a
    real visibility change for concurrent DML, and each records here as a
    schema-state step, ref: pkg/ddl job.SchemaState)."""
    log = catalog.ddl_jobs
    job = log.begin(job_type, table, query)
    try:
        if index_states:
            result = fn(lambda st: log.step(job, st))
        else:
            result = fn()
        log.step(job, "public")
        log.finish(job)
        return result
    except Exception as exc:
        log.finish(job, error=str(exc))
        raise


# ---------------------------------------------------------------- ALTER

def alter_table(session, stmt: A.AlterTableStmt):
    """Apply every spec of an ALTER TABLE, one DDL job per spec."""
    meta = session.catalog.table(stmt.table.name)
    for spec in stmt.specs:
        action = spec.action
        query = f"ALTER TABLE {meta.name} {action}"
        if action == "add_column":
            run_job(session.catalog, "add column", meta.name, query,
                    lambda s=spec, q=query: _add_column(session, meta, s, q))
        elif action == "drop_column":
            run_job(session.catalog, "drop column", meta.name, query,
                    lambda s=spec, q=query: _drop_column(session, meta, s.name, q))
        elif action in ("modify_column", "change_column"):
            run_job(session.catalog, action.replace("_", " "), meta.name, query,
                    lambda s=spec, q=query: _modify_column(session, meta, s, q))
        elif action == "rename_column":
            run_job(session.catalog, "rename column", meta.name, query,
                    lambda s=spec, q=query: _rename_column(
                        session, meta, s.name, s.new_name, q))
        elif action == "add_index":
            idx = spec.index
            if getattr(idx, "primary", False):
                raise DDLError("ADD PRIMARY KEY is not supported (handle fixed at CREATE)")
            cols = [c[0] if isinstance(c, tuple) else str(c) for c in idx.columns]
            name = idx.name or f"idx_{len(meta.indices)}"
            run_job(session.catalog, "add index", meta.name, query,
                    lambda step, n=name, cs=cols, u=idx.unique: session._build_index(meta, n, cs, u, step=step),
                    index_states=True)
        elif action == "drop_index":
            run_job(session.catalog, "drop index", meta.name, query,
                    lambda s=spec: session._drop_index_impl(meta, s.name))
        elif action == "rename":
            run_job(session.catalog, "rename table", meta.name, query,
                    lambda s=spec: _rename_table(session.catalog, meta, s.new_name or s.name))
        elif action == "set_columnar_replica":
            # ALTER TABLE t SET COLUMNAR REPLICA n (ref: TiDB's SET
            # TIFLASH REPLICA DDL creating learner replicas): n >= 1
            # attaches the changefeed-fed columnar replica, 0 detaches it
            run_job(session.catalog, "set columnar replica", meta.name, query,
                    lambda s=spec: _set_columnar_replica(session, meta, s.options.get("count", 1)))
        else:
            raise DDLError(f"ALTER TABLE action {action!r} not supported yet")


def _set_columnar_replica(session, meta, count: int):
    from ..cdc import ChangefeedError

    try:
        if count > 0:
            session.store.columnar.enable_table(session.catalog, meta)
        else:
            session.store.columnar.disable_table(meta)
    except ChangefeedError as exc:
        raise DDLError(str(exc)) from exc


def _propose_schema(session, meta, op: str, query: str) -> None:
    """A row-shape DDL just committed: ride a schema-change entry
    through the replication log so every live changefeed sees the ALTER
    as an ORDERED event between the rows committed before and after it
    (otherwise feeds discover the drift and park). Mirror/bare stores
    without the propose hook have no feeds to inform."""
    propose = getattr(session.store, "propose_schema_change", None)
    if propose is not None:
        propose(meta, op, query)


def _add_column(session, meta, spec: A.AlterTableSpec, query: str = ""):
    cd = spec.column
    name = cd.name.lower()
    if any(c.name == name for c in meta.columns):
        raise DDLError(f"column {name!r} already exists")
    ft = field_type_from_spec(cd.type, cd.not_null)
    origin = None
    if cd.default is not None:
        origin = session._eval_const(cd.default, ft)
    elif cd.not_null:
        # MySQL implicit default for NOT NULL without DEFAULT
        from .planner import _coerce_datum

        zero = Datum.string("") if ft.is_string() else Datum.i64(0)
        origin = _coerce_datum(zero, ft) if not ft.is_string() else zero
    pos = len(meta.columns)
    if spec.position == "first":
        pos = 0
    elif spec.position.startswith("after:"):
        target = spec.position[6:].lower()
        names = [c.name for c in meta.columns]
        if target not in names:
            raise DDLError(f"unknown column {target!r} in AFTER")
        pos = names.index(target) + 1
    new_id = meta.alloc_col_id()
    from .catalog import decl_text

    cm = ColumnMeta(name, new_id, ft, cd.default, cd.auto_increment, origin_default=origin,
                    generated=cd.generated,
                    generated_stored=getattr(cd, "generated_stored", False),
                    decl=decl_text(cd.type))
    meta.columns.insert(pos, cm)
    meta.schema_version += 1  # row-shape change: replicated through the feed
    session.catalog.version += 1
    _propose_schema(session, meta, "add column", query)


def _drop_column(session, meta, name: str, query: str = ""):
    name = name.lower()
    if meta.handle_col == name:
        raise DDLError("cannot drop the PRIMARY KEY handle column")
    if meta.partition is not None and meta.partition.col == name:
        raise DDLError(f"cannot drop partitioning column {name!r}")
    if len(meta.columns) == 1:
        raise DDLError("cannot drop the last column")
    for idx in meta.indices:
        if name in idx.col_names:
            raise DDLError(f"column {name!r} is indexed by {idx.name!r}; drop the index first")
    before = len(meta.columns)
    meta.columns = [c for c in meta.columns if c.name != name]
    if len(meta.columns) == before:
        raise DDLError(f"unknown column {name!r}")
    meta.schema_version += 1  # row-shape change: replicated through the feed
    session.catalog.version += 1
    _propose_schema(session, meta, "drop column", query)


def _modify_column(session, meta, spec: A.AlterTableSpec, query: str = ""):
    cd = spec.column
    old_name = (spec.name or cd.name).lower()
    cm = meta.col(old_name)
    new_ft = field_type_from_spec(cd.type, cd.not_null)
    old_et, new_et = cm.ft.eval_type(), new_ft.eval_type()
    if old_et != new_et:
        raise DDLError(
            f"MODIFY {old_name!r}: changing {old_et} to {new_et} would reinterpret "
            "stored bytes — not supported (export + reload instead)"
        )
    if old_et == "int" and cm.ft.is_unsigned() != new_ft.is_unsigned():
        raise DDLError(f"MODIFY {old_name!r}: signedness change not supported")
    renaming = spec.action == "change_column" and cd.name.lower() != old_name
    if renaming and any(c.name == cd.name.lower() for c in meta.columns):
        # validate BEFORE mutating anything — a failed DDL must not
        # half-apply (the rename would reject after the type change)
        raise DDLError(f"column {cd.name.lower()!r} already exists")
    cm.ft = new_ft
    if renaming:
        _rename_column(session, meta, old_name, cd.name, query)
        return
    meta.schema_version += 1  # row-shape change: replicated through the feed
    session.catalog.version += 1
    _propose_schema(session, meta, "modify column", query)


def _rename_column(session, meta, old: str, new: str, query: str = ""):
    old, new = old.lower(), new.lower()
    if any(c.name == new for c in meta.columns):
        raise DDLError(f"column {new!r} already exists")
    cm = meta.col(old)
    cm.name = new
    for idx in meta.indices:
        idx.col_names = [new if c == old else c for c in idx.col_names]
    if meta.handle_col == old:
        meta.handle_col = new
    if meta.partition is not None and meta.partition.col == old:
        meta.partition.col = new
    meta.schema_version += 1  # row-shape change: replicated through the feed
    session.catalog.version += 1
    _propose_schema(session, meta, "rename column", query)


def _rename_table(catalog: Catalog, meta, new_name: str):
    new_name = new_name.lower()
    with catalog._lock:
        if new_name in catalog._tables:
            raise DDLError(f"table {new_name!r} already exists")
        del catalog._tables[meta.name]
        meta.name = new_name
        catalog._tables[new_name] = meta
        catalog.version += 1
