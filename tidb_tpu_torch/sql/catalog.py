"""Catalog: table metadata keyed by name — the dict-backed infoschema/meta
analog (ref: pkg/infoschema InfoSchema, pkg/meta/model TableInfo/ColumnInfo;
schema versioning and the domain reload loop collapse to a monotonic version
counter in one process).

CREATE TABLE feeds this from the parsed AST; the planner resolves names
through it; the session allocates row handles from its per-table autoid
(ref: pkg/meta/autoid).

Copy of `tidb_tpu/sql/catalog.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

# handle/col-id allocations are tiny critical sections; one module lock
# keeps TableMeta a plain dataclass (ref: meta/autoid's own mutex)
_ALLOC_LOCK = threading.Lock()

from ..parser import ast as A
from ..types import Collation, FieldType, Flag, TypeCode, new_datetime, new_decimal, new_double, new_longlong, new_varchar


class CatalogError(ValueError):
    pass


@dataclass
class FKMeta:
    """(ref: pkg/meta/model FKInfo)."""

    name: str
    cols: list  # child column names
    ref_table: str  # catalog key of the parent
    ref_cols: list
    on_delete: str = "restrict"
    on_update: str = "restrict"


def decl_text(ts: A.TypeSpec) -> str:
    """Declared type spelling for SHOW CREATE TABLE (ref: the reference
    round-trips meta/model FieldType through types.StrFor SHOW; here the
    storage types are normalized so the spelling must be kept)."""
    name = ts.name
    out = name
    if ts.length > 0 and ts.decimal >= 0 and name == "decimal":
        out = f"decimal({ts.length},{ts.decimal})"
    elif name == "decimal":
        out = "decimal(10,0)"
    elif ts.length > 0 and name in ("char", "varchar", "binary", "varbinary", "bit"):
        out = f"{name}({ts.length})"
    elif ts.decimal > 0 and name in ("datetime", "timestamp", "time"):
        out = f"{name}({ts.decimal})"
    elif ts.elems:
        vals = ",".join("'" + e.replace("'", "''") + "'" for e in ts.elems)
        out = f"{name}({vals})"
    if ts.unsigned:
        out += " unsigned"
    if ts.zerofill:
        out += " zerofill"
    return out


def field_type_from_spec(ts: A.TypeSpec, not_null: bool = False) -> FieldType:
    """TypeSpec (DDL/CAST AST) -> FieldType (ref: pkg/parser/types -> tipb
    ColumnInfo mapping in pkg/tablecodec)."""
    name = ts.name
    if name in ("tinyint", "smallint", "mediumint", "int", "bigint", "year", "bit"):
        ft = new_longlong(unsigned=ts.unsigned or name == "bit", notnull=not_null)
        return ft
    if name in ("float", "double"):
        return FieldType(TypeCode.Double, flag=Flag.NotNull if not_null else Flag(0))
    if name == "decimal":
        prec = ts.length if ts.length > 0 else 10
        scale = ts.decimal if ts.decimal >= 0 else 0
        ft = new_decimal(prec, scale)
        if not_null:
            ft = FieldType(ft.tp, ft.flag | Flag.NotNull, ft.flen, ft.decimal)
        return ft
    if name == "json":
        from ..types import new_json

        ft = new_json()
        if not_null:
            ft = FieldType(ft.tp, ft.flag | Flag.NotNull, ft.flen, ft.decimal)
        return ft
    if name in ("enum", "set"):
        from ..types import new_enum, new_set

        mk = new_enum if name == "enum" else new_set
        return mk(tuple(ts.elems), notnull=not_null)
    if name in ("char", "varchar", "binary", "varbinary", "text", "tinytext", "mediumtext", "longtext",
                "blob", "tinyblob", "mediumblob", "longblob"):
        flen = ts.length if ts.length > 0 else (1 if name == "binary" else 255)
        ft = new_varchar(flen)
        # byte-semantics functions (LENGTH/HEX/ASCII) consult the declared
        # charset (ref: types.FieldType.GetCharset feeding builtin_string);
        # binary types carry "binary" + the BINARY(n) zero-pad width
        if name in ("binary", "varbinary", "blob", "tinyblob", "mediumblob", "longblob"):
            ft.charset = "binary"
            if name == "binary":
                # fixed BINARY(n): TypeCode.String marks the zero-pad width
                # contract (planner._coerce_datum pads on write; ref:
                # pkg/table/column.go ProduceStrWithSpecifiedTp)
                ft.tp = TypeCode.String
        elif ts.charset:
            ft.charset = ts.charset.lower()
        if ts.collate:
            c = ts.collate.lower()
            if c.endswith("_general_ci"):
                ft.collate = Collation.Utf8MB4GeneralCI
            elif c.endswith(("_unicode_ci", "_0900_ai_ci", "_unicode_520_ci")):
                ft.collate = Collation.Utf8MB4UnicodeCI
            elif c.endswith("_bin") or c == "binary":
                ft.collate = Collation.Utf8MB4Bin
        if not_null:
            ft = FieldType(ft.tp, ft.flag | Flag.NotNull, ft.flen, ft.decimal, ft.charset, ft.collate)
        return ft
    if name in ("date", "datetime", "timestamp"):
        fsp = ts.decimal if ts.decimal > 0 else 0
        ft = new_datetime(fsp)
        if not_null:
            ft = FieldType(ft.tp, ft.flag | Flag.NotNull, ft.flen, ft.decimal)
        return ft
    if name == "time":  # duration stored as int64 nanoseconds
        return new_longlong(notnull=not_null)
    raise CatalogError(f"unsupported column type {name!r}")


@dataclass
class ColumnMeta:
    name: str
    col_id: int
    ft: FieldType
    default: object = None  # parsed AST default, evaluated at insert
    auto_increment: bool = False
    origin_default: object = None  # Datum filled for rows older than an
    # ADD COLUMN (ref: meta/model ColumnInfo.OriginDefaultValue)
    generated: object = None  # GENERATED ALWAYS AS expr AST (ref:
    # meta/model ColumnInfo.GeneratedExprString; executor computes at
    # write, pkg/table/column.go CastValue + BuildRowcodecColInfo)
    generated_stored: bool = False
    decl: str | None = None  # declared SQL type text ("int", "char(20)")
    # — the engine normalizes storage types (all ints -> int64 lanes), so
    # SHOW CREATE TABLE needs the original spelling preserved


@dataclass
class IndexMeta:
    """(ref: meta/model IndexInfo). `state` walks the F1 online-schema
    states during ADD INDEX (ddl.py): delete_only -> write_only ->
    write_reorg -> public. Readers use public indexes only; DML writes
    entries from write_only on and honors deletes in every state."""

    name: str
    index_id: int
    col_names: list
    unique: bool = False
    state: str = "public"


@dataclass
class TableMeta:
    name: str
    table_id: int
    columns: list  # [ColumnMeta]
    indices: list = field(default_factory=list)  # [IndexMeta]
    handle_col: str | None = None  # integer PRIMARY KEY column used as row handle
    _next_handle: int = 1  # autoid cursor (ref: meta/autoid); guarded_by: _ALLOC_LOCK
    row_count: int = 0  # maintained by DML; the planner's only "statistic"
    next_col_id: int = 0  # max-ever col id + 1: DROP COLUMN must never free
    # its id for reuse (old rows still hold bytes under it)
    partition: "PartitionInfo | None" = None  # RANGE/HASH partitioning
    foreign_keys: list = field(default_factory=list)  # [FKMeta] (ref:
    # meta/model FKInfo; checked at DML by executor/foreign_key.go analog)
    # per-table ROW-SHAPE version: bumped by column DDL (add/drop/modify/
    # rename) but not by index or placement changes. Changefeeds stamp it
    # at birth and park on drift instead of silently mounting old rows
    # against a new catalog (ref: TiCDC's
    # schema-tracker snapshot keyed by schema version)
    schema_version: int = 0

    def __post_init__(self):
        if self.next_col_id <= 0:
            self.next_col_id = max((c.col_id for c in self.columns), default=0) + 1

    def col(self, name: str) -> ColumnMeta:
        for c in self.columns:
            if c.name == name.lower():
                return c
        raise CatalogError(f"unknown column {name!r} in table {self.name!r}")

    def scan_columns(self) -> tuple:
        """ColumnInfos for a full-row scan of this table."""
        from ..exec.dag import ColumnInfo

        return tuple(ColumnInfo(c.col_id, c.ft, c.origin_default) for c in self.columns)

    def col_ids(self) -> list:
        return [c.col_id for c in self.columns]

    def physical_ids(self) -> list:
        """Key-space ids rows live under: per-partition pids, or the table
        id itself (ref: PartitionDefinition.ID vs TableInfo.ID)."""
        if self.partition is not None:
            return [p.pid for p in self.partition.parts]
        return [self.table_id]

    def pid_for_row(self, datums: list) -> int:
        """Physical id the row belongs to (partition routing by the
        partition column's value; unpartitioned -> table_id)."""
        if self.partition is None:
            return self.table_id
        i = next(j for j, c in enumerate(self.columns) if c.name == self.partition.col)
        d = datums[i]
        return self.partition.route(None if d.is_null() else int(d.val))

    def fts(self) -> list:
        return [c.ft for c in self.columns]

    def alloc_handle(self) -> int:
        with _ALLOC_LOCK:
            h = self._next_handle
            self._next_handle += 1
            return h

    def peek_handle(self) -> int:
        with _ALLOC_LOCK:
            return self._next_handle

    def observe_handle(self, h: int):
        """Explicit-PK inserts advance the allocator past the used value
        (MySQL auto_increment semantics; ref: meta/autoid rebase)."""
        with _ALLOC_LOCK:
            if h >= self._next_handle:
                self._next_handle = h + 1

    def alloc_col_id(self) -> int:
        with _ALLOC_LOCK:
            v = self.next_col_id
            self.next_col_id += 1
            return v


@dataclass
class PartitionDef:
    """One physical partition: its own key space under `pid`
    (ref: meta/model PartitionDefinition — per-partition physical IDs)."""

    name: str
    pid: int
    upper: int | None = None  # RANGE: exclusive upper bound; None = MAXVALUE


@dataclass
class PartitionInfo:
    """RANGE/HASH partitioning over one integer column (ref: meta/model
    PartitionInfo; pruning rule_partition_processor.go). Each partition is
    a separate physical key space; the logical table routes rows by the
    partition column's value."""

    method: str  # "range" | "hash"
    col: str
    parts: list  # [PartitionDef]

    def route(self, val) -> int:
        """Partition id for a column value (None = NULL).

        NULL routes to the FIRST partition (MySQL: NULL is less than any
        non-NULL for RANGE; hashes as 0 for HASH)."""
        if self.method == "hash":
            if val is None:
                return self.parts[0].pid
            return self.parts[int(val) % len(self.parts)].pid
        if val is None:
            return self.parts[0].pid
        v = int(val)
        for p in self.parts:
            if p.upper is None or v < p.upper:
                return p.pid
        raise CatalogError(f"Table has no partition for value {v}")

    def prune(self, intervals) -> list:
        """PartitionDefs whose value range intersects the ranger intervals
        (None = no constraint -> all). RANGE prunes by bound overlap; HASH
        prunes only point intervals (ref: rule_partition_processor.go)."""
        if intervals is None:
            return list(self.parts)
        if self.method == "hash":
            pids = []
            for iv in intervals:
                lo, hi = iv.low, iv.high
                if lo is None or hi is None or lo.is_null() or hi.is_null():
                    return list(self.parts)
                if int(lo.val) != int(hi.val) or not (iv.low_inc and iv.high_inc):
                    return list(self.parts)  # only point lookups prune hash
                p = self.parts[int(lo.val) % len(self.parts)]
                if p not in pids:
                    pids.append(p)
            return pids
        out = []
        prev_upper = None
        for p in self.parts:
            lo_b = prev_upper  # inclusive lower bound (None = -inf)
            hi_b = p.upper  # exclusive upper (None = +inf)
            prev_upper = p.upper
            for iv in intervals:
                iv_lo = None if iv.low is None or iv.low.is_null() else int(iv.low.val)
                iv_hi = None if iv.high is None or iv.high.is_null() else int(iv.high.val)
                below = hi_b is not None and iv_lo is not None and iv_lo >= hi_b
                above = lo_b is not None and iv_hi is not None and iv_hi < lo_b
                if not below and not above:
                    out.append(p)
                    break
        return out


@dataclass
class ViewMeta:
    """A stored view: the SELECT text re-plans at every use (ref:
    meta/model ViewInfo; expansion in logical_plan_builder.go's
    buildDataSource view branch)."""

    name: str
    columns: list  # explicit column-name list ([] = from the SELECT)
    select_sql: str


class Catalog:
    """name -> TableMeta, with monotonically increasing table/index ids
    (ref: infoschema; ids from meta's global id allocator)."""

    def __init__(self):
        self._tables: dict[str, TableMeta] = {}  # guarded_by: _lock
        self._next_id = 1001  # guarded_by: _lock
        # RLock: DDL entry points hold it across whole schema changes and
        # re-enter through table() lookups (background TTL/auto-analyze
        # sessions read the same maps from timer threads)
        self._lock = threading.RLock()
        self.version = 0  # schema version (ref: domain schema lease)
        self.databases: set[str] = {"test", "mysql"}  # CREATE/DROP DATABASE
        self.bindings: dict = {}  # GLOBAL plan bindings: digest -> record
        self.stats: dict[int, object] = {}  # table_id -> TableStats (ANALYZE)
        self.views: dict[str, ViewMeta] = {}  # name -> views; guarded_by: _lock
        from .privilege import PrivilegeStore

        self.privileges = PrivilegeStore()  # domain-level user/priv cache
        from .ddl import DDLJobLog

        self.ddl_jobs = DDLJobLog()  # schema-change job history
        from ..util.stmtlog import StmtLog

        self.stmtlog = StmtLog()  # slow-query log + statement summary
        # (domain-level: shared by every session of this catalog)
        from .plancache import PlanCache

        self.plan_cache = PlanCache()  # digest-keyed plan templates
        # (instance-level like the reference's plan cache)
        self.bindings_rev = 0  # bumped on GLOBAL binding changes: cached
        # plans were built under a binding view and re-validate against it

    def _alloc_id(self) -> int:  # requires: _lock
        v = self._next_id
        self._next_id += 1
        return v

    def ensure_id_above(self, n: int):
        """Restore installs original table/index ids; the allocator must
        never hand them out again (ref: meta global id rebase)."""
        with self._lock:
            if n >= self._next_id:
                self._next_id = n + 1

    def create_table(self, stmt: A.CreateTableStmt) -> TableMeta:
        name = stmt.table.name.lower()
        with self._lock:
            if name in self.views:
                raise CatalogError(f"view {name!r} already exists")
            if name in self._tables:
                if stmt.if_not_exists:
                    return self._tables[name]
                raise CatalogError(f"table {name!r} already exists")
            cols = []
            handle_col = None
            for i, cd in enumerate(stmt.columns):
                ft = field_type_from_spec(cd.type, cd.not_null or cd.primary_key)
                cols.append(ColumnMeta(
                    cd.name.lower(), i + 1, ft, cd.default, cd.auto_increment,
                    generated=cd.generated,
                    generated_stored=getattr(cd, "generated_stored", False),
                    decl=decl_text(cd.type),
                ))
            pk_cols: list[str] = []
            for cd in stmt.columns:
                if cd.primary_key:
                    ft = next(c for c in cols if c.name == cd.name.lower()).ft
                    if ft.is_int():
                        handle_col = cd.name.lower()
                    else:
                        # NONCLUSTERED primary key: implicit _tidb_rowid
                        # handle + unique PRIMARY index — the reference's
                        # own layout when the PK cannot be the row key
                        # (ref: pkg/meta/model/table.go IsCommonHandle
                        # false path, tables.go AllocHandle)
                        pk_cols = [cd.name.lower()]
            indices = []
            for j, idx in enumerate(getattr(stmt, "indexes", []) or []):
                iname = getattr(idx, "name", "") or f"idx_{j}"
                raw = [c[0].lower() if isinstance(c, tuple) else str(c).lower() for c in idx.columns]
                # expression elements ("__expr__") are dropped; a UNIQUE
                # index that lost one also drops uniqueness — the leftover
                # plain columns would otherwise enforce a STRICTER
                # constraint than declared (reject legal inserts)
                icols = [c for c in raw if c != "__expr__"]
                had_expr = len(icols) != len(raw)
                if getattr(idx, "primary", False):
                    if not icols:
                        continue
                    c = next((c for c in cols if c.name == icols[0]), None)
                    if len(icols) == 1 and c is not None and c.ft.is_int():
                        handle_col = icols[0]
                        continue
                    pk_cols = icols
                    continue
                if not icols:
                    continue  # pure expression index: parsed-and-dropped
                unique = getattr(idx, "unique", False) and not had_expr
                indices.append(IndexMeta(iname, self._alloc_id(), icols, unique))
            if pk_cols and handle_col is None:
                for cn in pk_cols:
                    cm = next((c for c in cols if c.name == cn), None)
                    if cm is None:
                        raise CatalogError(f"unknown PRIMARY KEY column {cn!r}")
                    cm.ft.flag |= Flag.NotNull | Flag.PriKey
                indices.insert(0, IndexMeta("PRIMARY", self._alloc_id(), pk_cols, True))
            part = None
            pdict = (stmt.options or {}).get("partition_by")
            if pdict is not None:
                part = self._build_partition(pdict, cols, handle_col, indices)
            fks = []
            for j, fk in enumerate(getattr(stmt, "foreign_keys", []) or []):
                fks.append(FKMeta(
                    fk.name or f"fk_{j + 1}",
                    [c.lower() for c in fk.columns],
                    fk.ref_table.name.lower(),
                    [c.lower() for c in fk.ref_columns],
                    fk.on_delete, fk.on_update,
                ))
            tbl = TableMeta(name, self._alloc_id(), cols, indices, handle_col, partition=part, foreign_keys=fks)
            self._tables[name] = tbl
            self.version += 1
            return tbl

    def _build_partition(self, pdict: dict, cols, handle_col, indices) -> "PartitionInfo":
        """options['partition_by'] -> PartitionInfo (RANGE / HASH over one
        integer column; ref: ddl partition checks + meta/model
        PartitionInfo). MySQL's unique-key rule is enforced: the partition
        column must be part of the PK / every unique key."""
        method = pdict["method"].lower()
        if method == "key":
            method = "hash"  # KEY(col) hashes the column too
        if method not in ("range", "hash"):
            raise CatalogError(f"PARTITION BY {pdict['method']} not supported yet")
        exprs = pdict.get("exprs") or []
        if len(exprs) != 1 or not isinstance(exprs[0], A.ColumnName):
            raise CatalogError("partitioning supports a single bare column only")
        pcol = exprs[0].name.lower()
        cm = next((c for c in cols if c.name == pcol), None)
        if cm is None:
            raise CatalogError(f"unknown partition column {pcol!r}")
        if not cm.ft.is_int():
            raise CatalogError("partition column must be an integer column")
        # ref: MySQL "A PRIMARY KEY must include all columns in the
        # table's partitioning function" (same for unique keys)
        if handle_col is not None and handle_col != pcol:
            raise CatalogError(
                "a PRIMARY KEY must include the table's partitioning column"
            )
        if indices:
            # same restriction add_index enforces — an inline KEY in the
            # CREATE TABLE must not bypass it (per-partition local indexes
            # are not implemented yet)
            raise CatalogError(
                "secondary indexes on partitioned tables are not supported yet"
            )
        parts = []
        if method == "hash":
            n = int(pdict.get("n") or 0)
            if n <= 0:
                raise CatalogError("PARTITION BY HASH requires PARTITIONS n")
            for i in range(n):
                parts.append(PartitionDef(f"p{i}", self._alloc_id()))
            return PartitionInfo("hash", pcol, parts)
        prev = None
        for pd in pdict.get("parts") or []:
            lt = pd.get("less_than")
            if lt == "MAXVALUE" or (isinstance(lt, list) and lt and lt[0] == "MAXVALUE"):
                upper = None
            else:
                if not (isinstance(lt, list) and len(lt) == 1 and isinstance(lt[0], A.Literal)):
                    raise CatalogError("RANGE partition bounds must be integer literals")
                upper = int(lt[0].value)
                if prev is not None and upper <= prev:
                    raise CatalogError("RANGE partition bounds must be ascending")
                prev = upper
            parts.append(PartitionDef(pd["name"].lower(), self._alloc_id(), upper))
        if not parts:
            raise CatalogError("RANGE partitioning requires a partition list")
        return PartitionInfo("range", pcol, parts)

    def add_index(self, table: str, index_name: str, col_names: list, unique: bool = False, state: str = "public") -> IndexMeta:
        """CREATE INDEX metadata step (the backfill is the session's job —
        ref: pkg/ddl add-index schema change + backfill)."""
        with self._lock:
            tbl = self.table(table)
            if tbl.partition is not None:
                raise CatalogError(
                    "secondary indexes on partitioned tables are not supported yet"
                )
            if any(i.name == index_name for i in tbl.indices):
                raise CatalogError(f"index {index_name!r} already exists")
            raw = [c.lower() for c in col_names]
            col_names = [c for c in raw if c != "__expr__"]
            if not col_names:
                raise CatalogError(
                    "pure expression index has no plain columns (dropped)"
                )
            if len(col_names) != len(raw):
                unique = False  # see create_table: degraded expr index
            for cn in col_names:
                tbl.col(cn)  # validates
            im = IndexMeta(index_name, self._alloc_id(), [c.lower() for c in col_names], unique, state)
            tbl.indices.append(im)
            self.version += 1
            return im

    def drop_index(self, table: str, index_name: str) -> IndexMeta:
        with self._lock:
            tbl = self.table(table)
            im = next((i for i in tbl.indices if i.name == index_name), None)
            if im is None:
                raise CatalogError(f"unknown index {index_name!r} on {table!r}")
            tbl.indices = [i for i in tbl.indices if i is not im]
            self.version += 1
            return im

    def drop_table(self, name: str, if_exists: bool = False):
        with self._lock:
            if name.lower() not in self._tables:
                if name.lower() in self.views:
                    raise CatalogError(f"{name!r} is a VIEW (use DROP VIEW)")
                if if_exists:
                    return
                raise CatalogError(f"unknown table {name!r}")
            meta = self._tables.pop(name.lower())
            self.stats.pop(meta.table_id, None)
            self.version += 1

    def create_view(self, name: str, columns: list, select_sql: str, or_replace: bool = False):
        n = name.lower()
        with self._lock:
            if n in self._tables:
                raise CatalogError(f"table {name!r} already exists")
            if n in self.views and not or_replace:
                raise CatalogError(f"view {name!r} already exists")
            self.views[n] = ViewMeta(n, [c.lower() for c in columns], select_sql)
            self.version += 1

    def drop_view(self, name: str, if_exists: bool = False):
        with self._lock:
            if name.lower() not in self.views:
                if if_exists:
                    return
                raise CatalogError(f"unknown view {name!r}")
            del self.views[name.lower()]
            self.version += 1

    def table_by_id(self, table_id: int) -> TableMeta | None:
        with self._lock:
            return self._table_by_id_locked(table_id)

    def _table_by_id_locked(self, table_id: int):  # requires: _lock
        for t in self._tables.values():
            if t.table_id == table_id:
                return t
        return None

    def table(self, name: str) -> TableMeta:
        with self._lock:
            t = self._tables.get(name.lower())
        if t is None:
            raise CatalogError(f"unknown table {name!r}")
        return t

    def tables(self) -> list:
        with self._lock:
            return sorted(self._tables)

    def view_of(self, name: str):
        """ViewMeta for `name` (None if absent) — the locked lookup every
        cross-thread reader goes through (planner threads vs CREATE/DROP
        VIEW; surfaced by lockwatch on `views`)."""
        with self._lock:
            return self.views.get(name.lower())

    def view_names(self) -> list:
        with self._lock:
            return sorted(self.views)

    def view_snapshot(self) -> list:
        with self._lock:
            return list(self.views.values())
