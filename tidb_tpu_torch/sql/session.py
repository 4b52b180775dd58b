"""Session: SQL strings in, rows out — the engine's
`session.ExecuteStmt` (ref: pkg/session/session.go:2008) collapsed to the
single-process shape: parse -> subquery rewrite -> plan -> execute_root
over the embedded TPU store, with real Percolator transactions.

Statement coverage: CREATE/DROP/ALTER/RENAME TABLE, CREATE/DROP INDEX,
INSERT (VALUES / SELECT / REPLACE / IGNORE), UPDATE, DELETE, TRUNCATE,
SELECT (joins, aggregation, window functions, subqueries, CTEs incl.
recursive, UNION, HAVING, ORDER/LIMIT, DISTINCT, FOR UPDATE, point-get
fast path), BEGIN/COMMIT/ROLLBACK (pessimistic + optimistic 2PC),
PREPARE/EXECUTE/DEALLOCATE, CREATE/DROP USER, GRANT/REVOKE, ANALYZE,
LOAD DATA, BACKUP/RESTORE, ADMIN SHOW DDL JOBS / CHECK TABLE, SET/SHOW,
EXPLAIN. Everything else raises loudly rather than silently no-op.

Port of `tidb_tpu/sql/session.py` (imports rewritten; it imports nothing of
tidb_tpu). The session runs over the port's store on `device` (default
"cuda"), its mesh tier and mesh select over `mesh_devices` (the store's
device list, runtime.mesh_devices). What differs from the reference:
LOAD STATS resolves a relative path against the working directory.
Changefeeds (cdc/), the columnar replica (columnar/, routed to by
tidb_isolation_read_engines), BACKUP / RESTORE / BACKUP LOG (tools/br.py,
br/) and the store's cross-session coalescer (server/coalesce.py) are the
port's own, as in the reference.
The MPP tier (mpp/dispatch.py try_mpp_select), follower reads, SHOW
PLACEMENT and the PD knobs of Config reach the store's control plane (its
`pd` and `replication`), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import topsql
from ..chunk import Chunk
from ..codec import tablecodec
from ..codec.rowcodec import fill_origin_default
from ..distsql import execute_root, full_table_ranges
from ..exec.dag import ColumnInfo, DAGRequest, Selection, TableScan
from ..expr.eval_ref import RefEvaluator, _truth
from ..expr.ir import col
from ..parser import ast as A
from ..parser.parser import parse_one
from ..store import QuorumLostError, TPUStore
from ..types import Datum, DatumKind, FieldType, MyDecimal, MyTime, new_longlong
from .catalog import Catalog, CatalogError, TableMeta
from .planner import PlanError, _Lowerer, _Scope, _TableRef, _coerce_datum, plan_select

HANDLE_FT = new_longlong(notnull=True)


@dataclass
class TxnState:
    """One open transaction (ref: session's LazyTxn + the client-side
    memdb buffer; pkg/store/driver/txn). Mutations buffer at the KV level
    (what 2PC ships); row_ops keep the row-level overlay SELECTs need for
    read-your-writes (the UnionScan analog, pkg/executor/union_scan.go)."""

    start_ts: int
    mode: str  # "optimistic" | "pessimistic"
    explicit: bool
    mutations: dict = field(default_factory=dict)  # key -> bytes | None
    row_ops: dict = field(default_factory=dict)  # table_id -> {handle: [Datum] | None}
    locked: set = field(default_factory=set)  # pessimistic-locked keys
    row_delta: dict = field(default_factory=dict)  # table_id -> row-count delta
    # (applied to catalog stats only on successful commit)
    index_muts: dict = field(default_factory=dict)  # index-key subset of mutations
    named_savepoints: dict = field(default_factory=dict)  # SAVEPOINT name -> snapshot
    schema_ver: int = -1  # catalog version at txn start (DDL fencing)

    def savepoint(self):
        """Statement-level snapshot: a failed statement inside an explicit
        txn must leave no partial buffer (MySQL implicit statement
        savepoint; ref: session.StmtRollback)."""
        return (
            dict(self.mutations),
            {tid: dict(ops) for tid, ops in self.row_ops.items()},
            set(self.locked),
            dict(self.row_delta),
            dict(self.index_muts),
        )

    def restore(self, sp):
        self.mutations, self.row_ops, self.locked, self.row_delta, self.index_muts = (
            dict(sp[0]),
            {tid: dict(ops) for tid, ops in sp[1].items()},
            set(sp[2]),
            dict(sp[3]),
            dict(sp[4]),
        )


@dataclass
class Result:
    """(ref: the server's result set; rows are Datum lists)."""

    columns: list = field(default_factory=list)
    rows: list = field(default_factory=list)
    affected: int = 0
    fts: list | None = None  # column FieldTypes (wire column definitions)

    def scalar(self):
        return self.rows[0][0].val if self.rows else None

    def values(self):
        return [[d.val if not d.is_null() else None for d in r] for r in self.rows]


def qualify_tables_ast(stmt, cur_db: str) -> None:
    """Database-qualified name resolution: every A.TableName in the
    statement folds its database into the catalog key ("db.table"), and
    unqualified names under a non-default current database get the same
    prefix — the single-namespace catalog then serves multiple databases
    transparently (ref: the schema-qualified resolution in
    pkg/planner/core/logical_plan_builder.go buildDataSource). CTE names
    (any nesting level) stay raw; under the virtual schemas the db FIELD
    is set instead so _bind_information_schema still recognizes them.
    Also used by view expansion (subquery.py) with the view's defining
    database."""
    cte_names: set = set()

    def collect_ctes(n):
        if isinstance(n, (list, tuple)):
            for x in n:
                collect_ctes(x)
            return
        if not hasattr(n, "__dataclass_fields__"):
            return
        for cte in getattr(n, "ctes", None) or []:
            cte_names.add(cte.name.lower())
        for f_ in n.__dataclass_fields__:
            collect_ctes(getattr(n, f_))

    collect_ctes(stmt)
    cte_names.add("dual")  # FROM DUAL: pseudo-table, never db-qualified
    virtual = ("information_schema", "performance_schema")

    def walk(n):
        if isinstance(n, (list, tuple)):
            for x in n:
                walk(x)
            return
        if not hasattr(n, "__dataclass_fields__"):
            return
        if isinstance(n, A.SelectStmt) and isinstance(n.from_clause, A.TableName) \
                and not (n.from_clause.db or "") \
                and n.from_clause.name.lower() == "dual":
            # FROM DUAL is the no-table SELECT (MySQL compat; ref:
            # parser.y TableRefsClause DUAL production)
            n.from_clause = None
        if isinstance(n, A.TableName):
            db = (n.db or "").lower()
            if db in virtual:
                return
            nm = n.name.lower()
            if "." in nm:
                return  # already a qualified catalog key (idempotent)
            if db and db != "test":
                n.name = f"{db}.{nm}"
                n.db = ""
            elif not db and cur_db in virtual and nm not in cte_names:
                n.db = cur_db
            elif not db and cur_db != "test" and nm not in cte_names:
                n.name = f"{cur_db}.{nm}"
            return
        for f_ in n.__dataclass_fields__:
            walk(getattr(n, f_))

    walk(stmt)


def ast_digest(stmt) -> str:
    """Literal-masked structural digest of a statement AST (ref: the
    normalized-SQL digest pkg/parser/digester.go feeds to bindinfo and
    Top SQL): constants become '?', identifiers keep case-folded names,
    hints are EXCLUDED so a hinted statement digests equal to its
    original."""
    import hashlib

    parts: list = []

    def walk(n):
        if isinstance(n, (list, tuple)):
            for x in n:
                walk(x)
            return
        if isinstance(n, A.Literal):
            parts.append("?")
            return
        if isinstance(n, A.ParamMarker):
            parts.append("?")
            return
        if not hasattr(n, "__dataclass_fields__"):
            if isinstance(n, str):
                parts.append(n.lower())
            elif n is not None:
                parts.append(str(n))
            return
        parts.append(type(n).__name__)
        for f_ in n.__dataclass_fields__:
            if f_ == "hints":
                continue
            walk(getattr(n, f_))

    walk(stmt)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]


def _sql_str_escape(s: str) -> str:
    """Escape a value for embedding in a single-quoted SQL literal.

    The lexer honors BOTH backslash escapes and doubled quotes
    (parser/lexer.py), so doubling quotes alone is not enough: a value
    ending in a lone backslash would swallow the closing quote and break
    out of the literal (the CREATE/DROP USER mirror SQL).
    Backslashes must double FIRST, then quotes."""
    return s.replace("\\", "\\\\").replace("'", "''")


class SQLError(ValueError):
    """User-facing statement error. `code` is the MySQL error number the
    wire server puts in the ERR packet (ref: pkg/errno; 1105 = generic
    ER_UNKNOWN_ERROR, 9005 = ErrRegionUnavailable, 3024 = ER_QUERY_TIMEOUT,
    1317 = ER_QUERY_INTERRUPTED)."""

    def __init__(self, message: str, code: int = 1105):
        super().__init__(message)
        self.code = code


def _show_like(stmt, name: str) -> bool:
    """SHOW ... LIKE 'pattern' filter (MySQL LIKE: % any run, _ one char,
    case-insensitive on identifier-ish names)."""
    pat = getattr(stmt, "pattern", None)
    if not pat:
        return True
    import re

    rx = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            # MySQL LIKE escape: \% \_ \\ match the literal character
            rx.append(re.escape(pat[i + 1]))
            i += 2
            continue
        rx.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return re.fullmatch("".join(rx), name, re.I) is not None


def _referenced_tables(stmt) -> set:
    """Table names referenced anywhere in a statement (conservative walk:
    CTE names that shadow real catalog tables still show up and still get
    checked — the CTE body may read the real table; names that match no
    catalog table are skipped by the caller)."""
    names: set = set()

    def walk(n):
        if isinstance(n, A.TableName):
            if n.db.lower() != "information_schema":
                names.add(n.name.lower())
            return
        if not hasattr(n, "__dataclass_fields__"):
            return
        for f_ in n.__dataclass_fields__:
            v = getattr(n, f_)
            for it in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(it, tuple):
                    for x in it:
                        if hasattr(x, "__dataclass_fields__"):
                            walk(x)
                elif hasattr(it, "__dataclass_fields__"):
                    walk(it)

    walk(stmt)
    return names


class Session:
    """One client session over an embedded store. Multiple sessions may
    share a store+catalog (pass them in) — the testkit pattern
    (ref: pkg/testkit TestKit over a shared mockstore)."""

    def __init__(self, store: TPUStore | None = None, catalog: Catalog | None = None, config=None,
                 device="cuda", mesh_devices=None):
        from ..config import Config
        from . import builtins_host
        from .sysvar import SysVarStore

        # module-level because extension builtins receive plain values; a
        # fresh session must not inherit a previous session's SET
        builtins_host.BLOCK_ENCRYPTION_MODE = "aes-128-ecb"
        # a new store lives on `device`: "cuda" unless the caller asks for
        # the CPU (it raises without CUDA, as runtime.resolve_device does);
        # its mesh tier shards over `mesh_devices` (runtime.mesh_devices)
        self.store = store or TPUStore(device=device, mesh_devices=mesh_devices)
        if catalog is None and store is not None:
            # reopening an existing store: recover the schema from the
            # m-prefix keyspace (ref: domain.go:1131 infoschema reload)
            from .meta import load_catalog

            catalog = load_catalog(store)
        self.catalog = catalog or Catalog()
        self.txn: TxnState | None = None
        self.sysvars = SysVarStore()
        self.user_vars: dict[str, object] = {}
        self.user = "root"  # authenticated user (the server sets this)
        self.db = "test"  # current database (USE switches; catalog keys
        # for non-default databases are "db.table")
        self._bootstrap_mysql_schema()
        self.prepared: dict[str, object] = {}  # PREPARE name -> template record
        self._explain_sink: list | None = None  # EXPLAIN ANALYZE summaries
        # --- production front door -------------------------
        self._stmt_probe = None  # plan-cache probe for the current top stmt
        self._last_sql = ""  # raw text of the current top statement
        self._last_plan_cache = None  # (status, reason, tier) of last consult
        self._record_digest = None  # (norm, digest) the stmt log records under
        self._bindings_rev = 0  # session-binding revision (plan-cache key part)
        # --- cross-session fused execution -----------------
        self._coalesce_hint = False  # set around plan-cache-hit point gets
        self._text_serve_type = "select"  # stmt kind of the last text-serve hit
        if config is not None:
            # instance config seeds session sysvars (ref: setGlobalVars
            # bridging config -> sysvar defaults, cmd/tidb-server/main.go:654)
            self.sysvars.set("tidb_distsql_scan_concurrency", str(config.distsql_scan_concurrency))
            self.sysvars.set("tidb_mem_quota_query", str(config.mem_quota_query))
            self.sysvars.set("tidb_mem_quota_session", str(config.mem_quota_session))
            # admission control onto the store's gate
            gate = getattr(self.store, "admission", None)
            if gate is not None:
                gate.configure(
                    max_inflight=config.admission_max_inflight,
                    session_queue=config.admission_session_queue,
                    queue_wait_ms=config.admission_queue_wait_ms,
                    shed_backoff_ms=config.admission_shed_backoff_ms,
                    max_dispatch=config.admission_max_dispatch,
                    cost_classed=config.admission_cost_classed,
                )
            if config.paging_size:
                self.sysvars.set("tidb_enable_paging", "ON")
                self.sysvars.set("tidb_max_chunk_size", str(config.paging_size))
            # cross-session fused execution
            if config.coalesce_enabled:
                self.sysvars.set("tidb_tpu_enable_coalesce", "ON")
            self.sysvars.set("tidb_tpu_coalesce_wait_us", str(config.coalesce_wait_us))
            self.sysvars.set("tidb_tpu_coalesce_max_lanes", str(config.coalesce_max_lanes))
            # PD scheduling knobs onto the store's placement driver
            pd = getattr(self.store, "pd", None)
            if pd is not None:
                pd.conf.tick_interval = config.pd_tick_interval
                pd.conf.max_region_size = config.pd_max_region_size
                pd.conf.max_region_keys = config.pd_max_region_keys

    # the writable slice of the mysql schema (ref: session/bootstrap.go:768
    # doDDLWorks — the full bootstrap creates ~40 tables; these are the
    # ones DML actually targets: pushdown/optimizer blacklists, bindings,
    # stats metadata, GC state)
    _MYSQL_BOOTSTRAP = [
        "CREATE TABLE IF NOT EXISTS `mysql.expr_pushdown_blacklist` (name VARCHAR(100) NOT NULL, store_type VARCHAR(100) NOT NULL DEFAULT 'tikv,tiflash,tidb', reason VARCHAR(200))",
        "CREATE TABLE IF NOT EXISTS `mysql.opt_rule_blacklist` (name VARCHAR(100) NOT NULL)",
        "CREATE TABLE IF NOT EXISTS `mysql.bind_info` (original_sql TEXT, bind_sql TEXT, default_db TEXT, status TEXT, create_time DATETIME, update_time DATETIME, charset TEXT, collation TEXT, source VARCHAR(10), sql_digest VARCHAR(64), plan_digest VARCHAR(64))",
        "CREATE TABLE IF NOT EXISTS `mysql.stats_meta` (version BIGINT NOT NULL, table_id BIGINT NOT NULL, modify_count BIGINT NOT NULL DEFAULT 0, count BIGINT NOT NULL DEFAULT 0, snapshot BIGINT NOT NULL DEFAULT 0)",
        "CREATE TABLE IF NOT EXISTS `mysql.tidb` (variable_name VARCHAR(64) NOT NULL, variable_value VARCHAR(1024) DEFAULT NULL, comment VARCHAR(1024))",
        "CREATE TABLE IF NOT EXISTS `mysql.global_variables` (variable_name VARCHAR(64) NOT NULL, variable_value VARCHAR(16383) DEFAULT NULL)",
        # account tables (ref: bootstrap.go CreateUserTable/CreateDBPrivTable
        # and friends); CREATE USER/GRANT mirror rows in via privilege.py
        "CREATE TABLE IF NOT EXISTS `mysql.user` (Host CHAR(255), User CHAR(32), authentication_string TEXT, plugin CHAR(64), Select_priv CHAR(1) DEFAULT 'N', Insert_priv CHAR(1) DEFAULT 'N', Update_priv CHAR(1) DEFAULT 'N', Delete_priv CHAR(1) DEFAULT 'N', Create_priv CHAR(1) DEFAULT 'N', Drop_priv CHAR(1) DEFAULT 'N', Grant_priv CHAR(1) DEFAULT 'N', Super_priv CHAR(1) DEFAULT 'N', account_locked CHAR(1) DEFAULT 'N')",
        "CREATE TABLE IF NOT EXISTS `mysql.db` (Host CHAR(255), DB CHAR(64), User CHAR(32), Select_priv CHAR(1) DEFAULT 'N', Insert_priv CHAR(1) DEFAULT 'N', Update_priv CHAR(1) DEFAULT 'N', Delete_priv CHAR(1) DEFAULT 'N', Create_priv CHAR(1) DEFAULT 'N', Drop_priv CHAR(1) DEFAULT 'N')",
        "CREATE TABLE IF NOT EXISTS `mysql.tables_priv` (Host CHAR(255), DB CHAR(64), User CHAR(32), Table_name CHAR(64), Grantor CHAR(128), Table_priv TEXT, Column_priv TEXT)",
        "CREATE TABLE IF NOT EXISTS `mysql.gc_delete_range` (job_id BIGINT NOT NULL, element_id BIGINT NOT NULL, start_key VARCHAR(255), end_key VARCHAR(255), ts BIGINT)",
        "CREATE TABLE IF NOT EXISTS `mysql.analyze_jobs` (id BIGINT, table_schema CHAR(64), table_name CHAR(64), job_info TEXT, start_time DATETIME, end_time DATETIME, state VARCHAR(15))",
        "CREATE TABLE IF NOT EXISTS `mysql.stats_histograms` (table_id BIGINT NOT NULL, is_index TINYINT NOT NULL, hist_id BIGINT NOT NULL, distinct_count BIGINT NOT NULL, null_count BIGINT DEFAULT 0, version BIGINT DEFAULT 0)",
        "CREATE TABLE IF NOT EXISTS `mysql.stats_buckets` (table_id BIGINT NOT NULL, is_index TINYINT NOT NULL, hist_id BIGINT NOT NULL, bucket_id BIGINT NOT NULL, count BIGINT NOT NULL, repeats BIGINT NOT NULL, upper_bound TEXT, lower_bound TEXT)",
    ]

    def _bootstrap_mysql_schema(self) -> None:
        if getattr(self.catalog, "_mysql_bootstrapped", False):
            return
        self.catalog._mysql_bootstrapped = True
        for ddl in self._MYSQL_BOOTSTRAP:
            try:
                self.execute_stmt(parse_one(ddl))
            except Exception:  # noqa: BLE001 — one bad table must not
                pass  # block login or the remaining bootstrap tables

    # ------------------------------------------------ plan bindings
    def _binding(self, stmt: A.BindingStmt) -> Result:
        """CREATE/DROP [GLOBAL|SESSION] BINDING (ref: pkg/bindinfo
        binding.go; match-at-optimize pkg/planner/optimize.go:135). The
        digest is literal-masked and structural — the same statement shape
        with different constants matches, like the reference's normalized
        SQL digest."""
        digest = ast_digest(stmt.target)
        store = self.catalog.bindings if stmt.scope == "global" else self._session_bindings()
        if stmt.action == "drop":
            store.pop(digest, None)
            # binding changes re-key/invalidate cached plans
            if stmt.scope == "global":
                self.catalog.bindings_rev += 1
            else:
                self._bindings_rev += 1
            if stmt.scope == "global":
                try:
                    self.execute(
                        "delete from mysql.bind_info where sql_digest = "
                        f"'{digest}'"
                    )
                except SQLError:
                    pass
            return Result()
        if type(stmt.hinted) is not type(stmt.target):
            raise SQLError("binding: the USING statement must match the bound statement's type")
        if ast_digest(stmt.hinted) != digest:
            raise SQLError("binding: the USING statement differs structurally from the bound one")
        store[digest] = {
            "original": stmt.target_sql, "bind": stmt.hinted_sql,
            "ast": stmt.hinted, "scope": stmt.scope, "db": self.db,
        }
        if stmt.scope == "global":
            self.catalog.bindings_rev += 1
        else:
            self._bindings_rev += 1
        if stmt.scope == "global":
            try:
                # same escape contract as the user mirror: backslashes
                # must double BEFORE quotes or a trailing \ breaks out of
                # the literal and the binding silently fails to mirror
                o = _sql_str_escape(stmt.target_sql)
                b = _sql_str_escape(stmt.hinted_sql)
                self.execute(
                    "insert into mysql.bind_info (original_sql, bind_sql, default_db, "
                    f"status, source, sql_digest) values ('{o}', '{b}', '{self.db}', "
                    f"'enabled', 'manual', '{digest}')"
                )
            except SQLError:
                pass
        return Result()

    def _session_bindings(self) -> dict:
        if not hasattr(self, "_bindings"):
            self._bindings = {}
        return self._bindings

    def _match_binding(self, stmt):
        """Graft a matching binding's HINTS onto the incoming statement —
        never its literals: the digest is literal-masked, so the incoming
        query keeps its own constants and only the optimizer directives
        transfer (ref: bindinfo BindSQL = normalized SQL + hint set).
        Returns the (mutated) statement or None."""
        if not isinstance(stmt, A.SelectStmt):
            return None
        digest = ast_digest(stmt)
        rec = self._session_bindings().get(digest) or self.catalog.bindings.get(digest)
        if rec is None or not isinstance(rec["ast"], A.SelectStmt):
            return None
        stmt.hints = list(rec["ast"].hints)
        return stmt

    def _runaway_checker(self):
        """Per-statement RunawayChecker from max_execution_time (ms, 0 =
        unlimited) — the BeforeCopRequest hook the dispatch loop consults
        (ref: resourcegroup/runaway checker.go:27). Stored on the session
        so KILL QUERY from another session can flip its kill flag."""
        from ..distsql.runaway import RunawayChecker

        c = RunawayChecker(self.sysvars.get_int("max_execution_time"))
        self._active_checker = c
        return c

    def kill_query(self):
        """KILL QUERY analog: abort the statement at its next dispatch
        boundary (ref: server kill handling -> sessVars.Killed)."""
        c = getattr(self, "_active_checker", None)
        if c is not None:
            c.kill()

    def _next_ts(self) -> int:
        return self.store.next_ts()

    def _read_ts(self) -> int:
        """Snapshot ts: the open txn's start_ts (repeatable read), else
        the tidb_snapshot stale-read ts when set (ref: sessiontxn/staleread
        — reads rewind to a historical version), else a fresh TSO tick."""
        if self.txn is not None:
            return self.txn.start_ts
        snap = self.sysvars.get("tidb_snapshot")
        if snap:
            ts = int(snap)
            if ts <= getattr(self.store, "gc_safepoint", -1):
                # ref: TiDB "snapshot is older than GC safe point" — GC may
                # have collected the versions this read would need
                raise SQLError(
                    f"snapshot {ts} is older than GC safe point {self.store.gc_safepoint}"
                )
            return ts
        return self.store.next_ts()

    def _read_engines(self) -> tuple:
        """tidb_isolation_read_engines as a normalized tuple (the sysvar
        validator already rejected unknown names and folded the reference
        aliases). In-transaction reads and EXPLAIN ANALYZE runs strip the
        columnar replica: a txn must see its own snapshot/buffer on the
        authoritative row store, and ANALYZE wants the per-region summary
        attribution only the cop path produces (ref: TiDB routing
        in-transaction reads to TiKV regardless of the engine list)."""
        engines = tuple(self.sysvars.get("tidb_isolation_read_engines").split(","))
        if self.txn is not None or self._explain_sink is not None:
            engines = tuple(e for e in engines if e != "columnar") or ("tpu",)
        return engines

    def _pin_read_ts(self) -> int:
        """_read_ts, registered against GC for the statement's duration so a
        background run_gc tick cannot collect the version this read is
        looking at mid-statement (ref: gc_worker.go
        calcSafePointByMinStartTS — the safepoint honors every active
        operation, not only explicit txns). Pair with _unpin_read_ts."""
        ts = self._read_ts()
        if self.txn is None:
            self.store.register_snapshot(ts)
        return ts

    def _unpin_read_ts(self, ts: int) -> None:
        if self.txn is None or self.txn.start_ts != ts:
            self.store.unregister_snapshot(ts)

    # ---------------------------------------------------------------- txn
    def _begin(self, explicit: bool = True):
        if self.sysvars.get("tidb_snapshot"):
            # ref: TiDB rejects BEGIN in stale-read mode rather than let a
            # fresh txn ts silently override the historical snapshot
            raise SQLError("can not execute BEGIN when 'tidb_snapshot' is set")
        self.txn = TxnState(
            start_ts=self.store.next_ts(),
            mode=self.sysvars.get("tidb_txn_mode") or "pessimistic",
            explicit=explicit,
            schema_ver=self.catalog.version,
        )
        from ..util import metrics

        metrics.OPEN_TXNS.inc()
        # pin the snapshot against GC for the txn's lifetime
        self.store.register_snapshot(self.txn.start_ts)

    def _commit(self):
        from ..store.txn import TxnError

        txn, self.txn = self.txn, None
        if txn is None:
            return
        from ..util import metrics

        metrics.OPEN_TXNS.dec()
        self.store.unregister_snapshot(txn.start_ts)
        if not txn.mutations:
            self.store.txn.release_all(txn.start_ts)
            return
        if txn.schema_ver != self.catalog.version:
            # concurrent DDL: buffered mutations were computed against an
            # older schema (e.g. without a newly-built index) — committing
            # would corrupt it (ref: TiDB "Information schema is changed")
            self.store.txn.release_all(txn.start_ts)
            raise SQLError(
                "Information schema is changed during the execution of the statement "
                "(schema version moved from "
                f"{txn.schema_ver} to {self.catalog.version}) — transaction aborted"
            )
        try:
            # commit_ts is allocated INSIDE the engine's critical section:
            # TSO monotonicity then guarantees no reader can hold a
            # read_ts >= commit_ts before the apply completes
            if self._coalesce_commit(txn) is None:
                self.store.txn.commit_txn(txn.mutations, txn.start_ts, self.store.next_ts)
        except TxnError as exc:
            self.store.txn.release_all(txn.start_ts)
            raise SQLError(str(exc)) from exc
        except QuorumLostError:
            # a quorum-lost region refused the commit before anything
            # applied: drop the locks and let execute() map it to 9005
            self.store.txn.release_all(txn.start_ts)
            raise
        # non-mutated pessimistic locks (SELECT FOR UPDATE) release now
        self.store.txn.release_all(txn.start_ts)
        # planner row-count stats apply only once the txn is durable
        for tid, delta in txn.row_delta.items():
            meta = self.catalog.table_by_id(tid)
            if meta is not None:
                meta.row_count = max(meta.row_count + delta, 0)

    def _coalesce_commit(self, txn):
        """Group-commit window for autocommit single-statement writes
       : park the mutations in the store's coalescer so
        concurrent sessions' commits ship as ONE quorum proposal per
        (region, window), each lane at its own commit ts. Returns the
        commit_ts, or None when this commit must take (or fell back to)
        the canonical single path — a conflict inside the window releases
        the lane's locks, so retrying via commit_txn re-stages them and
        reproduces the exact single-session error surface."""
        coalescer = getattr(self.store, "coalescer", None)
        if (
            coalescer is None
            or txn.explicit
            or txn.locked
            or not self.sysvars.get_bool("tidb_tpu_enable_coalesce")
            or len(txn.mutations)
            > self.sysvars.get_int("tidb_tpu_coalesce_max_write_keys")
        ):
            return None
        return coalescer.group_commit(
            txn.mutations, txn.start_ts,
            tag=topsql.current_tag(),
            wait_us=self.sysvars.get_int("tidb_tpu_coalesce_wait_us"),
            max_lanes=self.sysvars.get_int("tidb_tpu_coalesce_max_lanes"),
        )

    def _rollback(self):
        txn, self.txn = self.txn, None
        if txn is not None:
            from ..util import metrics

            metrics.OPEN_TXNS.dec()
            self.store.unregister_snapshot(txn.start_ts)
            self.store.txn.release_all(txn.start_ts)

    def _autocommit_dml(self, fn):
        """Run a DML statement inside the open txn (with a statement
        savepoint: a failed statement buffers nothing), or wrap it in an
        implicit single-statement txn (autocommit -> immediate 2PC)."""
        if self.sysvars.get("tidb_snapshot"):
            # ref: sessiontxn/staleread — a historical read session is
            # read-only until tidb_snapshot is cleared
            raise SQLError("can not execute write statement when 'tidb_snapshot' is set")
        if self.txn is not None:
            sp = self.txn.savepoint()
            try:
                return fn()
            except Exception:
                self.txn.restore(sp)
                raise
        self._begin(explicit=False)
        try:
            res = fn()
        except Exception:
            self._rollback()
            raise
        self._commit()
        return res

    def _implicit_commit(self):
        """DDL commits any open transaction first (MySQL semantics); a
        stale-read session (tidb_snapshot set) is read-only — DDL is
        rejected like DML (ref: sessiontxn/staleread restrictions)."""
        if self.sysvars.get("tidb_snapshot"):
            raise SQLError("can not execute DDL when 'tidb_snapshot' is set")
        if self.txn is not None:
            self._commit()

    def _lock_rows(self, meta: TableMeta, handles):
        """Pessimistic intention locks at DML/SELECT-FOR-UPDATE time
        (explicit pessimistic txns only; autocommit statements commit
        immediately so prewrite conflict checks suffice). Partitioned
        tables lock the handle's key in EVERY partition — over-locking is
        sound, and the row's partition is value-dependent."""
        from ..store.txn import TxnError

        if self.txn is None or not self.txn.explicit or self.txn.mode != "pessimistic":
            return
        keys = [
            tablecodec.encode_row_key(pid, h)
            for h in handles
            for pid in meta.physical_ids()
        ]
        if not keys:
            return
        # conflict bound = the txn's snapshot ts: a commit that landed after
        # our snapshot means this statement computed against stale rows —
        # fail with a retryable conflict instead of losing the update.
        # (TiDB instead re-reads at for_update_ts; stricter is still sound.)
        try:
            self.store.txn.acquire_pessimistic(keys, keys[0], self.txn.start_ts, self.txn.start_ts)
        except TxnError as exc:
            raise SQLError(str(exc)) from exc
        self.txn.locked |= set(keys)

    # ------------------------------------------------- buffered write path
    # row_ops stays keyed by the LOGICAL table id (handles are unique
    # across partitions — one shared allocator); only the kv key routes
    # to the row's physical partition (ref: tablecodec keys carry the
    # PartitionDefinition.ID for partitioned tables)
    def _buf_put_row(self, meta: TableMeta, handle: int, datums: list):
        key = tablecodec.encode_row_key(meta.pid_for_row(datums), handle)
        self.txn.mutations[key] = self.store._row_encoder.encode(meta.col_ids(), datums)
        self.txn.row_ops.setdefault(meta.table_id, {})[handle] = list(datums)

    def _buf_delete_row(self, meta: TableMeta, handle: int, row: list | None = None):
        pid = meta.pid_for_row(row) if (meta.partition is not None and row is not None) else meta.table_id
        if meta.partition is not None and row is None:
            # partition unknown: tombstone the handle in every partition
            for p in meta.physical_ids():
                self.txn.mutations[tablecodec.encode_row_key(p, handle)] = None
        else:
            self.txn.mutations[tablecodec.encode_row_key(pid, handle)] = None
        self.txn.row_ops.setdefault(meta.table_id, {})[handle] = None

    # ------------------------------------------------------------------
    def execute(self, sql: str) -> Result:
        """Parse + execute one statement through the admission gate,
        feeding the slow-query log and statement summary (ref:
        ExecStmt.Exec wrapping + LogSlowQuery, adapter.go:458/1580;
        pkg/util/stmtsummary Add). ONE lexer pass up front builds the
        plan-cache probe AND the normalized digest the statement log
        reuses — the hot path lexes once."""
        import time as _time
        from contextlib import nullcontext

        from ..util import metrics, tracing
        from .plancache import StmtProbe, stmt_kind_reason

        t0 = _time.perf_counter()
        c0 = _time.thread_time()
        self._last_plan_digest = ""
        stmt_type = "invalid"
        probe = StmtProbe.from_sql(sql)
        saved = (self._stmt_probe, self._last_sql, self._record_digest)
        self._stmt_probe, self._last_sql = probe, sql
        self._record_digest = (probe.normalized, probe.digest) if probe else None
        # Top SQL resource tag: ONE per statement, riding the probe's
        # literal-masked digest from the same lexer pass — every layer
        # below (dispatch workers, store, Backoffer, admission queue)
        # attributes into it ambiently
        tag = None
        if probe is not None and self.sysvars.get_bool("tidb_enable_top_sql"):
            tag = topsql.ResourceTag(probe.digest, sample_sql=sql[:256])
        tag_token = topsql.activate(tag)
        gate = getattr(self.store, "admission", None)
        try:
            try:
                # admission gate: saturated servers shed HERE, before any
                # parse/plan/dispatch work happens (typed ServerIsBusy).
                # The digest rides along: cost-classed mode weighs the
                # statement by its measured class
                with (gate.admit(id(self), digest=probe.digest if probe is not None else None)
                      if gate is not None else nullcontext()):
                    res = self._plan_cache_text_serve(probe)
                    if res is not None:
                        # parse-free hit: the digest-keyed entry served the
                        # statement with literal values bound straight from
                        # the lexer's masked tokens — no parse, no plan
                        # ("select", or "update"/"delete" for the pointwrite
                        # tier)
                        stmt_type = self._text_serve_type
                    else:
                        with tracing.span("session.parse", sql=sql[:256]):
                            stmt = parse_one(sql)
                        stmt_type = type(stmt).__name__.removesuffix("Stmt").lower()
                        if isinstance(stmt, A.ExplainStmt):
                            # the cache probe of EXPLAIN [ANALYZE] <stmt> is
                            # the INNER statement's — it shares entries with
                            # its direct form (satellite: attributable rows)
                            self._stmt_probe = StmtProbe.inner_probe(sql, "explain")
                        elif isinstance(stmt, A.TraceStmt):
                            self._stmt_probe = StmtProbe.inner_probe(sql, "trace")
                        elif (probe is not None
                              and not isinstance(stmt, (A.PrepareStmt, A.ExecuteStmt,
                                                        A.DeallocateStmt))):
                            reason = stmt_kind_reason(stmt)
                            if reason is not None:
                                # the probe belongs to THIS statement's text:
                                # a non-SELECT kind must drop it before any
                                # nested _run_select (INSERT..SELECT, CREATE
                                # VIEW) could install the inner select under
                                # the OUTER statement's digest — a later
                                # digest-equal statement would then serve
                                # rows instead of running the DML
                                self._stmt_probe = None
                                if self.sysvars.get_bool("tidb_enable_plan_cache"):
                                    metrics.PLAN_CACHE_DECLINES.labels(reason).inc()
                                    self._last_plan_cache = ("decline", reason, "")
                        res = self.execute_stmt(stmt)
            except Exception as exc:
                from ..distsql.dispatch import CopInternalError, RegionUnavailableError
                from ..distsql.runaway import QueryKilledError
                from ..server.admission import AdmissionShed

                metrics.STATEMENTS.labels(stmt_type, "error").inc()
                self._record_stmt(sql, (_time.perf_counter() - t0) * 1e3, 0, False, str(exc),
                                  cpu_ms=(_time.thread_time() - c0) * 1e3)
                if isinstance(exc, AdmissionShed):
                    # shed at the front door: MySQL 9003 "TiKV server busy"
                    # with the suggested wait riding the wire-format message,
                    # so clients classify via parse_region_error and retry on
                    # the existing server_busy Backoffer budget
                    err = SQLError(str(exc), code=9003)
                    err.backoff_ms = exc.backoff_ms
                    raise err from exc
                if isinstance(exc, QueryKilledError):
                    # 3024 ER_QUERY_TIMEOUT (deadline) vs 1317 ER_QUERY_INTERRUPTED
                    # (KILL QUERY) — same split the reference makes
                    code = 3024 if getattr(exc, "timeout", False) else 1317
                    raise SQLError(str(exc), code=code) from exc
                if isinstance(exc, RegionUnavailableError):
                    # every backoff budget spent / every store unhealthy:
                    # MySQL 9005 (ref: errno.ErrRegionUnavailable), not a bare
                    # RuntimeError that reads like an engine bug
                    raise SQLError(f"Region is unavailable: {exc}", code=9005) from exc
                if isinstance(exc, QuorumLostError):
                    # a write refused on quorum loss:
                    # the same 9005 the read path's exhausted budgets surface
                    raise SQLError(f"Region is unavailable: {exc}", code=9005) from exc
                if isinstance(exc, CopInternalError):
                    raise SQLError(str(exc), code=1105) from exc
                raise
            metrics.STATEMENTS.labels(stmt_type, "ok").inc()
            rows = len(res.rows) if getattr(res, "rows", None) else getattr(res, "affected", 0)
            self._record_stmt(sql, (_time.perf_counter() - t0) * 1e3, rows, True,
                              cpu_ms=(_time.thread_time() - c0) * 1e3)
            return res
        finally:
            self._stmt_probe, self._last_sql, self._record_digest = saved
            topsql.deactivate(tag_token)

    def _record_stmt(self, sql: str, dur_ms: float, rows: int, ok: bool, err: str = "", cpu_ms: float = 0.0):
        try:

            # flush the statement's resource tag: host CPU lands here (the
            # exact thread_time delta — parse+plan+dispatch), the sinks
            # already accumulated device/compile/backoff/queue; EXECUTE
            # re-points the digest at the UNDERLYING prepared statement
            # (same join the stmt log makes via _record_digest)
            attr = None
            tag = topsql.current_tag()
            if tag is not None:
                rd = getattr(self, "_record_digest", None)
                if rd is not None:
                    tag.sql_digest = rd[1]
                pd_ = getattr(self, "_last_plan_digest", "")
                if pd_:
                    tag.plan_digest = pd_
                attr = tag.finish(int(cpu_ms * 1e6))
                pc = getattr(self, "_last_plan_cache", None)
                topsql.COLLECTOR.record_statement(
                    attr, success=ok,
                    plan_cache_hit=bool(pc and pc[0] == "hit"))
            thr = None
            if self.sysvars.get_bool("tidb_enable_slow_log"):
                t = self.sysvars.get_int("tidb_slow_log_threshold")
                thr = float(t) if t >= 0 else None
            self.catalog.stmtlog.record(
                sql, dur_ms, rows, ok, err,
                slow_threshold_ms=thr,
                summary_enabled=self.sysvars.get_bool("tidb_enable_stmt_summary"),
                cpu_ms=cpu_ms,
                plan_digest=getattr(self, "_last_plan_digest", ""),
                # EXECUTE records under the UNDERLYING prepared statement's
                # digest (set by _execute_prepared), joining its summary row
                # instead of orphaning on the "EXECUTE s" shape; direct
                # statements reuse the probe's digest — one lex per stmt
                norm_digest=getattr(self, "_record_digest", None),
                attr=attr,
            )
        except Exception:  # noqa: BLE001 — observability must never fail a query
            pass

    def execute_stmt(self, stmt) -> Result:
        self._qualify_tables(stmt)
        self._check_privileges(stmt)
        if isinstance(stmt, (A.SelectStmt, A.SetOprStmt, A.UpdateStmt, A.DeleteStmt, A.InsertStmt)):
            self._substitute_vars(stmt)
        if isinstance(stmt, A.SelectStmt):
            bound = self._match_binding(stmt)
            if bound is not None:
                stmt = bound  # same statement, binding hints grafted on
        if isinstance(stmt, A.PrepareStmt):
            # validate now; EXECUTE deep-copies the template per run (the
            # rewrite passes mutate ASTs; ref: plan_cache.go prepared-stmt
            # cache). The text + probe ride along so EXECUTE shares the
            # plan-cache entries and summary row of the DIRECT statement:
            # the prepared text normalizes with '?' markers exactly where
            # literals mask
            from .plancache import StmtProbe

            self.prepared[stmt.name.lower()] = {
                "ast": parse_one(stmt.sql), "sql": stmt.sql,
                "probe": StmtProbe.from_sql(stmt.sql),
            }
            return Result()
        if isinstance(stmt, A.ExecuteStmt):
            return self._execute_prepared(stmt)
        if isinstance(stmt, A.DeallocateStmt):
            if self.prepared.pop(stmt.name.lower(), None) is None:
                raise SQLError(f"unknown prepared statement {stmt.name!r}")
            return Result()
        if isinstance(stmt, A.CreateUserStmt):
            from .privilege import PrivilegeError

            try:
                for name, host, pw in stmt.users:
                    self.catalog.privileges.create_user(name, host, pw, stmt.if_not_exists)
                    # mirror into mysql.user (ref: bootstrap.go + executor
                    # simple.go executeCreateUser writes the row directly);
                    # delete-then-insert keeps IF NOT EXISTS re-runs at one
                    # row, and quotes in names must be SQL-escaped
                    ne, he = _sql_str_escape(name), _sql_str_escape(host)
                    try:
                        self.execute(
                            f"delete from `mysql.user` where User = '{ne}' and Host = '{he}'"
                        )
                        self.execute(
                            "insert into `mysql.user` (Host, User, authentication_string, plugin) "
                            f"values ('{he}', '{ne}', '', 'mysql_native_password')"
                        )
                    except SQLError:
                        pass
            except PrivilegeError as exc:
                raise SQLError(str(exc)) from exc
            return Result()
        if isinstance(stmt, A.DropUserStmt):
            from .privilege import PrivilegeError

            try:
                for name, host in stmt.users:
                    self.catalog.privileges.drop_user(name, host, stmt.if_exists)
                    ne, he = _sql_str_escape(name), _sql_str_escape(host)
                    try:
                        self.execute(
                            f"delete from `mysql.user` where User = '{ne}' and Host = '{he}'"
                        )
                    except SQLError:
                        pass
            except PrivilegeError as exc:
                raise SQLError(str(exc)) from exc
            return Result()
        if isinstance(stmt, (A.GrantStmt, A.RevokeStmt)):
            from .privilege import PrivilegeError

            op = self.catalog.privileges.revoke if isinstance(stmt, A.RevokeStmt) else self.catalog.privileges.grant
            try:
                for name, host in stmt.users:
                    op(stmt.privs, stmt.db, stmt.table, name, host)
            except PrivilegeError as exc:
                raise SQLError(str(exc)) from exc
            return Result()
        if isinstance(stmt, A.SelectStmt):
            return self._select(stmt)
        if isinstance(stmt, A.SetOprStmt):
            names, fts, rows = self._set_opr(stmt, None)
            return Result(columns=names, rows=self._apply_select_limit(stmt, rows), fts=fts)
        if isinstance(stmt, A.CreateTableStmt):
            self._implicit_commit()
            self.catalog.create_table(stmt)
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.DropTableStmt):
            self._implicit_commit()
            for t in stmt.tables:
                self.catalog.drop_table(t.name, stmt.if_exists)
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.CreateViewStmt):
            self._implicit_commit()
            if not stmt.source:
                raise SQLError("CREATE VIEW requires a SELECT body")
            # validate: the body must plan against the current schema, and
            # an explicit column list must match the select-list arity
            # (ref: ddl CreateView checking the underlying plan). Plan-only
            # when possible — MySQL validates without executing; bodies the
            # bare planner can't take (views/CTEs/subqueries inside) fall
            # back to executing a LIMIT-0 wrapper.
            names = None
            body = parse_one(stmt.source)
            self._qualify_tables(body)  # validation under the CURRENT db
            if isinstance(body, A.SelectStmt):
                try:
                    from .planner import plan_select

                    names = plan_select(body, self.catalog).column_names
                except Exception:  # noqa: BLE001 — rewriter-dependent body
                    names = None
            if names is None:
                inner = parse_one(stmt.source)
                self._qualify_tables(inner)
                if getattr(inner, "limit", None) is None:
                    inner.limit = A.Limit(A.Literal(0, "int"))
                names, _, _ = self._run_select(inner, None) if isinstance(inner, A.SelectStmt) \
                    else self._set_opr(inner, None)
            if stmt.columns and len(stmt.columns) != len(names):
                raise SQLError(
                    f"view column list arity {len(stmt.columns)} != select list {len(names)}"
                )
            self.catalog.create_view(stmt.name.name, stmt.columns, stmt.source, stmt.or_replace)
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.DropViewStmt):
            self._implicit_commit()
            for t in stmt.names:
                self.catalog.drop_view(t.name if hasattr(t, "name") else t, stmt.if_exists)
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.TruncateTableStmt):
            self._implicit_commit()
            r = self._autocommit_dml(lambda: self._truncate(stmt))
            self._persist_schema()
            return r
        if isinstance(stmt, A.InsertStmt):
            return self._autocommit_dml(lambda: self._insert(stmt))
        if isinstance(stmt, A.UpdateStmt):
            return self._run_dml_cached(stmt, self._update)
        if isinstance(stmt, A.DeleteStmt):
            return self._run_dml_cached(stmt, self._delete)
        if isinstance(stmt, A.BeginStmt):
            # BEGIN implicitly commits any open txn (MySQL semantics)
            self._implicit_commit()
            self._begin(explicit=True)
            return Result()
        if isinstance(stmt, A.CommitStmt):
            self._commit()
            return Result()
        if isinstance(stmt, A.SavepointStmt):
            # named savepoints over the statement-savepoint machinery
            # (ref: session savepoint support, pkg/session savepoint ops)
            if stmt.action == "set":
                if self.txn is not None:
                    self.txn.named_savepoints[stmt.name] = self.txn.savepoint()
            elif stmt.action == "rollback":
                if self.txn is None or stmt.name not in self.txn.named_savepoints:
                    raise SQLError(f"SAVEPOINT {stmt.name} does not exist")
                sp = self.txn.named_savepoints[stmt.name]
                self.txn.restore(sp)
            else:  # release
                if self.txn is None or stmt.name not in self.txn.named_savepoints:
                    raise SQLError(f"SAVEPOINT {stmt.name} does not exist")
                del self.txn.named_savepoints[stmt.name]
            return Result()
        if isinstance(stmt, A.RollbackStmt):
            self._rollback()
            return Result()
        if isinstance(stmt, A.SetStmt):
            from .sysvar import SysVarError

            for scope, name, val in stmt.assignments:
                if not isinstance(val, A.Literal):
                    continue
                if name == "__set_names__":
                    # SET NAMES cs [COLLATE c] (ref: pkg/executor/set.go
                    # setCharset): client/connection/results take cs;
                    # collation_connection takes the explicit COLLATE, the
                    # default_collation_for_utf8mb4 override, or the
                    # charset default (TiDB: *_bin for utf8/utf8mb4,
                    # collate.GetDefaultCollation)
                    cs, _, coll = str(val.value).partition("|")
                    if not coll:
                        if cs == "utf8mb4":
                            try:
                                coll = self.sysvars.get("default_collation_for_utf8mb4")
                            except Exception:
                                coll = ""
                        coll = coll or {
                            "utf8mb4": "utf8mb4_bin", "utf8": "utf8_bin",
                            "gbk": "gbk_chinese_ci",
                            "gb18030": "gb18030_chinese_ci",
                            "latin1": "latin1_bin", "ascii": "ascii_bin",
                            "binary": "binary",
                        }.get(cs, cs + "_bin")
                    for v in ("character_set_client", "character_set_connection",
                              "character_set_results"):
                        self.sysvars.set(v, cs)
                    self.sysvars.set("collation_connection", coll)
                    continue
                if scope == "user":
                    self.user_vars[name.lower()] = str(val.value)
                else:
                    if name.lower() == "tidb_snapshot" and self.txn is not None:
                        # ref: TiDB rejects flipping stale-read mode inside
                        # an open txn (it would take effect only at COMMIT)
                        raise SQLError(
                            "can not set 'tidb_snapshot' inside a transaction"
                        )
                    try:
                        self.sysvars.set(name, str(val.value))
                    except SysVarError as exc:
                        raise SQLError(str(exc)) from exc
                    if name.lower() == "block_encryption_mode":
                        from . import builtins_host

                        builtins_host.BLOCK_ENCRYPTION_MODE = str(val.value)
                    elif name.lower() == "tidb_enable_top_sql":
                        # the collector is process-wide (one ledger per
                        # server, like the reference's single reporter):
                        # the sysvar bridges to it at SET time

                        topsql.COLLECTOR.configure(
                            enabled=self.sysvars.get_bool("tidb_enable_top_sql"))
                    elif name.lower() == "tidb_top_sql_max_statement_count":

                        topsql.COLLECTOR.configure(
                            top_k=self.sysvars.get_int("tidb_top_sql_max_statement_count"))
            return Result()
        if isinstance(stmt, A.UseStmt):
            db = stmt.db.lower()
            if db not in self.catalog.databases and db not in ("information_schema", "mysql"):
                raise SQLError(f"unknown database {db!r}")
            self.db = db
            return Result()
        if isinstance(stmt, A.CreateDatabaseStmt):
            db = stmt.name.lower()
            if db in self.catalog.databases and not stmt.if_not_exists:
                raise SQLError(f"database {db!r} already exists")
            self.catalog.databases.add(db)
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.DropDatabaseStmt):
            db = stmt.name.lower()
            if db not in self.catalog.databases:
                if stmt.if_exists:
                    return Result()
                raise SQLError(f"unknown database {db!r}")
            if db == "test":
                raise SQLError("cannot drop the default database")
            self._implicit_commit()
            for t in [n for n in self.catalog.tables() if n.startswith(db + ".")]:
                self.catalog.drop_table(t)
            with self.catalog._lock:
                for v in [n for n in list(self.catalog.views) if n.startswith(db + ".")]:
                    del self.catalog.views[v]
            self.catalog.databases.discard(db)
            if self.db == db:
                self.db = "test"
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.CreateIndexStmt):
            self._implicit_commit()
            r = self._create_index(stmt)
            self._persist_schema()
            return r
        if isinstance(stmt, A.DropIndexStmt):
            self._implicit_commit()
            r = self._drop_index(stmt)
            self._persist_schema()
            return r
        if isinstance(stmt, A.LoadDataStmt):
            from ..store.txn import TxnError
            from ..tools.lightning import load_data

            self._implicit_commit()
            # the bulk-ingest lock check raises KeyIsLocked when a live
            # 2PC holds a conflicting key — map it like every other txn
            # conflict (vet dataflow-error-escape: this used to reach the
            # client as a raw Python exception)
            try:
                return Result(affected=load_data(self, stmt))
            except TxnError as exc:
                raise SQLError(str(exc)) from exc
        if isinstance(stmt, A.BRIEStmt):
            from ..br import LogGapError, restore_until, start_log_backup, stop_log_backup
            from ..cdc import ChangefeedError
            from ..store.txn import TxnError
            from ..tools import backup, restore

            self._implicit_commit()
            try:
                if stmt.kind == "backup_log":
                    lb = start_log_backup(self.store, self.catalog, stmt.storage)
                    row = [Datum.string(stmt.storage), Datum.string(lb.feed_name),
                           Datum.i64(lb.start_ts)]
                    return Result(columns=["Destination", "Changefeed", "StartTS"],
                                  rows=[row])
                if stmt.kind == "stop_backup_log":
                    stop_log_backup(self.store, stmt.storage)
                    return Result()
                if stmt.kind == "backup":
                    m = backup(self.store, self.catalog, stmt.storage)
                    row = [Datum.string(stmt.storage), Datum.i64(m["total_keys"]), Datum.i64(m["snapshot_ts"])]
                    return Result(columns=["Destination", "Keys", "SnapshotTS"], rows=[row])
                if stmt.until_ts is not None:
                    info = restore_until(self.store, self.catalog, stmt.storage,
                                         stmt.until_ts)
                    row = [Datum.string(stmt.storage), Datum.i64(info["until_ts"]),
                           Datum.i64(info["segments_replayed"]),
                           Datum.i64(info["events_applied"])]
                    return Result(columns=["Source", "UntilTS", "Segments", "Events"],
                                  rows=[row])
                info = restore(self.store, self.catalog, stmt.storage)
                row = [Datum.string(stmt.storage), Datum.i64(info["keys"]), Datum.i64(info["tables"])]
                return Result(columns=["Source", "Keys", "Tables"], rows=[row])
            except (TxnError, LogGapError, ChangefeedError, ValueError) as exc:
                # RESTORE's bulk_ingest hits a held lock, a PITR coverage
                # gap, a duplicate/unknown log backup, a table collision:
                # every failure is a typed SQL error, never a raw Python
                # stack
                raise SQLError(str(exc)) from exc
        if isinstance(stmt, A.AlterTableStmt):
            from .ddl import DDLError, alter_table

            self._implicit_commit()
            try:
                alter_table(self, stmt)
            except DDLError as exc:
                raise SQLError(str(exc)) from exc
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.RenameTableStmt):
            from .ddl import DDLError, _rename_table, run_job

            self._implicit_commit()
            try:
                for old, new in stmt.pairs:
                    meta = self.catalog.table(old.name)
                    new_name = new.name if isinstance(new, A.TableName) else str(new)
                    run_job(self.catalog, "rename table", meta.name,
                            f"RENAME TABLE {old.name} TO {new_name}",
                            lambda m=meta, n=new_name: _rename_table(self.catalog, m, n))
            except DDLError as exc:
                raise SQLError(str(exc)) from exc
            self._persist_schema()
            return Result()
        if isinstance(stmt, A.BindingStmt):
            return self._binding(stmt)
        if isinstance(stmt, A.LoadStatsStmt):
            # LOAD STATS json (ref: pkg/statistics/handle LoadStatsFromJSON):
            # loads the dump when the file exists (a relative path from the
            # working directory); a missing file is tolerated like the
            # reference harness' pre-loaded state
            import os as _os

            p = _os.path.abspath(stmt.path)
            if _os.path.exists(p):
                try:
                    self._load_stats_json(p)
                except Exception as exc:  # noqa: BLE001
                    raise SQLError(f"load stats: {exc}") from exc
            return Result()
        if isinstance(stmt, A.ChangefeedStmt):
            return self._changefeed(stmt)
        if isinstance(stmt, A.AdminStmt):
            return self._admin(stmt)
        if isinstance(stmt, A.AnalyzeTableStmt):
            return self._analyze(stmt)
        if isinstance(stmt, A.ShowStmt):
            return self._show(stmt)
        if isinstance(stmt, A.ExplainStmt):
            return self._explain(stmt)
        if isinstance(stmt, A.TraceStmt):
            return self._trace(stmt)
        raise SQLError(f"statement {type(stmt).__name__} not supported yet")

    def _changefeed(self, stmt: A.ChangefeedStmt) -> Result:
        """CREATE/PAUSE/RESUME/DROP CHANGEFEED (ref: TiCDC's changefeed
        lifecycle, SQL-ified like BACKUP/RESTORE): typed CDC errors
        surface as SQLError."""
        from ..cdc import ChangefeedError, SinkError

        hub = self.store.cdc
        try:
            if stmt.action == "create":
                table_ids = None
                if stmt.tables:
                    ids = set()
                    for t in stmt.tables:
                        try:
                            meta = self.catalog.table(t.name)
                        except CatalogError as exc:
                            raise SQLError(str(exc)) from exc
                        ids.add(meta.table_id)
                        ids.update(meta.physical_ids())
                    table_ids = ids
                unknown = set(stmt.options) - {"start_ts"}
                if unknown:
                    # a typo'd option silently changing behavior is worse
                    # than an error (TiCDC rejects unknown options too)
                    raise SQLError(
                        f"unknown changefeed option(s) {sorted(unknown)}; "
                        f"supported: start_ts")
                raw_ts = stmt.options.get("start_ts", 0)
                if isinstance(raw_ts, bool) or not isinstance(raw_ts, int):
                    # a valueless `WITH start_ts` parses as True; a quoted
                    # value as str — both must be typed errors, not a raw
                    # ValueError escaping the boundary
                    raise SQLError(
                        f"changefeed start_ts must be an integer TSO, got {raw_ts!r}")
                hub.create(stmt.name, stmt.sink_uri, self.catalog,
                           table_ids=table_ids, start_ts=raw_ts)
            elif stmt.action == "pause":
                hub.pause(stmt.name)
            elif stmt.action == "resume":
                hub.resume(stmt.name)
            elif stmt.action == "drop":
                hub.drop(stmt.name)
            else:
                raise SQLError(f"unknown changefeed action {stmt.action!r}")
        except (ChangefeedError, SinkError) as exc:
            raise SQLError(str(exc)) from exc
        return Result()

    def _trace(self, stmt: A.TraceStmt) -> Result:
        """TRACE [FORMAT='row'|'json'] <stmt> (ref: executor/trace.go
        TraceExec + pkg/util/tracing): run the statement on its NORMAL
        execution path under a root span — every layer's instrumentation
        (plan, dispatch, per-region cop tasks, program compile/cache,
        store decode/execute) attaches children — and return the span tree
        as the result set. A failing statement still returns the partial
        tree, with the error recorded on the failing span."""
        from ..util import tracing

        with tracing.trace("session", stmt=type(stmt.target).__name__) as root:
            try:
                with tracing.span("session.execute"):
                    inner = self.execute_stmt(stmt.target)
                root.set("rows", len(inner.rows) if inner.rows else inner.affected)
            except Exception as exc:  # noqa: BLE001 — the tree IS the result
                root.set("error", str(exc))
        if stmt.format == "json":
            return Result(columns=["trace"], rows=[[Datum.string(root.to_json())]])
        rows = [
            [Datum.string(op), Datum.i64(start_us), Datum.i64(dur_us), Datum.string(attrs)]
            for op, start_us, dur_us, attrs in root.rows()
        ]
        return Result(columns=["operation", "start_us", "duration_us", "attrs"], rows=rows)

    @staticmethod
    def _value_literal(val) -> A.Literal:
        """Python value (user var / param) -> literal AST node."""
        if val is None:
            return A.Literal(None, "null")
        s = str(val)
        try:
            return A.Literal(int(s), "int")
        except ValueError:
            return A.Literal(s, "str")

    def _execute_prepared(self, stmt: A.ExecuteStmt) -> Result:
        """EXECUTE name [USING @a, @b]: deep-copy the template, bind
        parameter markers from user variables (ref: executor/prepared.go)."""
        import copy

        rec = self.prepared.get(stmt.name.lower())
        if rec is None:
            raise SQLError(f"unknown prepared statement {stmt.name!r}")
        ast2 = copy.deepcopy(rec["ast"])
        params = [self._value_literal(self.user_vars.get(v.lower())) for v in stmt.using]
        n_used = self._bind_params(ast2, params)
        if n_used != len(params):
            raise SQLError(
                f"prepared statement {stmt.name!r} expects {n_used} parameters, got {len(params)}"
            )
        probe = rec.get("probe")
        if probe is not None:
            # ride the statement summary under the UNDERLYING statement's
            # digest, and — for SELECT templates
            # only — the plan cache too: the bound literals carry their
            # marker token positions, so the slot audit and re-binding
            # work exactly as for the textual form. A prepared DML's
            # nested select must NOT inherit the probe (its digest names
            # the whole DML text, not the inner select).
            self._record_digest = (probe.normalized, probe.digest)
            self._stmt_probe = probe if isinstance(ast2, A.SelectStmt) else None
        return self.execute_stmt(ast2)

    def _bind_params(self, node, params: list) -> int:
        """Replace ParamMarker nodes with the bound literals; returns the
        number of markers seen."""
        seen = [0]

        def sub(x):
            if isinstance(x, A.ParamMarker):
                # markers carry their LEXICAL position (parser assigns it),
                # which is the binding order MySQL uses — field traversal
                # order here may differ (e.g. Limit stores count before
                # offset). The bound literal inherits the marker's token
                # offset so the plan cache's slot collection sees it.
                seen[0] = max(seen[0], x.index + 1)
                if x.index >= len(params):
                    return A.Literal(None, "null", pos=x.pos)
                v = params[x.index]
                return A.Literal(v.value, v.kind, pos=x.pos)
            return None

        def walk_seq(v):
            for i, it in enumerate(v):
                if isinstance(it, A.ParamMarker):
                    v[i] = sub(it)
                elif isinstance(it, list):
                    walk_seq(it)
                elif isinstance(it, tuple):
                    v[i] = tuple(sub(x) if isinstance(x, A.ParamMarker) else x for x in it)
                    for x in v[i]:
                        if hasattr(x, "__dataclass_fields__"):
                            walk(x)
                elif hasattr(it, "__dataclass_fields__"):
                    walk(it)

        def walk(n):
            if not hasattr(n, "__dataclass_fields__"):
                return
            for f_ in n.__dataclass_fields__:
                v = getattr(n, f_)
                if isinstance(v, A.ParamMarker):
                    setattr(n, f_, sub(v))
                elif hasattr(v, "__dataclass_fields__"):
                    walk(v)
                elif isinstance(v, list):
                    walk_seq(v)

        walk(node)
        return seen[0]

    _PRIV_OF = {
        "InsertStmt": "insert", "UpdateStmt": "update", "DeleteStmt": "delete",
        "CreateTableStmt": "create", "DropTableStmt": "drop",
        "TruncateTableStmt": "drop", "CreateIndexStmt": "index",
        "DropIndexStmt": "index", "AlterTableStmt": "alter",
    }

    def _check_privileges(self, stmt):
        """(ref: privileges.RequestVerification called from the optimizer/
        executor adapters). Superusers skip; table scope is the statement's
        target (SELECT checks every referenced table)."""
        privs = self.catalog.privileges
        if privs.is_super(self.user):
            return
        kind = type(stmt).__name__
        if kind in ("GrantStmt", "RevokeStmt", "CreateUserStmt", "DropUserStmt",
                    "BRIEStmt", "ChangefeedStmt"):
            # changefeed admin follows BR: cluster-level replication is a
            # SUPER-only surface (ref: TiCDC requiring admin credentials)
            raise SQLError(f"access denied: {self.user!r} needs SUPER")
        if kind == "LoadDataStmt":
            if not privs.check(self.user, "insert", stmt.table.name, db=self.db):
                raise SQLError(f"access denied: {self.user!r} needs INSERT on {stmt.table.name!r}")
            return
        def check_read(names, exclude=()):
            for tname in names:
                if tname in exclude:
                    continue
                try:
                    self.catalog.table(tname)
                except CatalogError:
                    continue  # CTE/derived alias, not a real table
                if not privs.check(self.user, "select", tname, db=self.db):
                    raise SQLError(f"access denied: {self.user!r} needs SELECT on {tname!r}")

        need = self._PRIV_OF.get(kind)
        if need is not None:
            t = getattr(stmt, "table", None)
            tname = t.name.lower() if isinstance(t, A.TableName) else "*"
            if kind == "DropTableStmt":
                for t2 in stmt.tables:
                    if not privs.check(self.user, "drop", t2.name, db=self.db):
                        raise SQLError(f"access denied: {self.user!r} needs DROP on {t2.name!r}")
                return
            if not privs.check(self.user, need, tname, db=self.db):
                raise SQLError(f"access denied: {self.user!r} needs {need.upper()} on {tname!r}")
            # writes that read other tables (INSERT...SELECT, subqueries in
            # UPDATE/DELETE predicates) also need SELECT on the sources
            if kind in ("InsertStmt", "UpdateStmt", "DeleteStmt"):
                check_read(_referenced_tables(stmt), exclude={tname})
            return
        if kind in ("SelectStmt", "SetOprStmt", "AnalyzeTableStmt"):
            check_read(_referenced_tables(stmt))

    def _substitute_vars(self, node):
        """Rewrite @x / @@sysvar references to literals in place
        (ref: expression rewriter's variable substitution)."""

        def to_literal(v: A.Variable) -> A.Literal:
            if v.system:
                val = self.sysvars.get(v.name)
                from .sysvar import is_bool

                if is_bool(v.name):
                    # SELECT @@x prints booleans numerically (SHOW keeps
                    # ON/OFF) — MySQL/reference behavior
                    val = 1 if val == "ON" else 0
            else:
                val = self.user_vars.get(v.name.lower())
            return self._value_literal(val)

        for f_ in getattr(node, "__dataclass_fields__", {}):
            v = getattr(node, f_)
            if isinstance(v, A.Variable):
                setattr(node, f_, to_literal(v))
            elif isinstance(v, A.ExprNode) or hasattr(v, "__dataclass_fields__"):
                self._substitute_vars(v)
            elif isinstance(v, list):
                for i, it in enumerate(v):
                    if isinstance(it, A.Variable):
                        v[i] = to_literal(it)
                    elif isinstance(it, A.ExprNode) or hasattr(it, "__dataclass_fields__"):
                        self._substitute_vars(it)
                    elif isinstance(it, tuple):
                        v[i] = tuple(
                            to_literal(x) if isinstance(x, A.Variable) else x for x in it
                        )
                        for x in v[i]:
                            if isinstance(x, A.ExprNode):
                                self._substitute_vars(x)

    # ------------------------------------------------------------------
    def _apply_select_limit(self, stmt, rows):
        """MySQL sql_select_limit caps TOP-LEVEL result sets only — never
        subqueries/CTEs/views (those share _run_select recursively)."""
        if getattr(stmt, "limit", None) is not None:
            return rows
        ssl = self.sysvars.get_int("sql_select_limit")
        return rows[:ssl] if ssl < (1 << 64) - 1 else rows

    def _select(self, stmt: A.SelectStmt) -> Result:
        names, fts, rows = self._run_select(stmt, None)
        return Result(columns=names, rows=self._apply_select_limit(stmt, rows), fts=fts)

    def _persist_schema(self) -> None:
        """Write the catalog into the store's m-prefix keyspace after a
        schema change (ref: pkg/meta/meta.go — every DDL job persists its
        TableInfo; a reopened store recovers the schema from bytes)."""
        from .meta import persist_catalog

        persist_catalog(self.store, self.catalog)

    def _new_rewriter(self, parent_rw):
        from .subquery import SubqueryRewriter

        rw = SubqueryRewriter(
            self.catalog,
            registry=parent_rw.registry if parent_rw is not None else None,
            max_recursion=self.sysvars.get_int("cte_max_recursion_depth"),
            parent=parent_rw,
        )
        rw.exec_query = lambda q: self._exec_query(q, rw)
        return rw

    def _exec_query(self, stmt, parent_rw):
        """Nested-query entry: SelectStmt or SetOprStmt -> (names, fts, rows),
        sharing the parent rewriter's materialized-table namespace."""
        if isinstance(stmt, A.SetOprStmt):
            return self._set_opr(stmt, parent_rw)
        return self._run_select(stmt, parent_rw)

    def _run_select(self, stmt: A.SelectStmt, parent_rw) -> tuple:
        """Top-level SELECT entry: consult the digest-keyed plan cache
        first — a hit re-binds the hot statement's literals
        into the cached template and skips parse+plan; a miss runs the
        normal pipeline and installs a slotted template on success.
        Nested queries (parent_rw set) never consult: their results feed
        a parent statement that owns the cache decision."""
        probe = self._take_probe() if parent_rw is None else None
        if probe is None:
            return self._run_select_inner(stmt, parent_rw)
        served, pending = self._plan_cache_begin(probe, stmt)
        if served is not None:
            return served
        out = self._run_select_inner(stmt, parent_rw)
        if pending is not None:
            self._plan_cache_install(probe, pending)
        return out

    def _take_probe(self):
        p, self._stmt_probe = self._stmt_probe, None
        return p

    # ------------------------------------------- plan cache
    def _plan_cache_key(self, probe, kinds: str) -> tuple:
        """digest + db + literal-kind signature + plan-relevant sysvar
        fingerprint + session-binding revision. Schema drift and GLOBAL
        binding changes are validations on the entry, not key parts."""
        from .plancache import sysvar_fingerprint

        return (probe.digest, self.db, kinds,
                sysvar_fingerprint(self.sysvars), self._bindings_rev)

    def _plan_cache_text_serve(self, probe) -> Result | None:
        """The parse-free fast path (ref: TiDB's non-prepared plan cache
        keyed on the normalized digest): when the probe's digest already
        has a validated entry under the current db/kinds/sysvar/binding
        key, serve the statement by binding the lexer's masked-token
        values into the cached template — lexer-only, no parse, no plan.
        Returns None on any miss or ineligibility; the parse path then
        runs and counts its own miss/decline. Session-state declines
        (txn, stale read) re-check here because they vary per statement;
        structural shape was proven at install time and transfers to
        every digest-equal statement."""
        from ..util import metrics, tracing
        from . import plancache as _pc

        if (probe is None or probe.has_param or probe.has_var
                or probe.multi_stmt or probe.n_masked == 0
                or not self.sysvars.get_bool("tidb_enable_plan_cache")
                or self.txn is not None
                or self.sysvars.get("tidb_snapshot")):
            # n_masked == 0 shapes stay on the parse path: binding cannot
            # distinguish them from DDL/EXPLAIN/SET text anyway, and the
            # entry lookup would land on keys the install path never fills
            return None
        self._text_serve_type = "select"
        key = self._plan_cache_key(probe, probe.slot_kinds)
        entry = self.catalog.plan_cache.lookup(
            key, self.catalog, self.catalog.bindings_rev)
        if entry is None:
            entry = self._plan_cache_shared_adopt(key)
        if entry is None:
            return None
        if entry.tier == "pointwrite":
            # DML point-write tier: UPDATE/DELETE ... WHERE
            # pk = ? serves parse-free through the same digest machinery
            return self._plan_cache_serve_dml(entry, probe)
        with tracing.span("session.plan_cache") as sp:
            try:
                self._check_privileges(entry.template)
                out = self._plan_cache_execute(entry, list(probe.slot_values))
            except _pc.RebindError:
                return None  # recipe could not re-bind: replan cold
            metrics.PLAN_CACHE_HITS.inc()
            self._last_plan_cache = ("hit", "", entry.tier)
            self._stmt_probe = None  # consumed: nested paths never re-consult
            if sp is not None:
                sp.set("status", "hit")
                sp.set("tier", entry.tier)
        names, _fts, rows = out
        if not entry.has_limit:
            ssl = self.sysvars.get_int("sql_select_limit")
            if ssl < (1 << 64) - 1:
                rows = rows[:ssl]
        return Result(columns=names, rows=rows, fts=_fts)

    def _plan_cache_begin(self, probe, stmt):
        """Returns (served result, install ticket): a HIT serves the
        statement with parse+plan skipped; a MISS returns the ticket
        (key + pristine template copy) the success path installs; a
        DECLINE returns neither and counts its typed reason."""
        import copy as _copy

        from ..util import metrics, tracing
        from . import plancache as _pc

        if not self.sysvars.get_bool("tidb_enable_plan_cache"):
            self._last_plan_cache = ("off", "", "")
            return None, None
        with tracing.span("session.plan_cache") as sp:
            reason = _pc.shape_decline(stmt, self, probe)
            values = kinds = None
            if reason is None:
                try:
                    values, kinds = _pc.live_slot_values(stmt, probe.n_masked)
                except _pc.RebindError:
                    reason = "literal_shape"
            if reason is not None:
                metrics.PLAN_CACHE_DECLINES.labels(reason).inc()
                self._last_plan_cache = ("decline", reason, "")
                if sp is not None:
                    sp.set("status", "decline")
                    sp.set("reason", reason)
                return None, None
            key = self._plan_cache_key(probe, kinds)
            entry = self.catalog.plan_cache.lookup(
                key, self.catalog, self.catalog.bindings_rev)
            if entry is None:
                entry = self._plan_cache_shared_adopt(key)
            if entry is not None:
                try:
                    out = self._plan_cache_execute(entry, values)
                except _pc.RebindError:
                    out = None  # recipe could not re-bind: replan cold
                if out is not None:
                    metrics.PLAN_CACHE_HITS.inc()
                    self._last_plan_cache = ("hit", "", entry.tier)
                    if sp is not None:
                        sp.set("status", "hit")
                        sp.set("tier", entry.tier)
                    return out, None
            metrics.PLAN_CACHE_MISSES.inc()
            self._last_plan_cache = ("miss", "", "")
            if sp is not None:
                sp.set("status", "miss")
            return None, (key, _copy.deepcopy(stmt))

    def _plan_cache_execute(self, entry, values) -> tuple:
        """Serve a statement from a cached template. pointget re-executes
        the key-read fast path from the bound AST; dag re-binds Consts +
        ranges into the cached physical plan and goes straight to
        dispatch; ast re-plans the bound template (parse skipped)."""
        from . import plancache as _pc

        if entry.tier == "dag":
            plan = _pc.rebind_plan(entry, values, self.catalog)
            return self._execute_planned(plan)
        bound = _pc.bind_template(entry.template, values)
        if entry.tier == "pointget":
            det = self._point_get_detect(bound, {})
            if det is not None:
                # plan-cache-hit point gets are the coalescable tier
                #: the hint lets _exec_point_get park in the
                # store's micro-batch window instead of launching alone
                self._coalesce_hint = True
                try:
                    return self._exec_point_get(bound, *det)
                finally:
                    self._coalesce_hint = False
        return self._run_select_inner(bound, None)

    def _plan_cache_install(self, probe, pending) -> None:
        """Build + install the slotted template after the cold statement
        succeeded (one extra plan pass per digest, amortized over hits).
        Best-effort: an uncacheable shape counts a typed decline and the
        statement's result stands."""
        import copy as _copy

        from ..util import metrics
        from . import plancache as _pc

        key, tpl = pending
        try:
            kinds = _pc.wrap_slots(tpl, probe.n_masked)
            fps = {}
            for nm in _referenced_tables(tpl):
                try:
                    meta = self.catalog.table(nm)
                except CatalogError:
                    continue
                fps[meta.name] = _pc.table_fingerprint(meta)
            tier, plan2 = "ast", None
            range_src, probe_name, build_names = ("full",), "", ()
            if self._point_get_detect(tpl, {}) is not None:
                tier = "pointget"
            else:
                try:
                    tpl2 = _copy.deepcopy(tpl)
                    rw = self._new_rewriter(None)
                    rw.rewrite_select(tpl2)
                    if not rw.mat_dict():
                        plan2 = plan_select(
                            tpl2, self.catalog,
                            enable_index_merge=self.sysvars.get_bool(
                                "tidb_enable_index_merge"),
                        )
                except Exception:  # noqa: BLE001 — planner balked at the
                    plan2 = None  # slotted copy: ast tier still skips parse
                if plan2 is not None and self._dag_tier_ok(plan2, kinds,
                                                           probe.n_masked):
                    tier = "dag"
                    range_src = getattr(plan2, "range_src", None) or ("full",)
                    probe_name = plan2.probe_table.name
                    build_names = tuple(m.name for m in plan2.build_tables)
                else:
                    plan2 = None
            entry = _pc.PlanCacheEntry(
                tier=tier, template=tpl, n_slots=probe.n_masked, kinds=kinds,
                table_fps=fps, catalog_version=self.catalog.version,
                bindings_rev=self.catalog.bindings_rev,
                has_limit=tpl.limit is not None,
                plan=plan2, range_src=range_src, probe_name=probe_name,
                build_names=build_names,
            )
            pc = self.catalog.plan_cache
            pc.capacity = self.sysvars.get_int("tidb_plan_cache_size")
            pc.put(key, entry)
            if self.sysvars.get_bool("tidb_tpu_plan_cache_shared"):
                _pc.publish_shared(key, entry, self.catalog.bindings_rev,
                                   self._bindings_rev)
        except Exception:  # noqa: BLE001 — install is best-effort; the
            metrics.PLAN_CACHE_DECLINES.labels("uncacheable").inc()
            self._last_plan_cache = ("decline", "uncacheable", "")

    def _plan_cache_shared_adopt(self, key):
        """Shared cross-catalog tier consult: on a
        local miss, adopt an entry another catalog's sessions installed
        for this digest — fingerprint-revalidated against OUR catalog,
        then promoted into the local cache so the next hit is local.
        Binding-active catalogs/sessions stay local: binding revisions
        don't transfer across catalogs."""
        from ..util import metrics
        from . import plancache as _pc

        if (not self.sysvars.get_bool("tidb_tpu_plan_cache_shared")
                or self.catalog.bindings_rev != 0 or self._bindings_rev != 0):
            return None
        entry = _pc.SHARED_CACHE.lookup_shared(key, self.catalog)
        if entry is None:
            return None
        metrics.PLAN_CACHE_SHARED_HITS.inc()
        self.catalog.plan_cache.put(key, entry)
        return entry

    def _plan_cache_serve_dml(self, entry, probe) -> Result | None:
        """Parse-free serve of a cached DML point-write: bind
        the lexer's masked-token values into the template and run the
        UPDATE/DELETE through the autocommit wrapper — the write reaches
        the group-commit window without a parse or plan."""
        from ..util import metrics
        from . import plancache as _pc

        try:
            self._check_privileges(entry.template)
            bound = _pc.bind_template(entry.template, list(probe.slot_values))
        except _pc.RebindError:
            return None  # recipe could not re-bind: replan cold
        self._stmt_probe = None  # consumed: nested paths never re-consult
        is_update = isinstance(bound, A.UpdateStmt)
        self._text_serve_type = "update" if is_update else "delete"
        # the hit counts only after the write succeeds: a conflict/abort
        # surfaces exactly as the parse path's would, uncounted
        res = self._autocommit_dml(
            lambda: self._update(bound) if is_update else self._delete(bound))
        metrics.PLAN_CACHE_HITS.inc()
        self._last_plan_cache = ("hit", "", entry.tier)
        return res

    def _run_dml_cached(self, stmt, fn) -> Result:
        """Top-level UPDATE/DELETE entry: point-write shapes
        (WHERE pk = ? / pk IN (...) on an unpartitioned int-handle table)
        install a `pointwrite` tier entry on success, so digest-equal
        statements serve parse-free through _plan_cache_serve_dml. Other
        shapes count a typed `dml_shape` decline. The statement itself
        always runs the normal autocommit pipeline."""
        import copy as _copy

        from ..util import metrics
        from . import plancache as _pc

        probe = self._take_probe()
        pending = None
        if probe is not None and not (
                probe.has_param or probe.has_var or probe.multi_stmt
                or probe.n_masked == 0):
            if not self.sysvars.get_bool("tidb_enable_plan_cache"):
                self._last_plan_cache = ("off", "", "")
            else:
                reason = self._dml_shape_decline(stmt)
                values = kinds = None
                if reason is None:
                    try:
                        values, kinds = _pc.live_slot_values(stmt, probe.n_masked)
                    except _pc.RebindError:
                        reason = "literal_shape"
                if reason is not None:
                    metrics.PLAN_CACHE_DECLINES.labels(reason).inc()
                    self._last_plan_cache = ("decline", reason, "")
                else:
                    metrics.PLAN_CACHE_MISSES.inc()
                    self._last_plan_cache = ("miss", "", "")
                    pending = (self._plan_cache_key(probe, kinds),
                               _copy.deepcopy(stmt))
        res = self._autocommit_dml(lambda: fn(stmt))
        if pending is not None:
            self._plan_cache_install_dml(probe, pending)
        return res

    def _dml_shape_decline(self, stmt) -> str | None:
        """Typed decline for non-point DML shapes (None = cacheable
        point write). Mirrors shape_decline's session checks, then
        requires the WHERE clause to be a pure pk-equality the handle
        extractor accepts."""
        if self.txn is not None:
            return "in_txn"
        if self.sysvars.get("tidb_snapshot"):
            return "stale_read"
        if getattr(stmt, "multi_table", False):
            return "dml_shape"
        tbl = getattr(stmt, "table", None)
        if not isinstance(tbl, A.TableName):
            return "dml_shape"
        if stmt.where is None:
            return "dml_shape"
        try:
            meta = self.catalog.table(tbl.name)
        except CatalogError:
            return "no_table"
        if meta.table_id < 0 or meta.partition is not None:
            return "dml_shape"
        if meta.handle_col is None:
            return "dml_shape"  # no int pk: handles aren't value-addressed
        alias = (tbl.alias or meta.name.rsplit(".", 1)[-1]).lower()
        if self._extract_pk_handles(meta, alias, stmt.where) is None:
            return "dml_shape"
        return None

    def _plan_cache_install_dml(self, probe, pending) -> None:
        """Install the slotted pointwrite template after the cold DML
        succeeded. Best-effort, like _plan_cache_install."""
        from ..util import metrics
        from . import plancache as _pc

        key, tpl = pending
        try:
            kinds = _pc.wrap_slots(tpl, probe.n_masked)
            fps = {}
            for nm in _referenced_tables(tpl):
                try:
                    meta = self.catalog.table(nm)
                except CatalogError:
                    continue
                fps[meta.name] = _pc.table_fingerprint(meta)
            entry = _pc.PlanCacheEntry(
                tier="pointwrite", template=tpl, n_slots=probe.n_masked,
                kinds=kinds, table_fps=fps,
                catalog_version=self.catalog.version,
                bindings_rev=self.catalog.bindings_rev,
                has_limit=True,  # a write returns no rows to trim
            )
            pc = self.catalog.plan_cache
            pc.capacity = self.sysvars.get_int("tidb_plan_cache_size")
            pc.put(key, entry)
            if self.sysvars.get_bool("tidb_tpu_plan_cache_shared"):
                _pc.publish_shared(key, entry, self.catalog.bindings_rev,
                                   self._bindings_rev)
        except Exception:  # noqa: BLE001 — install is best-effort; the
            metrics.PLAN_CACHE_DECLINES.labels("uncacheable").inc()
            self._last_plan_cache = ("decline", "uncacheable", "")

    def _dag_tier_ok(self, plan2, kinds: str, n_slots: int) -> bool:
        """May this plan be cached at the dag tier (skip parse AND plan)?
        Requires real tables, no partition pruning / index-merge (their
        range structure is value-dependent), a recomputable range recipe,
        and the full literal-slot audit (plancache.audit_dag_slots)."""
        from . import plancache as _pc

        if plan2.probe_table.table_id < 0 or any(
                m.table_id < 0 for m in plan2.build_tables):
            return False
        if plan2.probe_table.partition is not None or plan2.lookup_merge:
            return False
        src = getattr(plan2, "range_src", None)
        if src is None or src[0] == "partition":
            return False
        if plan2.lookup is not None and src[0] != "lookup":
            return False
        return _pc.audit_dag_slots(plan2, kinds, n_slots)

    def _run_select_inner(self, stmt: A.SelectStmt, parent_rw) -> tuple:
        from .subquery import SubqueryError

        rw = self._new_rewriter(parent_rw)
        try:
            rw.process_ctes(stmt.ctes)
            stmt.ctes = []
            if stmt.from_clause is None:
                # SELECT <exprs>: subqueries materialize, constants evaluate
                # with the reference evaluator
                for f in stmt.fields:
                    if isinstance(f, A.SelectField):
                        f.expr = rw._rewrite_expr(f.expr, [], stmt)
                lw = _Lowerer(_Scope([]))
                ev = RefEvaluator()
                exprs = [lw.lower_base(f.expr) for f in stmt.fields]
                from .planner import _field_label

                names = [_field_label(f) for f in stmt.fields]
                if stmt.where is not None:
                    # SELECT ... FROM DUAL WHERE <cond> (the only legal
                    # table-less WHERE form; ref: MySQL DUAL semantics)
                    w = rw._rewrite_expr(stmt.where, [], stmt)
                    from ..expr.eval_ref import _truth

                    if _truth(ev.eval(lw.lower_base(w), [])) is not True:
                        return names, [e.ft for e in exprs], []
                row = [ev.eval(e, []) for e in exprs]
                return names, [e.ft for e in exprs], [row]
            rw.rewrite_select(stmt)
        except SubqueryError as exc:
            raise SQLError(str(exc)) from exc
        self._bind_information_schema(stmt.from_clause, rw)
        if stmt.for_update:
            self._select_for_update(stmt)
        # the fast path's _read_row already overlays the txn buffer, so it
        # runs BEFORE dirty-table shadowing (which would materialize the
        # whole table just to read one key)
        fast = self._try_point_get(stmt, rw)
        if fast is not None:
            return fast
        if self.txn is not None and self.txn.row_ops:
            self._shadow_dirty_tables(stmt.from_clause, rw)
        plan = plan_select(
            stmt, self.catalog, mat=rw.mat_dict(),
            enable_index_merge=self.sysvars.get_bool("tidb_enable_index_merge"),
        )
        return self._execute_planned(plan, rw)

    def _execute_planned(self, plan, rw=None) -> tuple:
        """Execute a planned SELECT: the dispatch tail shared by the
        normal pipeline and dag-tier plan-cache hits (which arrive with a
        re-bound plan and no rewriter — cacheable shapes reference real
        tables only). Returns (column names, output fts, rows)."""
        from ..util.memory import MemTracker, QuotaExceeded

        # plan digest: access path + executor-shape fingerprint, the join
        # key between slow-log rows and statement summaries (ref:
        # plancodec.NormalizePlan -> plan_digest in the slow log)
        import hashlib as _hashlib

        self._last_plan_digest = _hashlib.sha256(
            f"{plan.access_path}|{plan.dag.fingerprint()}".encode()
        ).hexdigest()[:32]
        ts = self._pin_read_ts()
        # OOM action chain (ref: util/memory tracker actions): first evict
        # the store's reclaimable chunk/batch caches; a second breach is
        # handled below by degrading to the low-memory execution path
        evicted = [False]

        def _evict_action(tr, _n):
            if not evicted[0]:
                evicted[0] = True
                freed = self.store.evict_caches()
                from ..util import metrics

                metrics.MEM_EVICTIONS.inc()
                tr.consume(-min(freed, 0))  # caches are store-owned; the
                # eviction frees real memory but the tracker accounts query
                # bytes only — the retry below re-checks the quota

        tracker = MemTracker(
            "query",
            quota=self.sysvars.get_int("tidb_mem_quota_query") or None,
            parent=self._session_tracker(),
            action=_evict_action,
        )
        gate_on = self.sysvars.get_bool("tidb_enable_tpu_coprocessor")
        aux = []
        try:
            for t in plan.build_tables:
                c = self._table_chunk(t, ts, rw)
                tracker.consume(c.nbytes())
                aux.append(c)
            if plan.probe_table.table_id < 0:
                # materialized probe (CTE/derived table): the whole DAG runs
                # over in-memory chunks — device path or oracle by the gate
                # (never reached from a plan-cache hit: those shapes decline)
                probe = rw.registry.chunks[plan.probe_table.name]
                tracker.consume(probe.nbytes())
                if gate_on:
                    from ..exec import run_dag_on_chunks

                    chunk = run_dag_on_chunks(plan.dag, [probe] + aux, device=self.store.device)
                else:
                    from ..exec import run_dag_reference

                    rows = run_dag_reference(plan.dag, [probe] + aux)
                    chunk = Chunk.from_rows(plan.dag.output_fts(), rows)
            else:
                # empty ranges (ranger proved the predicate unsatisfiable)
                # flow through: execute_root dispatches zero tasks and the
                # root merge still produces scalar-agg rows
                if plan.ranges is not None:
                    ranges = plan.ranges
                else:
                    ranges = [
                        r for pid in plan.probe_table.physical_ids()
                        for r in full_table_ranges(pid)
                    ]
                if plan.lookup is not None or plan.lookup_merge:
                    # index-lookup double-read phase 1: index scan -> row
                    # handles -> coalesced table ranges (ref:
                    # pkg/executor/distsql.go IndexLookUpExecutor /
                    # index_merge_reader.go for the union form)
                    ranges = self._lookup_handle_ranges(plan, ts)
                if not gate_on:
                    # feature gate OFF (ref: TiDBAllowMPPExecution pattern):
                    # evaluate the whole plan with the row-at-a-time oracle
                    chunk = self._select_via_oracle(plan, ranges, aux, ts)
                else:
                    chunk = None
                    engines = self._read_engines()

                    def _columnar_routed():
                        # engine routing: when the columnar
                        # replica is this plan's engine, the whole-plan
                        # mesh shortcut must not preempt it — the consult
                        # itself lives in execute_root. Evaluated LAST in
                        # the mesh condition so the eligibility walk only
                        # runs when a mesh attempt is actually on the
                        # table (no double walk when mesh
                        # is off or EXPLAIN ANALYZE pinned the cop path)
                        from ..columnar.route import columnar_would_serve

                        return columnar_would_serve(
                            self.store, plan.dag, ranges, engines)

                    if self._explain_sink is None:
                        # EXPLAIN ANALYZE wants per-executor summaries,
                        # which only the per-region path produces.
                        # Statement tier (ref: mpp_gather.go:40): "mpp"
                        # plans exchange-linked fragments through the
                        # dispatch layer, "mesh" is the whole-plan
                        # shard_map shortcut, "root" defers to
                        # execute_root (per-request tiers + columnar)
                        from ..distsql.planner import choose_statement_tier

                        decision = choose_statement_tier(
                            plan.dag,
                            allow_mpp=self.sysvars.get_bool("tidb_allow_mpp"),
                            allow_mesh=self.sysvars.get_bool("tidb_enable_tpu_mesh"),
                            columnar_routed=_columnar_routed,
                            n_devices=len(self.store.mesh_devices),
                        )
                        gc = self.sysvars.get_int("tidb_tpu_group_capacity")
                        if decision.tier == "mpp":
                            from ..mpp.dispatch import try_mpp_select

                            chunk = try_mpp_select(
                                self.store, plan.dag, ranges, ts,
                                group_capacity=gc,
                                aux_chunks=aux,
                                engines=engines,
                                backoff_weight=self.sysvars.get_int("tidb_backoff_weight"),
                                checker=self._runaway_checker(),
                            )
                        if (chunk is None
                                and decision.tier in ("mpp", "mesh")
                                and not (decision.tier == "mpp" and _columnar_routed())):
                            # mpp declined (counted fallback): the mesh
                            # shortcut still applies unless the columnar
                            # replica owns the plan (engine routing)
                            from ..parallel.sql import try_mesh_select

                            chunk = try_mesh_select(
                                self.store, plan.dag, ranges, ts,
                                group_capacity=gc,
                                aux_chunks=aux,
                            )
                    if chunk is None:
                        kwargs = dict(
                            start_ts=ts,
                            aux_chunks=aux,
                            group_capacity=self.sysvars.get_int("tidb_tpu_group_capacity"),
                            small_groups=plan.small_groups,
                            concurrency=self.sysvars.get_int("tidb_distsql_scan_concurrency"),
                            paging_size=(
                                self.sysvars.get_int("tidb_max_chunk_size")
                                if self.sysvars.get_bool("tidb_enable_paging")
                                else None
                            ),
                            batch_cop=self.sysvars.get_bool("tidb_allow_batch_cop"),
                            mesh=self.sysvars.get_bool("tidb_enable_tpu_mesh"),
                            mesh_min_rows=self.sysvars.get_int("tidb_tpu_mesh_min_rows"),
                            summary_sink=self._explain_sink,
                            checker=self._runaway_checker(),
                            backoff_weight=self.sysvars.get_int("tidb_backoff_weight"),
                            replica_read=self.sysvars.get("tidb_replica_read"),
                            isolation_engines=engines,
                        )
                        try:
                            chunk = execute_root(
                                self.store, plan.dag, ranges, tracker=tracker, **kwargs
                            )
                        except QuotaExceeded:
                            # degrade: sequential dispatch + incremental
                            # Partial2 fold keeps the working set bounded
                            # (the spill analog)
                            from ..util import metrics

                            metrics.MEM_DEGRADED_QUERIES.inc()
                            tracker.release_all()
                            chunk = execute_root(
                                self.store, plan.dag, ranges,
                                tracker=tracker, low_memory=True, **kwargs
                            )
            tracker.consume(chunk.nbytes())
        except QuotaExceeded as exc:
            raise SQLError(str(exc)) from exc
        finally:
            tracker.release_all()
            self._unpin_read_ts(ts)
        rows = chunk.rows()
        if plan.offset:
            rows = rows[plan.offset :]
        return plan.column_names, plan.dag.output_fts(), rows

    def _set_opr(self, stmt: A.SetOprStmt, parent_rw) -> tuple:
        """UNION [ALL] chains: branch results merge at root; a DISTINCT
        union dedups the entire accumulated set (MySQL semantics; ref:
        pkg/executor/union iterator + planner buildSetOpr)."""
        from ..expr.eval_ref import compare
        from .subquery import SubqueryError

        if any(op != "union" for op in getattr(stmt, "ops", [])):
            raise SQLError("EXCEPT/INTERSECT set operations are not supported yet")
        rw = self._new_rewriter(parent_rw)
        try:
            rw.process_ctes(stmt.ctes)
            stmt.ctes = []
        except SubqueryError as exc:
            raise SQLError(str(exc)) from exc
        # two passes: collect every branch, unify column types across them
        # (MySQL coerces all branches to one result type before dedup), then
        # fold with the per-boundary distinct flags
        from ..exec.executor import datum_group_key
        from .planner import _unify_fts

        names = None
        branches = []
        for sel in stmt.selects:
            n_, f_, r_ = self._exec_query(sel, rw)
            if names is None:
                names = n_
            elif len(n_) != len(names):
                raise SQLError("The used SELECT statements have a different number of columns")
            branches.append((f_, r_))
        fts = [
            _unify_fts([b[0][i] for b in branches])
            for i in range(len(names))
        ]
        acc: list = []
        for i, (bf, rows) in enumerate(branches):
            coerced = [
                [d if d.is_null() else _coerce_datum(d, ft) for d, ft in zip(r, fts)]
                for r in rows
            ]
            acc.extend(coerced)
            if i > 0 and not stmt.all_flags[i - 1]:
                seen: set = set()
                dedup = []
                for r in acc:
                    # collation-aware keys: ci strings dedup case-folded
                    k = tuple(datum_group_key(d, ft) for d, ft in zip(r, fts))
                    if k not in seen:
                        seen.add(k)
                        dedup.append(r)
                acc = dedup
        if stmt.order_by:
            import functools

            idxs = []
            for b in stmt.order_by:
                e = b.expr
                if isinstance(e, A.Literal) and e.kind == "int":
                    pos = int(e.value)
                    if not (1 <= pos <= len(names)):
                        raise SQLError(f"ORDER BY position {pos} out of range")
                    idxs.append((pos - 1, b.desc))
                elif isinstance(e, A.ColumnName) and not e.table:
                    low_names = [n.lower() for n in names]
                    if e.name.lower() not in low_names:
                        raise SQLError(f"unknown column {e.name!r} in UNION ORDER BY")
                    idxs.append((low_names.index(e.name.lower()), b.desc))
                else:
                    raise SQLError("UNION ORDER BY supports output columns and positions only")

            def cmp(a, b):
                for i, desc in idxs:
                    x, y = a[i], b[i]
                    if x.is_null() and y.is_null():
                        continue
                    c = -1 if x.is_null() else (1 if y.is_null() else compare(x, y))
                    if c:
                        return -c if desc else c
                return 0

            acc.sort(key=functools.cmp_to_key(cmp))
        if stmt.limit is not None:
            def _n(e, dflt):
                if e is None:
                    return dflt
                if isinstance(e, A.Literal):
                    return int(e.value)
                return int(e)

            off = _n(stmt.limit.offset, 0)
            cnt = _n(stmt.limit.count, len(acc))
            acc = acc[off : off + cnt]
        return names, fts, acc

    def _table_chunk(self, meta: TableMeta, ts: int, rw) -> Chunk:
        if meta.table_id < 0:
            return rw.registry.chunks[meta.name]
        return self._fetch_table_chunk(meta, ts)

    def _column_descs(self, meta: TableMeta) -> list:
        """(name, type, is_nullable, key, default, extra) per column —
        shared by SHOW COLUMNS and information_schema.columns."""
        from ..tools.dump import _type_sql

        pri_cols = set()
        for idx in meta.indices:
            if idx.name == "PRIMARY":
                pri_cols.update(idx.col_names)
        out = []
        for c in meta.columns:
            dflt = "NULL" if not c.ft.not_null() else ""
            if c.default is not None:
                try:
                    d = self._eval_const(c.default, c.ft)
                    dflt = "NULL" if d.is_null() else str(d.val)
                except Exception:  # noqa: BLE001 — display only
                    pass
            elif c.origin_default is not None and not c.origin_default.is_null():
                dflt = str(c.origin_default.val)
            out.append((
                c.name, (c.decl or _type_sql(c.ft).lower()),
                "NO" if c.ft.not_null() else "YES",
                "PRI" if (c.name == meta.handle_col or c.name in pri_cols) else "",
                dflt,
                "auto_increment" if c.auto_increment else "",
            ))
        return out

    @staticmethod
    def _index_descs(meta: TableMeta) -> list:
        """(non_unique, index_name, seq_in_index, column_name) rows."""
        out = []
        for idx in meta.indices:
            for seq, cn in enumerate(idx.col_names, 1):
                out.append((0 if idx.unique else 1, idx.name, seq, cn))
        return out

    def _bind_information_schema(self, node, rw) -> None:
        """information_schema memtables served from the catalog
        (ref: pkg/infoschema memtables + pkg/executor/infoschema_reader.go —
        the reference serves these from TiDB itself via kv.StoreType=TiDB;
        here they materialize per statement). Covered: TABLES, COLUMNS,
        STATISTICS, TIDB_INDEXES-shaped index rows ride in STATISTICS."""
        if isinstance(node, A.Join):
            self._bind_information_schema(node.left, rw)
            self._bind_information_schema(node.right, rw)
            return
        if not isinstance(node, A.TableName) or node.db.lower() != "information_schema":
            return
        from ..tools.dump import _type_sql
        from ..types import new_varchar

        kind = node.name.lower()
        S, I = new_varchar(64), new_longlong()

        def schema_of(name: str):
            if "." in name:
                db, short = name.split(".", 1)
                return db, short
            return "test", name
        if kind == "tables":
            names = ["table_schema", "table_name", "table_rows", "tidb_table_id"]
            fts = [S, S, I, I]
            rows = []
            for name in self.catalog.tables():
                m = self.catalog.table(name)
                db, short = schema_of(m.name)
                rows.append([Datum.string(db), Datum.string(short),
                             Datum.i64(m.row_count), Datum.i64(m.table_id)])
        elif kind == "columns":
            names = ["table_schema", "table_name", "column_name", "ordinal_position",
                     "column_type", "is_nullable", "column_key"]
            fts = [S, S, S, I, S, S, S]
            rows = []
            for name in self.catalog.tables():
                m = self.catalog.table(name)
                db, short = schema_of(m.name)
                for i, (cn, ctype, nullable, key, _, _) in enumerate(self._column_descs(m), 1):
                    rows.append([
                        Datum.string(db), Datum.string(short), Datum.string(cn),
                        Datum.i64(i), Datum.string(ctype),
                        Datum.string(nullable), Datum.string(key),
                    ])
        elif kind == "statistics":
            names = ["table_schema", "table_name", "non_unique", "index_name",
                     "seq_in_index", "column_name"]
            fts = [S, S, I, S, I, S]
            rows = []
            for name in self.catalog.tables():
                m = self.catalog.table(name)
                db, short = schema_of(m.name)
                for nu, iname, seq, cn in self._index_descs(m):
                    rows.append([
                        Datum.string(db), Datum.string(short),
                        Datum.i64(nu), Datum.string(iname),
                        Datum.i64(seq), Datum.string(cn),
                    ])
        elif kind == "slow_query":
            # ref: infoschema slow_query memtable fed by the slow log
            from ..types import new_double

            D = new_double()
            names = ["time", "query_time", "digest", "plan_digest", "query", "success", "error"]
            fts = [S, D, S, S, new_varchar(4096), I, new_varchar(1024)]
            rows = []
            import datetime as _dt

            for e in self.catalog.stmtlog.slow_entries():
                rows.append([
                    Datum.string(_dt.datetime.fromtimestamp(e.ts, _dt.timezone.utc).strftime("%Y-%m-%d %H:%M:%S")),
                    Datum.f64(e.duration_ms / 1e3),
                    Datum.string(e.digest), Datum.string(e.plan_digest),
                    Datum.string(e.sql),
                    Datum.i64(1 if e.success else 0),
                    Datum.string(e.error),
                ])
        elif kind == "statements_summary":
            # ref: pkg/util/stmtsummary -> information_schema.statements_summary
            from ..types import new_double

            D = new_double()
            names = ["digest", "digest_text", "exec_count", "sum_latency",
                     "max_latency", "avg_latency", "sum_rows", "errors",
                     "avg_device_ns", "max_device_ns", "avg_compile_ns",
                     "avg_backoff_ms", "avg_queue_ms", "cost_class", "sample_sql"]
            fts = [S, new_varchar(1024), I, D, D, D, I, I,
                   D, I, D, D, D, S, new_varchar(256)]
            rows = []

            for sm in self.catalog.stmtlog.summary_rows():
                n = sm.exec_count or 1
                rows.append([
                    Datum.string(sm.digest), Datum.string(sm.normalized),
                    Datum.i64(sm.exec_count), Datum.f64(sm.sum_latency_ms),
                    Datum.f64(sm.max_latency_ms), Datum.f64(sm.avg_latency_ms),
                    Datum.i64(sm.sum_rows), Datum.i64(sm.errors),
                    Datum.f64(sm.avg_device_ns), Datum.i64(sm.max_device_ns),
                    Datum.f64(sm.sum_compile_ns / n),
                    Datum.f64(sm.sum_backoff_ms / n),
                    Datum.f64(sm.sum_queue_ms / n),
                    Datum.string(topsql.COLLECTOR.cost_class(sm.digest)),
                    Datum.string(sm.sample_sql),
                ])
        elif kind == "tidb_top_sql":
            # ref: pkg/util/topsql/reporter — the windowed per-digest
            # resource ledger: top-K digests per metric per window plus
            # the "(others)" fold. Rows come straight from the collector's
            # ONE serializer (windows_view), the same snapshot
            # /topsql/api/v1/windows serves — the surfaces cannot drift
            from ..types import new_double

            D = new_double()
            names = ["window_start", "window_end", "live", "digest",
                     "plan_digest", "cost_class", "exec_count", "cpu_ns",
                     "device_ns", "compile_ns", "backoff_ms", "queue_ms",
                     "bytes_to_device", "cop_cache_hits", "plan_cache_hits",
                     "errors", "sample_sql"]
            fts = [D, D, I, S, S, S, I, I, I, I, D, D, I, I, I, I,
                   new_varchar(256)]
            rows = []
            for w in topsql.COLLECTOR.windows_view():
                digests = list(w["digests"])
                if w["others"] is not None:
                    digests.append(w["others"])
                for r in digests:
                    cls = ("" if r["digest"] == topsql.OTHERS_DIGEST
                           else topsql.COLLECTOR.cost_class(r["digest"]))
                    rows.append([
                        Datum.f64(w["start"]), Datum.f64(w["end"]),
                        Datum.i64(1 if w["live"] else 0),
                        Datum.string(r["digest"]), Datum.string(r["plan_digest"]),
                        Datum.string(cls), Datum.i64(r["exec_count"]),
                        Datum.i64(r["cpu_ns"]), Datum.i64(r["device_ns"]),
                        Datum.i64(r["compile_ns"]), Datum.f64(r["backoff_ms"]),
                        Datum.f64(r["queue_ms"]), Datum.i64(r["bytes_to_device"]),
                        Datum.i64(r["cop_cache_hits"]), Datum.i64(r["plan_cache_hits"]),
                        Datum.i64(r["errors"]), Datum.string(r["sample_sql"]),
                    ])
        else:
            raise SQLError(f"information_schema.{kind} not supported yet")
        meta = rw.registry.register(names, fts, rows)
        # db-scoped binding: the planner resolves information_schema.<name>
        # through this key only, so a user table named "tables" is untouched
        # and the AST stays reusable (prepared statements re-bind per run)
        rw.bindings[f"information_schema.{kind}"] = meta

    def _shadow_dirty_tables(self, node, rw) -> None:
        """Bind every txn-dirty table referenced in FROM to a materialized
        overlay (committed snapshot + this txn's buffered rows) — the
        UnionScan analog (ref: pkg/executor/union_scan.go; the reference
        likewise disables pushdown below a dirty table's reader)."""
        if isinstance(node, A.TableName):
            name = node.name.lower()
            if name in rw.bindings:
                return
            try:
                meta = self.catalog.table(name)
            except CatalogError:
                return
            ops = self.txn.row_ops.get(meta.table_id)
            if not ops:
                return
            rows = [row for _, row in self._scan_rows_with_handles(meta, None, self.txn.start_ts)]
            m = rw.registry.register([c.name for c in meta.columns], meta.fts(), rows)
            rw.bindings[name] = m
        elif isinstance(node, A.Join):
            self._shadow_dirty_tables(node.left, rw)
            self._shadow_dirty_tables(node.right, rw)

    def _select_for_update(self, stmt: A.SelectStmt) -> None:
        """SELECT ... FOR UPDATE: pessimistic locks on the matched probe
        rows (ref: PointGetExec / SelectLock executor lock-keys step)."""
        if self.txn is None or not self.txn.explicit:
            return  # autocommit SELECT FOR UPDATE locks nothing durable
        if not isinstance(stmt.from_clause, A.TableName):
            raise SQLError("SELECT ... FOR UPDATE supports single-table queries only")
        try:
            meta = self.catalog.table(stmt.from_clause.name)
        except CatalogError:
            return  # CTE/derived target: nothing lockable
        try:
            matched = self._scan_rows_with_handles(meta, stmt.where, self.txn.start_ts)
        except (PlanError, SQLError):
            # WHERE references rewrite markers the row scanner cannot
            # evaluate: lock the whole table (conservative, never unsound)
            matched = self._scan_rows_with_handles(meta, None, self.txn.start_ts)
        self._lock_rows(meta, [h for h, _ in matched])

    def _lookup_handle_ranges(self, plan, ts) -> list:
        """Phase 1 of the double-read: scan index entries over the pruned
        index key ranges, collect handles, coalesce consecutive handles
        into second-phase table ranges (batched + ordered — the keep_order
        analog of IndexLookUpExecutor's handle batching)."""
        from ..distsql import handle_ranges
        from ..exec.dag import IndexScan

        meta = plan.probe_table
        lookups = plan.lookup_merge if plan.lookup_merge else [plan.lookup]
        handles_set: set = set()
        for index_id, iranges in lookups:
            idx = next(i for i in meta.indices if i.index_id == index_id)
            vcols = [meta.col(cn) for cn in idx.col_names]
            icols = tuple(ColumnInfo(c.col_id, c.ft) for c in vcols) + (ColumnInfo(-1, HANDLE_FT),)
            hdag = DAGRequest(
                (IndexScan(meta.table_id, index_id, icols),),
                output_offsets=(len(icols) - 1,),
            )
            chunk = execute_root(self.store, hdag, iranges, start_ts=ts)
            handles_set |= {int(r[0].val) for r in chunk.rows()}
        handles = sorted(handles_set)
        pairs: list[list[int]] = []
        for h in handles:
            if pairs and h == pairs[-1][1] + 1:
                pairs[-1][1] = h
            else:
                pairs.append([h, h])
        return handle_ranges(meta.table_id, [(a, b) for a, b in pairs])

    def _select_via_oracle(self, plan, ranges, aux, ts) -> Chunk:
        from ..exec import run_dag_reference

        scan = plan.dag.executors[0]
        probe_dag = DAGRequest((scan,), output_offsets=tuple(range(len(scan.columns))))
        res = execute_root(self.store, probe_dag, ranges, start_ts=ts)
        rows = run_dag_reference(plan.dag, [res] + list(aux))
        return Chunk.from_rows(plan.dag.output_fts(), rows)

    def _fetch_table_chunk(self, meta: TableMeta, ts: int) -> Chunk:
        scan = TableScan(meta.table_id, meta.scan_columns())
        dag = DAGRequest((scan,), output_offsets=tuple(range(len(meta.columns))))
        ranges = [r for pid in meta.physical_ids() for r in full_table_ranges(pid)]
        return execute_root(self.store, dag, ranges, start_ts=ts)

    # ------------------------------------------------------------------
    def _eval_const(self, node: A.ExprNode, ft: FieldType) -> Datum:
        lw = _Lowerer(_Scope([]))
        ev = RefEvaluator()
        d = ev.eval(lw.lower_base(node), [])
        return _coerce_datum(d, ft)

    def _create_index(self, stmt: A.CreateIndexStmt) -> Result:
        """CREATE INDEX: a DDL job stepping the online states, then the
        write-reorg backfill (ref: pkg/ddl/index.go + backfilling.go —
        single process, so one synchronous pass)."""
        from .ddl import run_job

        meta = self.catalog.table(stmt.table.name)
        cols = [c[0] if isinstance(c, tuple) else str(c) for c in stmt.columns]
        n = run_job(self.catalog, "add index", meta.name,
                    f"CREATE INDEX {stmt.index_name} ON {meta.name}",
                    lambda step: self._build_index(meta, stmt.index_name, cols, stmt.unique, step=step),
                    index_states=True)
        return Result(affected=n)

    def _build_index(self, meta: TableMeta, index_name: str, cols: list, unique: bool, step=None) -> int:
        """ONLINE index build (shared by CREATE INDEX and ALTER ADD INDEX):
        the real F1 state walk (ref: pkg/ddl/index.go) — the IndexMeta's
        `state` drives concurrent DML's behavior at every step, not just a
        recorded list:

          delete_only   registered; DML honors deletes, adds no entries
          write_only    DML double-writes entries; readers still ignore it
          write_reorg   backfill scans a snapshot and writes every entry;
                        a verify pass tombstones entries whose row vanished
                        between the scan and the writes (concurrent DELETE)
          public        readers may use it

        `step` (from run_job) records each transition as a schema-version
        bump; failpoints let tests pause between states while writer
        threads run DML."""
        from ..util import failpoint

        step = step or (lambda st: None)
        im = self.catalog.add_index(meta.name, index_name, cols, unique, state="delete_only")
        try:
            step("delete_only")
            failpoint.eval("ddl_index_delete_only")
            im.state = "write_only"
            self.catalog.version += 1
            step("write_only")
            failpoint.eval("ddl_index_write_only")
            im.state = "write_reorg"
            self.catalog.version += 1
            step("write_reorg")
            failpoint.eval("ddl_index_write_reorg")
            ts = self._next_ts()
            rows = self._scan_rows_with_handles(meta, None, ts)
            wts = self._next_ts()
            pos = {c.name: i for i, c in enumerate(meta.columns)}
            # validate the WHOLE backfill before writing anything: a
            # duplicate found mid-write would leave dead index entries
            seen: dict = {}
            entries = []
            for handle, row in rows:
                vals = [row[pos[cn]] for cn in im.col_names]
                if im.unique and not any(d.is_null() for d in vals):
                    k = tuple(str(d) for d in vals)
                    if k in seen:
                        raise SQLError(f"duplicate entry for unique key {im.name!r} during backfill")
                    seen[k] = handle
                entries.append(tablecodec.encode_index_key(meta.table_id, im.index_id, vals + [Datum.i64(handle)]))
            for key in entries:
                self.store.put_index(key, b"\x00", wts)
            # verify pass: a row DELETEd between the scan snapshot and wts
            # would be resurrected by the backfill write — tombstone every
            # backfilled entry whose row no longer exists (ref: the
            # reference merges delete markers during reorg)
            vts = self._next_ts()
            live = set()
            for handle, row in self._scan_rows_with_handles(meta, None, vts):
                vals = [row[pos[cn]] for cn in im.col_names]
                live.add(tablecodec.encode_index_key(meta.table_id, im.index_id, vals + [Datum.i64(handle)]))
            dts = self._next_ts()
            for key in entries:
                if key not in live:
                    self.store.put_index(key, None, dts)
            im.state = "public"
            self.catalog.version += 1
            return len(rows)
        except Exception:
            self.catalog.drop_index(meta.name, im.name)  # roll back metadata
            raise

    def _drop_index(self, stmt: A.DropIndexStmt) -> Result:
        from .ddl import run_job

        meta = self.catalog.table(stmt.table.name)
        run_job(self.catalog, "drop index", meta.name,
                f"DROP INDEX {stmt.index_name} ON {meta.name}",
                lambda: self._drop_index_impl(meta, stmt.index_name))
        return Result()

    def _drop_index_impl(self, meta: TableMeta, index_name: str):
        """Catalog change through the locked/versioned path, then tombstone
        every entry of the dropped index (no KV leak)."""
        im = self.catalog.drop_index(meta.name, index_name)
        wts = self._next_ts()
        prefix = tablecodec.encode_index_key(meta.table_id, im.index_id, [])
        for key, _ in list(self.store.kv.scan(prefix, prefix + b"\xff", wts)):
            self.store.put_index(key, None, wts)

    def _scan_index_prefix(self, prefix: bytes, ts: int):
        """Live index keys under `prefix`: committed entries overlaid with
        this txn's buffered index mutations (tombstones hide, puts add)."""
        muts = self.txn.index_muts if self.txn is not None else {}
        _MISS = object()
        for key, _ in self.store.kv.scan(prefix, prefix + b"\xff", ts):
            if muts.get(key, _MISS) is None:
                continue  # tombstoned in this txn
            yield key
        for key, val in muts.items():
            # duplicate yields for keys also committed are harmless (the
            # caller checks handle ownership, not multiplicity)
            if val is not None and key.startswith(prefix):
                yield key

    def _find_unique_conflict(self, meta: TableMeta, datums: list, handle: int, ts: int, old_handle: int | None = None):
        """First (conflicting_handle, index) whose unique entry collides
        with this row, or None (ref: ER_DUP_ENTRY; MySQL allows multiple
        NULLs in a unique index). `old_handle` is the row's previous handle
        during a PK-changing UPDATE — its still-live entries are the row's
        own, not duplicates."""
        own = {handle, old_handle if old_handle is not None else handle}
        pos = {c.name: i for i, c in enumerate(meta.columns)}
        for idx in meta.indices:
            if idx.state == "delete_only":
                # not yet double-written: probing it would miss real rows;
                # pre-existing duplicates are caught by the reorg backfill
                continue
            if not idx.unique:
                continue
            vals = [datums[pos[cn]] for cn in idx.col_names]
            if any(d.is_null() for d in vals):
                continue
            prefix = tablecodec.encode_index_key(meta.table_id, idx.index_id, vals)
            for key in self._scan_index_prefix(prefix, ts):
                other = self._index_keys_handle(key)
                if other is not None and other not in own:
                    return other, idx
        return None

    def _check_unique(self, meta: TableMeta, datums: list, handle: int, ts: int, old_handle: int | None = None):
        conflict = self._find_unique_conflict(meta, datums, handle, ts, old_handle)
        if conflict is not None:
            raise SQLError(f"duplicate entry for unique key {conflict[1].name!r}")

    @staticmethod
    def _index_keys_handle(key: bytes) -> int | None:
        """Trailing handle datum of an index entry key."""
        from ..codec.datum_codec import decode_datums

        prefix_len = 1 + 8 + 2 + 8
        try:
            ds = decode_datums(key[prefix_len:])
            return int(ds[-1].val)
        except Exception:
            return None

    def _write_indexes(self, meta, datums, handle, delete=False):
        pos = {c.name: i for i, c in enumerate(meta.columns)}
        for idx in meta.indices:
            if not delete and idx.state == "delete_only":
                # F1 delete-only: concurrent DML removes entries but must
                # not ADD ones the backfill has not reached yet
                # (ref: pkg/ddl/index.go state semantics)
                continue
            vals = [datums[pos[cn]] for cn in idx.col_names] + [Datum.i64(handle)]
            key = tablecodec.encode_index_key(meta.table_id, idx.index_id, vals)
            val = None if delete else b"\x00"
            self.txn.mutations[key] = val
            self.txn.index_muts[key] = val

    def _insert(self, stmt: A.InsertStmt) -> Result:
        meta = self.catalog.table(stmt.table.name)
        ts = self.txn.start_ts
        if stmt.select is not None:
            src = self._select(stmt.select)
            cols = [c.lower() for c in (stmt.columns or [c.name for c in meta.columns])]
            rows = []
            for r in src.rows:
                if len(r) != len(cols):
                    raise SQLError("column count does not match value count")
                rows.append({cols[i]: d for i, d in enumerate(r)})
        else:
            cols = [c.lower() for c in (stmt.columns or [c.name for c in meta.columns])]
            rows = []
            for vals in stmt.values:
                if len(vals) != len(cols):
                    raise SQLError("column count does not match value count")
                # a DEFAULT literal behaves as if the column were omitted
                # (column default / generated recompute; ref: ast.Default
                # handling in executor/insert_common.go)
                rows.append({
                    cols[i]: self._eval_const(v, meta.col(cols[i]).ft)
                    for i, v in enumerate(vals)
                    if not isinstance(v, A.Default)
                })
        if stmt.on_duplicate:
            raise SQLError("ON DUPLICATE KEY UPDATE not supported yet")
        n = 0
        for r in rows:
            datums = []
            handle = None
            for c in meta.columns:
                if c.name in r:
                    if c.generated is not None:
                        # MySQL 3105: only DEFAULT may target a generated
                        # column (DEFAULT literals never land in `r`)
                        raise SQLError(
                            f"the value specified for generated column {c.name!r} "
                            f"in table {meta.name!r} is not allowed"
                        )
                    d = _coerce_datum(r[c.name], c.ft) if not isinstance(r[c.name], A.ExprNode) else r[c.name]
                else:
                    d = self._eval_const(c.default, c.ft) if c.default is not None else Datum.NULL
                if c.generated is not None:
                    d = Datum.NULL  # recomputed below, never user-supplied
                if meta.handle_col == c.name and not d.is_null():
                    handle = int(d.val)
                    meta.observe_handle(handle)
                datums.append(d)
            self._apply_generated(meta, datums)
            self._check_not_null(meta, datums)
            self._fk_check_child(meta, datums, ts)
            if handle is None:
                handle = meta.alloc_handle()
                if meta.handle_col is not None:
                    i = [c.name for c in meta.columns].index(meta.handle_col)
                    datums[i] = Datum.i64(handle)
            exists = self._read_row(meta, handle, ts) is not None
            if exists:
                # duplicate primary key (ref: ER_DUP_ENTRY / REPLACE / IGNORE)
                if stmt.ignore:
                    continue
                if not stmt.replace:
                    raise SQLError(f"duplicate entry {handle} for key PRIMARY")
            # secondary-unique conflicts: REPLACE deletes every conflicting
            # row; IGNORE skips the new row (ref: executor/replace.go
            # removeRow loop, insert IGNORE ER_DUP_ENTRY-as-warning)
            conflict = self._find_unique_conflict(meta, datums, handle, ts)
            if conflict is not None and stmt.ignore:
                continue
            if conflict is not None and not stmt.replace:
                raise SQLError(f"duplicate entry for unique key {conflict[1].name!r}")
            while conflict is not None:
                c_handle, _c_idx = conflict
                self._lock_rows(meta, [c_handle])
                old_row = self._read_row(meta, c_handle, ts)
                if old_row is not None:
                    self._write_indexes(meta, old_row, c_handle, delete=True)
                    self._buf_delete_row(meta, c_handle, old_row)
                    self.txn.row_delta[meta.table_id] = self.txn.row_delta.get(meta.table_id, 0) - 1
                    n += 1  # MySQL counts each replaced row
                conflict = self._find_unique_conflict(meta, datums, handle, ts)
            self._lock_rows(meta, [handle])
            if exists and stmt.replace and meta.indices:
                # REPLACE drops the old row's index entries; the old row is
                # fetched by its known key (no table scan)
                old_row = self._read_row(meta, handle, ts)
                if old_row is not None:
                    self._write_indexes(meta, old_row, handle, delete=True)
            self._buf_put_row(meta, handle, datums)
            self._write_indexes(meta, datums, handle)
            if not exists:
                n += 1
                self.txn.row_delta[meta.table_id] = self.txn.row_delta.get(meta.table_id, 0) + 1
            elif stmt.replace:
                n += 2  # replaced in place: MySQL counts delete AND insert
        return Result(affected=n)

    def _qualify_tables(self, stmt) -> None:
        qualify_tables_ast(stmt, self.db)

    # ------------------------------------------------ foreign keys
    def _fk_on(self) -> bool:
        return self.sysvars.get_bool("foreign_key_checks")

    def _fk_check_child(self, meta: TableMeta, datums: list, ts: int) -> None:
        """Referential check for an inserted/updated child row (ref:
        pkg/executor/foreign_key.go FKCheckExec on INSERT/UPDATE)."""
        if not self._fk_on() or not meta.foreign_keys:
            return
        pos = {c.name: i for i, c in enumerate(meta.columns)}
        for fk in meta.foreign_keys:
            vals = [datums[pos[c]] for c in fk.cols]
            if any(v.is_null() for v in vals):
                continue  # NULL components never violate (MATCH SIMPLE)
            try:
                parent = self.catalog.table(fk.ref_table)
            except CatalogError:
                continue
            if not self._fk_parent_exists(parent, fk.ref_cols, vals, ts):
                raise SQLError(
                    f"cannot add or update a child row: a foreign key "
                    f"constraint fails ({meta.name}.{fk.name})"
                )

    def _fk_parent_exists(self, parent: TableMeta, cols: list, vals: list, ts: int) -> bool:
        if (
            len(cols) == 1 and parent.handle_col == cols[0]
            and not vals[0].is_null()
        ):
            # referenced column IS the parent's int handle: point read
            # (ref: FK check via the reference's index/PK point lookup)
            try:
                return self._read_row(parent, int(vals[0].val), ts) is not None
            except (TypeError, ValueError):
                return False
        where = None
        for c, v in zip(cols, vals):
            e = A.BinaryOp("eq", A.ColumnName(c), A.Literal(v, "datum"))
            where = e if where is None else A.BinaryOp("and", where, e)
        return bool(self._scan_rows_with_handles(parent, where, ts, None, A.Limit(A.Literal(1, "int"))))

    def _fk_referencing(self, parent: TableMeta):
        """[(child_meta, FKMeta)] of every FK pointing at `parent` —
        memoized per schema version (DML loops ask once per row)."""
        cache = getattr(self, "_fk_ref_cache", None)
        if cache is None or cache[0] != self.catalog.version:
            refmap: dict = {}
            for name in self.catalog.tables():
                m = self.catalog.table(name)
                for fk in m.foreign_keys:
                    refmap.setdefault(fk.ref_table, []).append((m, fk))
            cache = (self.catalog.version, refmap)
            self._fk_ref_cache = cache
        return cache[1].get(parent.name, [])

    def _fk_on_parent_delete(self, meta: TableMeta, rows: list, ts: int, depth: int = 0) -> int:
        from ..exec.executor import datum_group_key  # noqa: PLC0415
        """RESTRICT / CASCADE / SET NULL on deleting parent rows (ref:
        pkg/executor/foreign_key.go FKCascadeExec). Returns cascaded-row
        count. `rows` are the parent row datum lists."""
        if not self._fk_on() or not rows:
            return 0
        if depth > 15:
            raise SQLError("foreign key cascade depth exceeded")
        n = 0
        for child, fk in self._fk_referencing(meta):
            ppos = {c.name: i for i, c in enumerate(meta.columns)}
            keysets = {
                tuple(datum_group_key(r[ppos[c]]) for c in fk.ref_cols)
                for r in rows
            }
            cpos = {c.name: i for i, c in enumerate(child.columns)}
            matched = [
                (h, r) for h, r in self._scan_rows_with_handles(child, None, ts)
                if not any(r[cpos[c]].is_null() for c in fk.cols)
                and tuple(datum_group_key(r[cpos[c]]) for c in fk.cols) in keysets
            ]
            if not matched:
                continue
            if fk.on_delete in ("restrict", "no_action"):
                raise SQLError(
                    f"cannot delete or update a parent row: a foreign key "
                    f"constraint fails ({child.name}.{fk.name})"
                )
            self._lock_rows(child, [h for h, _ in matched])
            if fk.on_delete == "cascade":
                n += self._fk_on_parent_delete(child, [r for _, r in matched], ts, depth + 1)
                for handle, row in matched:
                    self._buf_delete_row(child, handle, row)
                    self._write_indexes(child, row, handle, delete=True)
                self.txn.row_delta[child.table_id] = self.txn.row_delta.get(child.table_id, 0) - len(matched)
                n += len(matched)
            else:  # set_null
                for handle, row in matched:
                    new_row = list(row)
                    for c in fk.cols:
                        new_row[cpos[c]] = Datum.NULL
                    self._write_indexes(child, row, handle, delete=True)
                    self._buf_put_row(child, handle, new_row)
                    self._write_indexes(child, new_row, handle)
        return n

    def _fk_on_parent_update(self, meta: TableMeta, old_row: list, new_row: list, ts: int) -> None:
        """ON UPDATE actions when a referenced key changes (ref:
        executor/foreign_key.go onUpdate handling)."""
        if not self._fk_on():
            return
        from ..exec.executor import datum_group_key

        refs = self._fk_referencing(meta)
        if not refs:
            return
        ppos = {c.name: i for i, c in enumerate(meta.columns)}
        for child, fk in refs:
            old_key = tuple(datum_group_key(old_row[ppos[c]]) for c in fk.ref_cols)
            new_key = tuple(datum_group_key(new_row[ppos[c]]) for c in fk.ref_cols)
            if old_key == new_key:
                continue
            cpos = {c.name: i for i, c in enumerate(child.columns)}
            matched = [
                (h, r) for h, r in self._scan_rows_with_handles(child, None, ts)
                if not any(r[cpos[c]].is_null() for c in fk.cols)
                and tuple(datum_group_key(r[cpos[c]]) for c in fk.cols) == old_key
            ]
            if not matched:
                continue
            if fk.on_update in ("restrict", "no_action"):
                raise SQLError(
                    f"cannot delete or update a parent row: a foreign key "
                    f"constraint fails ({child.name}.{fk.name})"
                )
            self._lock_rows(child, [h for h, _ in matched])
            for handle, row in matched:
                nrow = list(row)
                for ci, pc in zip(fk.cols, fk.ref_cols):
                    nrow[cpos[ci]] = Datum.NULL if fk.on_update == "set_null" else new_row[ppos[pc]]
                self._write_indexes(child, row, handle, delete=True)
                self._buf_put_row(child, handle, nrow)
                self._write_indexes(child, nrow, handle)

    def _check_not_null(self, meta: TableMeta, datums: list) -> None:
        """NOT NULL (incl. implicit PK not-null) enforcement at write
        (ref: table/column.go CheckNotNull)."""
        from ..types import Flag

        for c, d in zip(meta.columns, datums):
            if d.is_null() and bool(c.ft.flag & Flag.NotNull) and not c.auto_increment \
                    and c.name != meta.handle_col:
                raise SQLError(f"column {c.name!r} cannot be null")

    def _apply_generated(self, meta: TableMeta, datums: list) -> None:
        """Materialize GENERATED ALWAYS AS columns from the row, in column
        order (later generated columns may reference earlier ones — the
        reference evaluates in dependency order, pkg/table/column.go
        CalcOnce ordering; column order subsumes it for valid schemas)."""
        if not any(c.generated is not None for c in meta.columns):
            return
        cached = getattr(meta, "_gen_cache", None)
        if cached is None or cached[0] != self.catalog.version:
            scope = _Scope([_TableRef(meta, meta.name.rsplit(".", 1)[-1], 0)])
            lw = _Lowerer(scope)
            prog = []
            for i, c in enumerate(meta.columns):
                if c.generated is not None:
                    prog.append((i, c, lw.lower_base(c.generated)))
            cached = (self.catalog.version, prog)
            meta._gen_cache = cached  # re-lowered per schema version only
        ev = RefEvaluator()
        for i, c, e in cached[1]:
            try:
                datums[i] = _coerce_datum(ev.eval(e, datums), c.ft)
            except SQLError:
                raise
            except Exception as exc:  # noqa: BLE001 — surface as SQL error
                raise SQLError(f"generated column {c.name!r}: {exc}") from exc

    def _read_row(self, meta: TableMeta, handle: int, ts: int) -> list | None:
        """Point read of one row by handle with txn-buffer overlay
        (ref: PointGet reading through the memdb first)."""
        from ..codec.rowcodec import decode_row_to_datum_map

        if self.txn is not None:
            ops = self.txn.row_ops.get(meta.table_id, {})
            if handle in ops:
                row = ops[handle]
                return list(row) if row is not None else None
        val = None
        if meta.partition is not None and meta.handle_col == meta.partition.col:
            # PK == partition column: the handle VALUE routes directly; a
            # value beyond the last RANGE bound simply has no row (MySQL
            # returns the empty set — the route() raise is for INSERT)
            from .catalog import CatalogError as _CE

            try:
                pid = meta.partition.route(handle)
            except _CE:
                return None
            val = self.store.kv.get(tablecodec.encode_row_key(pid, handle), ts)
        else:
            for pid in meta.physical_ids():
                val = self.store.kv.get(tablecodec.encode_row_key(pid, handle), ts)
                if val is not None:
                    break
        if val is None:
            return None
        dmap = decode_row_to_datum_map(val, {c.col_id: c.ft for c in meta.columns})
        return [
            fill_origin_default(val, c.col_id, c.origin_default, dmap[c.col_id])
            for c in meta.columns
        ]

    def _scan_rows_with_handles(self, meta: TableMeta, where: A.ExprNode | None, ts: int,
                                order_by: list | None = None, limit=None):
        """Row-level scan for UPDATE/DELETE: handles + full rows, filtered
        host-side with the reference evaluator (writes are not hot).
        order_by/limit implement `UPDATE/DELETE ... ORDER BY ... LIMIT n`."""
        scope = _Scope([_TableRef(meta, meta.name.rsplit(".", 1)[-1], 0)])
        lw = _Lowerer(scope)
        cond = lw.lower_base(where) if where is not None else None
        pinned = None
        if where is not None and meta.handle_col is not None:
            got = self._extract_pk_handles(
                meta, meta.name.rsplit(".", 1)[-1].lower(), where)
            if got is not None:
                pinned = got[0]
        if pinned is not None:
            # point-write fast path: WHERE pins the primary
            # key, so read exactly those rows instead of scanning the
            # table. _read_row already applies the txn overlay and
            # partition routing; the FULL where still evaluates below, so
            # filtering is byte-equivalent to the scan path.
            by_handle = {}
            for h in pinned:
                row = self._read_row(meta, h, ts)
                if row is not None:
                    by_handle[h] = list(row)
        else:
            cols = [ColumnInfo(-1, HANDLE_FT)] + list(meta.scan_columns())
            scan = TableScan(meta.table_id, tuple(cols))
            dag = DAGRequest((scan,), output_offsets=tuple(range(len(cols))))
            ranges = [r for pid in meta.physical_ids() for r in full_table_ranges(pid)]
            chunk = execute_root(self.store, dag, ranges, start_ts=ts)
            by_handle = {int(r[0].val): r[1:] for r in chunk.rows()}
            if self.txn is not None:
                # read-your-writes overlay (the UnionScan analog)
                for h, row in self.txn.row_ops.get(meta.table_id, {}).items():
                    if row is None:
                        by_handle.pop(h, None)
                    else:
                        by_handle[h] = list(row)
        ev = RefEvaluator()
        out = []
        for handle in sorted(by_handle):
            row = by_handle[handle]
            if cond is None or _truth(ev.eval(cond, row)):
                out.append((handle, row))
        if order_by:
            import functools

            from ..expr.eval_ref import compare

            items = [(lw.lower_base(b.expr), b.desc) for b in order_by]

            def cmp(a, b):
                for e, desc in items:
                    x, y = ev.eval(e, a[1]), ev.eval(e, b[1])
                    if x.is_null() and y.is_null():
                        continue
                    c = -1 if x.is_null() else (1 if y.is_null() else compare(x, y))
                    if c:
                        return -c if desc else c
                return 0

            out.sort(key=functools.cmp_to_key(cmp))
        if limit is not None:  # limit: A.Limit
            cnt = limit.count
            n = int(cnt.value) if isinstance(cnt, A.Literal) else int(cnt)
            out = out[:n]
        return out

    def _update(self, stmt: A.UpdateStmt) -> Result:
        if not isinstance(stmt.table, A.TableName):
            raise SQLError("multi-table UPDATE not supported")
        meta = self.catalog.table(stmt.table.name)
        ts = self.txn.start_ts
        matched = self._scan_rows_with_handles(meta, stmt.where, ts, stmt.order_by, stmt.limit)
        self._lock_rows(meta, [h for h, _ in matched])
        scope = _Scope([_TableRef(meta, meta.name.rsplit(".", 1)[-1], 0)])
        lw = _Lowerer(scope)
        col_pos = {c.name: i for i, c in enumerate(meta.columns)}
        assigns = []
        for a in stmt.assignments:
            cm = meta.col(a.column.name if isinstance(a.column, A.ColumnName) else str(a.column))
            if cm.generated is not None:
                raise SQLError(
                    f"the value specified for generated column {cm.name!r} "
                    f"in table {meta.name!r} is not allowed"
                )
            assigns.append((cm, lw.lower_base(a.expr)))
        ev = RefEvaluator()
        moves_handle = meta.handle_col is not None and any(cm.name == meta.handle_col for cm, _ in assigns)
        for handle, row in matched:
            new_row = list(row)
            for cm, e in assigns:
                # MySQL applies SET left-to-right over already-updated values
                new_row[col_pos[cm.name]] = _coerce_datum(ev.eval(e, new_row), cm.ft)
            self._apply_generated(meta, new_row)
            self._check_not_null(meta, new_row)
            self._fk_check_child(meta, new_row, ts)
            self._fk_on_parent_update(meta, row, new_row, ts)
            new_handle = handle
            if moves_handle:
                d = new_row[col_pos[meta.handle_col]]
                if d.is_null():
                    raise SQLError(f"column {meta.handle_col!r} cannot be NULL")
                new_handle = int(d.val)
            # ALL constraint checks before ANY mutation — a failed UPDATE
            # must not leave tombstoned index entries behind
            if new_handle != handle and self._read_row(meta, new_handle, ts) is not None:
                raise SQLError(f"duplicate entry {new_handle} for key PRIMARY")
            self._check_unique(meta, new_row, new_handle, ts, old_handle=handle)
            if new_handle != handle:
                # PK change moves the row to a new key (ref: updateRecord's
                # remove+add when the handle changes)
                self._buf_delete_row(meta, handle, row)
                self._lock_rows(meta, [new_handle])
            elif meta.partition is not None and meta.pid_for_row(row) != meta.pid_for_row(new_row):
                # partition-column change moves the row across partitions
                # (MySQL row movement): drop the old physical key
                self._buf_delete_row(meta, handle, row)
            self._write_indexes(meta, row, handle, delete=True)
            self._buf_put_row(meta, new_handle, new_row)
            self._write_indexes(meta, new_row, new_handle)
        return Result(affected=len(matched))

    def _delete(self, stmt: A.DeleteStmt) -> Result:
        if stmt.multi_table:
            raise SQLError("multi-table DELETE is not supported yet")
        meta = self.catalog.table(stmt.table.name)
        ts = self.txn.start_ts
        matched = self._scan_rows_with_handles(meta, stmt.where, ts, stmt.order_by, stmt.limit)
        self._lock_rows(meta, [h for h, _ in matched])
        self._fk_on_parent_delete(meta, [r for _, r in matched], ts)
        for handle, row in matched:
            self._buf_delete_row(meta, handle, row)
            self._write_indexes(meta, row, handle, delete=True)
        self.txn.row_delta[meta.table_id] = self.txn.row_delta.get(meta.table_id, 0) - len(matched)
        return Result(affected=len(matched))

    def _truncate(self, stmt) -> Result:
        meta = self.catalog.table(stmt.table.name)
        ts = self.txn.start_ts
        matched = self._scan_rows_with_handles(meta, None, ts)
        for handle, row in matched:
            self._buf_delete_row(meta, handle, row)
            self._write_indexes(meta, row, handle, delete=True)
        self.txn.row_delta[meta.table_id] = -meta.row_count
        return Result(affected=len(matched))

    def _analyze(self, stmt: A.AnalyzeTableStmt) -> Result:
        """ANALYZE TABLE: full-scan histogram/TopN/NDV build into the
        catalog's stats registry (ref: executor/analyze.go driving
        cophandler/analyze.go collection; exact rather than sampled since
        the whole column is in-process)."""
        from .stats import TableStats, build_column_stats

        self._implicit_commit()
        for t in stmt.tables:
            meta = self.catalog.table(t.name)
            ts = self.store.next_ts()
            rows = [row for _, row in self._scan_rows_with_handles(meta, None, ts)]
            tstats = TableStats(row_count=len(rows), version=ts)
            want = {c.lower() for c in stmt.columns} if stmt.columns else None
            if want is not None:
                unknown = want - {c.name for c in meta.columns}
                if unknown:
                    raise SQLError(f"unknown column {sorted(unknown)[0]!r} in ANALYZE of {meta.name!r}")
            for i, cm in enumerate(meta.columns):
                if want is not None and cm.name not in want:
                    continue
                tstats.columns[cm.name] = build_column_stats([r[i] for r in rows])
            self.catalog.stats[meta.table_id] = tstats
            meta.row_count = len(rows)  # ANALYZE also repairs the stat
        return Result()

    # ------------------------------------------------------------------
    def _session_tracker(self):
        """Per-session memory tracker: every query tracker parents here,
        so one session's concurrent + accumulated staging shares a quota
        (tidb_mem_quota_session; 0 = unlimited). The breach action spills
        the store's device-resident staging caches to host before the
        cancel fires — the util/memory.py action chain."""
        from ..util.memory import MemTracker

        t = getattr(self, "_mem_tracker", None)
        if t is None:
            def _spill(tr, _n):
                from ..util import metrics

                self.store.evict_caches()
                metrics.MEM_EVICTIONS.inc()

            t = self._mem_tracker = MemTracker("session", action=_spill)
        q = self.sysvars.get_int("tidb_mem_quota_session")
        t.quota = q or None
        return t

    def _try_point_get(self, stmt: A.SelectStmt, rw) -> tuple | None:
        """PointGet/BatchPointGet fast path (ref: pkg/executor/point_get.go,
        batch_point_get.go; planner TryFastPlan): single real table, WHERE
        pins the integer primary key to constants -> read rows by key,
        bypassing distsql/coprocessor entirely. Split into shape DETECTION
        (shared with the plan cache's pointget tier) and EXECUTION."""
        det = self._point_get_detect(stmt, rw.mat_dict())
        if det is None:
            return None
        return self._exec_point_get(stmt, *det)

    def _point_get_detect(self, stmt: A.SelectStmt, mat) -> tuple | None:
        """Shape check + handle extraction: (meta, alias, handles, rest
        conjuncts) when the statement is the point-get shape, else None.
        Pure — reads the catalog but executes nothing."""
        if (
            not isinstance(stmt.from_clause, A.TableName)
            or stmt.group_by or stmt.having is not None or stmt.distinct
            or stmt.from_clause.name.lower() in mat
        ):
            return None
        try:
            meta = self.catalog.table(stmt.from_clause.name)
        except CatalogError:
            return None
        if meta.handle_col is None:
            return None
        alias = (stmt.from_clause.alias or meta.name).lower()
        pinned = self._extract_pk_handles(meta, alias, stmt.where)
        if pinned is None:
            return None
        handles, rest = pinned
        # any aggregate/window in the select list leaves the fast path
        from .planner import _has_agg, _has_window

        for f in stmt.fields:
            e = f.expr if isinstance(f, A.SelectField) else f
            if not isinstance(e, A.Star) and (_has_agg(e) or _has_window(e)):
                return None
        return meta, alias, handles, rest

    def _extract_pk_handles(self, meta: TableMeta, alias: str, where) -> tuple | None:
        """WHERE-clause handle extraction shared by the point-get fast
        path and the DML point-write tier: (pinned handles,
        residual conjuncts) when the conjuncts pin the integer primary
        key through eq/IN literals, else None. Pure — executes nothing."""
        from .planner import _lower_literal, _split_conjuncts

        conjs = _split_conjuncts(where)
        if any(isinstance(c, A.SemiJoinCond) for c in conjs):
            return None  # decorrelated subquery markers need the full planner
        handles: list | None = None
        rest: list = []
        for c in conjs:
            got = None
            if isinstance(c, A.BinaryOp) and c.op == "eq":
                for lhs, rhs in ((c.left, c.right), (c.right, c.left)):
                    if (
                        isinstance(lhs, A.ColumnName)
                        and lhs.name.lower() == meta.handle_col
                        and (not lhs.table or lhs.table.lower() == alias)
                        and isinstance(rhs, A.Literal) and rhs.kind in ("int", "datum")
                    ):
                        d = _lower_literal(rhs).datum
                        if not d.is_null() and isinstance(d.val, int):
                            got = [int(d.val)]
                        break
            elif (
                isinstance(c, A.InList) and not c.negated
                and isinstance(c.expr, A.ColumnName)
                and c.expr.name.lower() == meta.handle_col
                and (not c.expr.table or c.expr.table.lower() == alias)
                and all(isinstance(i, A.Literal) and i.kind in ("int", "datum") for i in c.items)
            ):
                ds = [_lower_literal(i).datum for i in c.items]
                if all(not d.is_null() and isinstance(d.val, int) for d in ds):
                    got = sorted({int(d.val) for d in ds})
            if got is not None:
                handles = got if handles is None else [h for h in handles if h in set(got)]
            else:
                rest.append(c)
        if handles is None:
            return None
        return handles, rest

    def _exec_point_get(self, stmt: A.SelectStmt, meta, alias, handles, rest) -> tuple:
        """Execute a detected point get: read the pinned handles, filter
        the residual conjuncts, evaluate the select list on the host.
        Plan-cache-hit statements (the _coalesce_hint window) first try
        the store's cross-session coalescer: concurrent point gets park
        briefly and ship as ONE batched device launch."""
        by_handle = self._coalesce_point_get(meta, handles)
        if by_handle is not None:
            rows = [by_handle[h] for h in handles if h in by_handle]
        else:
            ts = self._pin_read_ts()
            try:
                rows = []
                for h in handles:
                    row = self._read_row(meta, h, ts)
                    if row is not None:
                        rows.append(row)
            finally:
                self._unpin_read_ts(ts)
        scope = _Scope([_TableRef(meta, alias, 0)])
        lw = _Lowerer(scope)
        ev = RefEvaluator()
        if rest:
            conds = [lw.lower_base(c) for c in rest]
            rows = [r for r in rows if all(_truth(ev.eval(c, r)) for c in conds)]
        fields = []
        for f in stmt.fields:
            e = f.expr if isinstance(f, A.SelectField) else f
            if isinstance(e, A.Star):
                fields.extend(A.SelectField(A.ColumnName(cm.name, alias), cm.name) for cm in meta.columns)
            else:
                fields.append(f)
        aliases = {f.alias.lower(): f.expr for f in fields if isinstance(f, A.SelectField) and f.alias}
        lw = _Lowerer(scope, aliases)
        exprs = [lw.lower_base(f.expr) for f in fields]
        out = [[ev.eval(e, r) for e in exprs] for r in rows]
        if stmt.order_by:
            import functools

            from ..expr.eval_ref import compare

            def positional(e):
                # ORDER BY 2 = select-list ordinal (matches the planner)
                if isinstance(e, A.Literal) and e.kind == "int":
                    i = int(e.value)
                    if not (1 <= i <= len(fields)):
                        raise SQLError(f"ORDER BY position {i} out of range")
                    return fields[i - 1].expr
                return e

            items = [(lw.lower_base(positional(b.expr)), b.desc) for b in stmt.order_by]
            # ORDER BY evaluates against the source row, so sort pairs
            paired = list(zip(rows, out))

            def cmp2(x, y):
                for e, desc in items:
                    a, b = ev.eval(e, x[0]), ev.eval(e, y[0])
                    if a.is_null() and b.is_null():
                        continue
                    c = -1 if a.is_null() else (1 if b.is_null() else compare(a, b))
                    if c:
                        return -c if desc else c
                return 0

            paired.sort(key=functools.cmp_to_key(cmp2))
            out = [o for _, o in paired]
        if stmt.limit is not None:
            def _n(e, dflt):
                if e is None:
                    return dflt
                if isinstance(e, A.Literal):
                    return int(e.value)
                return int(e)

            off = _n(stmt.limit.offset, 0)
            out = out[off : off + _n(stmt.limit.count, len(out))]
        from .planner import _field_label

        names = [_field_label(f) for f in fields]
        return names, [e.ft for e in exprs], out

    def _coalesce_point_get(self, meta: TableMeta, handles) -> dict | None:
        """Park this point get in the store's micro-batch window
       : {handle: row} on a coalesced read, None when the
        statement must take the single path — coalescing off, a session
        state that owns its own snapshot (txn, tidb_snapshot), or a
        value-routed (partitioned) table whose keys aren't
        handle-addressed. Window faults also return None: the coalescer
        reports the lane's fall-out and the single path re-reads."""
        coalescer = getattr(self.store, "coalescer", None)
        if (
            coalescer is None
            or not self._coalesce_hint
            or self.txn is not None
            or self.sysvars.get("tidb_snapshot")
            or meta.partition is not None
            or meta.table_id < 0
            or not self.sysvars.get_bool("tidb_tpu_enable_coalesce")
        ):
            return None
        return coalescer.point_get(
            meta, handles,
            tag=topsql.current_tag(),
            wait_us=self.sysvars.get_int("tidb_tpu_coalesce_wait_us"),
            max_lanes=self.sysvars.get_int("tidb_tpu_coalesce_max_lanes"),
        )

    def _load_stats_json(self, path: str) -> None:
        """Minimal LoadStatsFromJSON: count/NDV/null_count/TopN land in the
        stats registry (histogram bucket decode is format-versioned in the
        reference; NDV+TopN carry the planner decisions here)."""
        import json as _json

        from .stats import ColumnStats, TableStats

        blob = _json.load(open(path))
        meta = self.catalog.table(blob.get("table_name", "") or "")
        tstats = TableStats(row_count=int(blob.get("count", 0)), version=self.store.next_ts())
        for cn, cd in (blob.get("columns") or {}).items():
            hist = cd.get("histogram") or {}
            cs = ColumnStats(
                null_count=int(cd.get("null_count", 0)),
                ndv=int(hist.get("ndv", cd.get("distinct_count", 0) or 0)),
                total=int(blob.get("count", 0)) - int(cd.get("null_count", 0)),
            )
            tstats.columns[cn.lower()] = cs
        self.catalog.stats[meta.table_id] = tstats
        meta.row_count = tstats.row_count

    def _admin(self, stmt: A.AdminStmt) -> Result:
        """ADMIN SHOW DDL JOBS / CHECK TABLE (ref: pkg/executor/admin.go)."""
        if stmt.kind == "show_ddl_jobs":
            rows = []
            for j in reversed(self.catalog.ddl_jobs.view()):
                rows.append([
                    Datum.i64(j.job_id), Datum.string(j.job_type), Datum.string(j.table),
                    Datum.string(j.schema_state), Datum.string(j.state),
                    Datum.string(j.error or ""),
                ])
            return Result(
                columns=["JOB_ID", "JOB_TYPE", "TABLE", "SCHEMA_STATE", "STATE", "ERROR"],
                rows=rows,
            )
        if stmt.kind == "check_table":
            # index consistency check (ref: admin check table): every row's
            # index entries exist and no dangling entries remain
            for t in stmt.tables:
                meta = self.catalog.table(t.name)
                ts = self.store.next_ts()
                rows = self._scan_rows_with_handles(meta, None, ts)
                pos = {c.name: i for i, c in enumerate(meta.columns)}
                for idx in meta.indices:
                    if idx.state != "public":
                        continue  # a building index is legitimately partial
                    live = set()
                    for handle, row in rows:
                        vals = [row[pos[cn]] for cn in idx.col_names] + [Datum.i64(handle)]
                        key = tablecodec.encode_index_key(meta.table_id, idx.index_id, vals)
                        live.add(key)
                        if self.store.kv.get(key, ts) is None:
                            raise SQLError(
                                f"admin check: row {handle} missing from index {idx.name!r}"
                            )
                    prefix = tablecodec.encode_index_key(meta.table_id, idx.index_id, [])
                    for key, _ in self.store.kv.scan(prefix, prefix + b"\xff", ts):
                        if key not in live:
                            raise SQLError(f"admin check: dangling entry in index {idx.name!r}")
            return Result()
        return Result()

    # ------------------------------------------------------------------
    def _show(self, stmt) -> Result:
        kind = getattr(stmt, "kind", "")
        if kind in ("create_table", "create_view"):
            vm = self.catalog.view_of(stmt.table.name)
            if kind == "create_view" and vm is None:
                raise SQLError(f"unknown view {stmt.table.name!r}")
            if vm is not None:
                cols = f" ({', '.join(vm.columns)})" if vm.columns else ""
                vshort = vm.name.rsplit(".", 1)[-1]
                return Result(
                    columns=["View", "Create View"],
                    rows=[[Datum.string(vshort),
                           Datum.string(f"CREATE VIEW `{vshort}`{cols} AS {vm.select_sql}")]],
                )
            from .showddl import show_create_table

            meta = self.catalog.table(stmt.table.name)
            short = meta.name.rsplit(".", 1)[-1]
            return Result(
                columns=["Table", "Create Table"],
                rows=[[Datum.string(short), Datum.string(show_create_table(meta))]],
            )
        if kind == "columns":
            meta = self.catalog.table(stmt.table.name)
            rows = [
                [Datum.string(cn), Datum.string(ctype), Datum.string(nullable),
                 Datum.string(key), Datum.string(dflt), Datum.string(extra)]
                for cn, ctype, nullable, key, dflt, extra in self._column_descs(meta)
            ]
            return Result(columns=["Field", "Type", "Null", "Key", "Default", "Extra"], rows=rows)
        if kind == "index":
            meta = self.catalog.table(stmt.table.name)
            rows = [
                [Datum.string(meta.name), Datum.i64(nu), Datum.string(iname),
                 Datum.i64(seq), Datum.string(cn)]
                for nu, iname, seq, cn in self._index_descs(meta)
            ]
            return Result(columns=["Table", "Non_unique", "Key_name", "Seq_in_index", "Column_name"], rows=rows)
        if kind == "bindings":
            cols = ["Original_sql", "Bind_sql", "Default_db", "Status", "Source", "Sql_digest"]
            store = self.catalog.bindings if stmt.global_scope else self._session_bindings()
            rows = [
                [Datum.string(r["original"]), Datum.string(r["bind"]),
                 Datum.string(r.get("db", "")), Datum.string("enabled"),
                 Datum.string("manual"), Datum.string(d)]
                for d, r in store.items()
            ]
            return Result(columns=cols, rows=rows)
        if kind == "placement":
            # SHOW PLACEMENT (ref: executor/show_placement.go — the
            # reference lists placement policies; our placement unit is
            # the region->store map the PD schedules, so each region is a
            # target with its store binding and scheduling state)
            pd = getattr(self.store, "pd", None)
            if pd is None:
                return Result(columns=["Target", "Placement", "Scheduling_State"], rows=[])
            rows = []
            for st in pd.stores_view():
                rows.append([
                    Datum.string(f"STORE {st['store_id']}"),
                    Datum.string(
                        f"regions={st['region_count']} size={st['region_size']} "
                        f"keys={st['region_keys']} leaders={st.get('leader_count', 0)} "
                        f"peers={st.get('peer_count', 0)} "
                        f"safe_ts_lag={st.get('safe_ts_lag', 0)}"
                    ),
                    Datum.string(
                        f"hot_read={st['hot_read_regions']} hot_write={st['hot_write_regions']}"
                    ),
                ])
            for r in pd.regions_view():
                peers = ",".join(str(p) for p in r.get("peers", ()))
                rows.append([
                    Datum.string(f"REGION {r['region_id']}"),
                    Datum.string(
                        f"store={r['store']} leader={r.get('leader', r['store'])} "
                        f"peers=[{peers}] range=[{r['start_key'][:24]},"
                        f"{r['end_key'][:24]}) epoch={r['epoch']} "
                        f"size={r['approximate_size']} keys={r['approximate_keys']}"
                    ),
                    Datum.string(pd.scheduling_state(r["region_id"])),
                ])
            return Result(columns=["Target", "Placement", "Scheduling_State"], rows=rows)
        if kind == "columnar":
            # SHOW COLUMNAR TABLES (ref: information_schema
            # .tiflash_replica): one row per replicated table — feed
            # state, delta/stable layer sizes, and the applied
            # resolved-ts frontier the scan-readiness gate consults
            rows = []
            for v in self.store.columnar.views():
                if not _show_like(stmt, v["table"]):
                    continue
                rows.append([
                    Datum.string(v["table"]), Datum.string(v["state"]),
                    Datum.i64(v["pids"]), Datum.i64(v["delta_rows"]),
                    Datum.i64(v["stable_rows"]), Datum.i64(v["stable_chunks"]),
                    Datum.i64(v["applied_ts"]), Datum.i64(v["stable_ts"]),
                    Datum.i64(v["resolved_ts_lag"]), Datum.i64(v["compactions"]),
                ])
            return Result(
                columns=["Table", "State", "Pids", "Delta_rows", "Stable_rows",
                         "Stable_chunks", "Applied_ts", "Stable_ts",
                         "Resolved_lag", "Compactions"],
                rows=rows,
            )
        if kind == "changefeeds":
            # SHOW CHANGEFEEDS (ref: TiCDC `cli changefeed list`): one row
            # per feed with its state, frontier, and emission counts
            rows = []
            for v in self.store.cdc.views():
                if not _show_like(stmt, v["name"]):
                    continue
                rows.append([
                    Datum.string(v["name"]), Datum.string(v["state"]),
                    Datum.string(v["sink"]), Datum.i64(v["start_ts"]),
                    Datum.i64(v["checkpoint_ts"]), Datum.i64(v["resolved_lag"]),
                    Datum.i64(v["pending"]), Datum.i64(v["emitted"]),
                    Datum.i64(v["skipped"]), Datum.string(v["error"]),
                ])
            return Result(
                columns=["Changefeed", "State", "Sink", "Start_ts", "Checkpoint_ts",
                         "Resolved_lag", "Pending", "Emitted", "Skipped", "Error"],
                rows=rows,
            )
        if kind == "backup_logs":
            # SHOW BACKUP LOGS (ref: `br log status`): one row
            # per attached log backup with its durable checkpoint chain
            from ..br import log_backup_views

            rows = [
                [
                    Datum.string(v["destination"]), Datum.string(v["changefeed"]),
                    Datum.string(v["state"]), Datum.i64(v["start_ts"]),
                    Datum.i64(v["checkpoint_ts"]), Datum.i64(v["resolved_lag"]),
                    Datum.i64(v["segments"]), Datum.i64(v["events"]),
                ]
                for v in log_backup_views(self.store)
            ]
            return Result(
                columns=["Destination", "Changefeed", "State", "Start_ts",
                         "Checkpoint_ts", "Resolved_lag", "Segments", "Events"],
                rows=rows,
            )
        if kind == "status":
            from ..util import metrics

            rows = [
                [Datum.string(series), Datum.string(value)]
                for series, value in metrics.REGISTRY.sample_lines()
            ]
            return Result(columns=["Variable_name", "Value"], rows=rows)
        if kind == "tables":
            names = sorted(set(self.catalog.tables()) | set(self.catalog.view_names()))
            # current database only, short names (multi-db catalog keys
            # are "db.table"; the default db owns the unqualified keys)
            if self.db == "test":
                names = [t for t in names if "." not in t]
            else:
                pre = self.db + "."
                names = [t[len(pre):] for t in names if t.startswith(pre)]
            names = [t for t in names if _show_like(stmt, t)]
            hdr = f"Tables_in_{self.db}"
            pat = getattr(stmt, "pattern", None)
            if pat:
                hdr += f" ({pat})"
            return Result(columns=[hdr], rows=[[Datum.string(t)] for t in names])
        if kind == "databases":
            pat = getattr(stmt, "pattern", None)
            hdr = "Database" + (f" ({pat})" if pat else "")
            dbs = sorted({"information_schema"} | self.catalog.databases)
            dbs = [d for d in dbs if _show_like(stmt, d)]
            return Result(columns=[hdr], rows=[[Datum.string(d)] for d in dbs])
        if kind == "variables":
            return Result(
                columns=["Variable_name", "Value"],
                rows=[
                    [Datum.string(k), Datum.string(v)]
                    for k, v in self.sysvars.items()
                    if _show_like(stmt, k)
                ],
            )
        return Result()

    def _explain(self, stmt) -> Result:
        inner = stmt.target
        probe = self._take_probe()  # the INNER statement's digest probe
        if isinstance(inner, A.SelectStmt):
            bound = self._match_binding(inner)
            if bound is not None:
                inner = bound  # binding hints grafted on
        if not isinstance(inner, A.SelectStmt):
            return Result()
        import copy

        from .subquery import SubqueryError

        # plan-cache attribution: plain EXPLAIN shows
        # whether the shape is cacheable (typed decline reason otherwise);
        # EXPLAIN ANALYZE re-arms the probe so the run consults the cache
        # for real and reports hit/miss in its plan_cache row
        pc_line = None
        if (probe is not None and isinstance(inner, A.SelectStmt)
                and self.sysvars.get_bool("tidb_enable_plan_cache")):
            from .plancache import shape_decline

            r = shape_decline(inner, self, probe)
            pc_line = "plan_cache: cacheable" if r is None else f"plan_cache: decline({r})"
        analyze_ast = copy.deepcopy(inner) if getattr(stmt, "analyze", False) else None
        if (analyze_ast is not None and probe is not None
                and isinstance(inner, A.SelectStmt)):
            self._stmt_probe = probe
        rw = self._new_rewriter(None)
        try:
            rw.process_ctes(inner.ctes)
            inner.ctes = []
            if inner.from_clause is None:
                return Result(columns=["plan"], rows=[[Datum.string("constant select")]])
            rw.rewrite_select(inner)
            self._bind_information_schema(inner.from_clause, rw)
            plan = plan_select(
                inner, self.catalog, mat=rw.mat_dict(),
                enable_index_merge=self.sysvars.get_bool("tidb_enable_index_merge"),
            )
        except (SubqueryError, PlanError, CatalogError) as exc:
            raise SQLError(str(exc)) from exc
        from ..distsql import split_dag

        rp = split_dag(plan.dag)
        if analyze_ast is not None:
            return self._explain_analyze(analyze_ast, rp)
        lines = [f"access: {plan.access_path}"]
        lines += [f"push[{type(e).__name__}]" for e in rp.push_dag.executors]
        if rp.root_dag is not None:
            lines += [f"root[{type(e).__name__}]" for e in rp.root_dag.executors[1:]]
        if pc_line is not None:
            lines.append(pc_line)
        return Result(columns=["plan"], rows=[[Datum.string(s)] for s in lines])

    def _explain_analyze(self, analyze_ast, rp) -> Result:
        """EXPLAIN ANALYZE: run the query through the NORMAL select path (so
        the feature gate, txn dirty-table shadowing, and the memory quota
        all apply exactly as they would to the statement itself) while a
        sink collects the coprocessor exec summaries
        (ref: tipb.ExecutorExecutionSummary consumed at
        pkg/distsql/select_result.go:499; EXPLAIN ANALYZE columns in
        pkg/executor/explain.go)."""
        from ..exec.dag import executor_walk

        sink: list = []
        self._explain_sink = sink
        self._last_plan_cache = None
        try:
            _, _, out_rows = self._run_select(analyze_ast, None)
        finally:
            self._explain_sink = None
        # dict entries are batched-dispatch attribution riding the sink
        # alongside the per-task summary lists (distsql/root.py)
        batch_stats = [e for e in sink if isinstance(e, dict)]
        sink = [e for e in sink if not isinstance(e, dict)]
        names = [type(e).__name__ for e in executor_walk(rp.push_dag.executors)]
        rows_sum = [0] * len(names)
        time_ns = [0] * len(names)
        compile_ns = [0] * len(names)
        cache_hits = [0] * len(names)
        bytes_sum = [0] * len(names)
        for task_summaries in sink:
            for i, s in enumerate(task_summaries[: len(names)]):
                rows_sum[i] += s.num_produced_rows
                time_ns[i] += s.time_processed_ns
                compile_ns[i] += getattr(s, "time_compile_ns", 0)
                cache_hits[i] += 1 if getattr(s, "cache_hit", False) else 0
                bytes_sum[i] += getattr(s, "num_bytes", 0)
        out = []
        if sink:
            # compile/cache attribute the task's ONE fused program to every
            # executor it contains; cache prints hits/tasks (ref: the
            # cop_cache hit ratio in EXPLAIN ANALYZE's execution info)
            out += [[
                Datum.string(f"push[{n}]"), Datum.i64(rows_sum[i]), Datum.i64(len(sink)),
                Datum.string(f"{time_ns[i] / 1e6:.2f}ms"),
                Datum.string(f"{compile_ns[i] / 1e6:.2f}ms"),
                Datum.string(f"{cache_hits[i]}/{len(sink)}"),
                Datum.i64(bytes_sum[i]),
            ] for i, n in enumerate(names)]
        else:
            # oracle/materialized path: no coprocessor tasks ran
            out.append([Datum.string("(no coprocessor summaries: oracle or in-memory path)"),
                        Datum.NULL, Datum.i64(0), Datum.NULL, Datum.NULL, Datum.NULL, Datum.NULL])
        if rp.root_dag is not None:
            for e in rp.root_dag.executors[1:]:
                out.append([Datum.string(f"root[{type(e).__name__}]"), Datum.NULL, Datum.i64(1),
                            Datum.NULL, Datum.NULL, Datum.NULL, Datum.NULL])
        # radix-join attribution: partitions/rung from the
        # compiled plan, escapes = skew rows the escape hatch routed
        # through the general kernel, summed over the tasks that rode it
        rx_tasks = rx_esc = rx_parts = rx_rung = 0
        for task_summaries in sink:
            for s in task_summaries:
                if getattr(s, "radix_partitions", 0):
                    rx_tasks += 1
                    rx_parts = max(rx_parts, s.radix_partitions)
                    rx_rung = max(rx_rung, s.radix_rung)
                    rx_esc += s.radix_escapes
        if rx_tasks:
            out.append([Datum.string("join_radix"), Datum.i64(rx_parts),
                        Datum.i64(rx_tasks), Datum.NULL, Datum.NULL,
                        Datum.string(f"rung={rx_rung} escapes={rx_esc}"),
                        Datum.NULL])
        if batch_stats:
            # batched coprocessor attribution: rows=regions batch-served,
            # tasks=vmapped launches, cache column carries launches saved
            regions = sum(b.get("regions", 0) for b in batch_stats)
            batches = sum(b.get("batches", 0) for b in batch_stats)
            saved = sum(b.get("launches_saved", 0) for b in batch_stats)
            out.append([Datum.string("batch_cop"), Datum.i64(regions), Datum.i64(batches),
                        Datum.NULL, Datum.NULL, Datum.string(f"saved={saved}"), Datum.NULL])
            mesh_lanes = sum(b.get("mesh_lanes", 0) for b in batch_stats)
            if mesh_lanes:
                # mesh-tier attribution: rows=region lanes whose partial
                # states psum-merged ON DEVICE, tasks=shard_map launches —
                # the store answered ONE merged state per launch, so the
                # root merge saw `launches` rows instead of `lanes`
                mesh_batches = sum(b.get("mesh_batches", 0) for b in batch_stats)
                out.append([Datum.string("mesh_cop"), Datum.i64(mesh_lanes),
                            Datum.i64(mesh_batches), Datum.NULL, Datum.NULL,
                            Datum.string(f"merged={mesh_lanes}->{mesh_batches}"),
                            Datum.NULL])
        if self._last_plan_cache:
            # per-statement cache attribution: did
            # THIS run hit, miss, or decline — and why
            s, reason, tier = self._last_plan_cache
            detail = {"hit": f"hit({tier})", "miss": "miss",
                      "decline": f"decline({reason})", "off": "off"}.get(s, s)
            out.append([Datum.string("plan_cache"), Datum.NULL, Datum.i64(1),
                        Datum.NULL, Datum.NULL, Datum.string(detail), Datum.NULL])
        out.append([Datum.string("result"), Datum.i64(len(out_rows)), Datum.i64(1),
                    Datum.NULL, Datum.NULL, Datum.NULL, Datum.NULL])
        return Result(columns=["executor", "rows", "tasks", "time", "compile", "cache", "bytes"], rows=out)
