"""System variables (ref: pkg/sessionctx/variable/sysvar.go — 456 vars with
scopes and validators; this registry carries the subset the engine consults,
including the TPU backend's feature gate, which follows the
TiDBAllowMPPExecution pattern at sysvar.go:1910).

Copy of `tidb_tpu/sql/sysvar.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class SysVarError(ValueError):
    pass


def _bool_validator(v: str) -> str:
    t = v.strip().upper()
    if t in ("ON", "1", "TRUE"):
        return "ON"
    if t in ("OFF", "0", "FALSE"):
        return "OFF"
    raise SysVarError(f"expected ON/OFF, got {v!r}")


def _enum_validator(*allowed: str):
    def check(v: str) -> str:
        t = v.strip().lower()
        if t not in allowed:
            raise SysVarError(f"expected one of {allowed}, got {v!r}")
        return t

    return check


def _snapshot_validator(v: str) -> str:
    t = v.strip()
    if t and not t.isdigit():
        raise SysVarError("tidb_snapshot expects a TSO timestamp (or '' to clear)")
    return t


# the engines THIS build actually has: the TPU row store and the HTAP
# columnar replica. The reference's engine names are accepted as aliases
# and normalized (tikv/tidb -> the row store, tiflash -> columnar), so
# reference-tuned `SET tidb_isolation_read_engines = 'tikv,tiflash'`
# statements keep working (ref: sysvar.go TiDBIsolationReadEngines
# validation against config.IsolationRead.Engines).
_ENGINE_ALIASES = {
    "tpu": "tpu", "tikv": "tpu", "tidb": "tpu",
    "columnar": "columnar", "tiflash": "columnar",
}


def _engines_validator(v: str) -> str:
    names = [t.strip().lower() for t in v.split(",") if t.strip()]
    if not names:
        raise SysVarError(
            "tidb_isolation_read_engines needs at least one engine (tpu, columnar)")
    out: list = []
    for n in names:
        e = _ENGINE_ALIASES.get(n)
        if e is None:
            raise SysVarError(
                f"unknown isolation read engine {n!r} (this build has: tpu, "
                f"columnar; tikv/tidb/tiflash accepted as aliases)")
        if e not in out:
            out.append(e)
    return ",".join(out)


def _int_validator(lo: int, hi: int):
    def check(v: str) -> str:
        try:
            n = int(v)
        except ValueError as exc:
            raise SysVarError(f"expected integer, got {v!r}") from exc
        if not (lo <= n <= hi):
            raise SysVarError(f"value {n} out of range [{lo}, {hi}]")
        return str(n)

    return check


@dataclass
class SysVar:
    name: str
    default: str
    scope: str = "session"  # session | global | both
    validator: object = None

    def validate(self, v: str) -> str:
        return self.validator(v) if self.validator else v


DEFINITIONS = {
    v.name: v
    for v in [
        # the TPU coprocessor gate (ref: TiDBAllowMPPExecution pattern)
        SysVar("tidb_enable_tpu_coprocessor", "ON", "both", _bool_validator),
        # route eligible GROUP BY plans over the device mesh (Partial1 ->
        # all_to_all exchange -> Final); needs >= 2 devices at runtime
        # (ref: TiDBAllowMPPExecution / enforce-mpp engine selection)
        SysVar("tidb_enable_tpu_mesh", "ON", "both", _bool_validator),
        # the MPP tier above the mesh: plan eligible statements
        # as exchange-linked fragment graphs (mpp/fragment.py) dispatched
        # through the wire seam, probe scans served from the columnar
        # replica when it covers the snapshot. OFF falls back to the
        # whole-plan mesh shortcut (ref: sysvar.go TiDBAllowMPPExecution)
        SysVar("tidb_allow_mpp", "ON", "both", _bool_validator),
        # data-size floor for the mesh DISPATCH tier (distsql/planner.py):
        # below this estimated row count the vmapped batch tier serves
        SysVar("tidb_tpu_mesh_min_rows", "0", "both", _int_validator(0, 1 << 40)),
        # ref: sysvar.go:1956 TiDBDistSQLScanConcurrency
        SysVar("tidb_distsql_scan_concurrency", "4", "both", _int_validator(1, 256)),
        # ref: sysvar.go:2080 TiDBMaxChunkSize
        SysVar("tidb_max_chunk_size", "1024", "both", _int_validator(32, 1 << 20)),
        SysVar("tidb_mem_quota_query", str(1 << 30), "both", _int_validator(0, 1 << 60)),
        SysVar("tidb_enable_paging", "OFF", "both", _bool_validator),
        # ref: sysvar.go TiDBAllowBatchCop (regions-per-store batching)
        SysVar("tidb_allow_batch_cop", "OFF", "both", _bool_validator),
        # ref: sysvar.go TiDBReplicaRead — which peer of a region serves
        # reads: the leader (default), a follower whose safe_ts covers the
        # snapshot, or the least-loaded peer ("closest")
        SysVar("tidb_replica_read", "leader", "both",
               _enum_validator("leader", "follower", "closest-replica")),
        SysVar("tidb_opt_agg_push_down", "ON", "both", _bool_validator),
        SysVar("autocommit", "ON", "both", _bool_validator),
        # ref: sysvar.go TiDBTxnMode (pessimistic is TiDB's default)
        SysVar("tidb_txn_mode", "pessimistic", "both", _enum_validator("pessimistic", "optimistic")),
        # ref: sysvar.go CTEMaxRecursionDepth
        SysVar("cte_max_recursion_depth", "1000", "both", _int_validator(0, 1 << 20)),
        SysVar("sql_mode", "STRICT_TRANS_TABLES", "both"),
        SysVar("time_zone", "UTC", "both"),
        # ---- engine knobs wired into real code paths -------------------
        # starting group-table capacity for device group-by (the overflow
        # retry quadruples from here; exec/builder.py DEFAULT_GROUP_CAPACITY)
        SysVar("tidb_tpu_group_capacity", "4096", "both", _int_validator(16, 1 << 24)),
        # MySQL: implicit LIMIT on top-level SELECT results (sql_select_limit)
        SysVar("sql_select_limit", str((1 << 64) - 1), "both", _int_validator(0, (1 << 64) - 1)),
        # ref: sysvar.go TiDBSnapshot — stale read: session reads rewind to
        # this TSO (session.py _read_ts) and writes are rejected while set
        SysVar("tidb_snapshot", "", "session", _snapshot_validator),
        # ---- planner/executor toggles the reference exposes ------------
        # (ref: pkg/sessionctx/variable/sysvar.go — same names; accepted
        # and visible via SELECT @@/SHOW VARIABLES; ones without a matching
        # code path here validate + round-trip but do not change behavior,
        # exactly like the reference's noop-sysvars list sysvar.go's
        # SetNoopVars)
        SysVar("tidb_cost_model_version", "2", "both", _int_validator(1, 2)),
        # MySQL: group_concat result truncation length
        SysVar("group_concat_max_len", "1024", "both", _int_validator(4, 1 << 30)),
        # MySQL: decimal division scale increment (ref: cop_handler.go:350;
        # the expression compiler currently fixes the increment at 4)
        SysVar("div_precision_increment", "4", "both", _int_validator(0, 30)),
        SysVar("tidb_enable_vectorized_expression", "ON", "both", _bool_validator),
        SysVar("tidb_opt_insubq_to_join_and_agg", "ON", "both", _bool_validator),
        SysVar("tidb_partition_prune_mode", "dynamic", "both", _enum_validator("static", "dynamic")),
        SysVar("tidb_hashagg_partial_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_hashagg_final_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_hash_join_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_projection_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_window_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_executor_concurrency", "5", "both", _int_validator(1, 256)),
        SysVar("tidb_index_lookup_concurrency", "-1", "both", _int_validator(-1, 256)),
        SysVar("tidb_index_serial_scan_concurrency", "1", "both", _int_validator(1, 256)),
        SysVar("tidb_build_stats_concurrency", "4", "both", _int_validator(1, 256)),
        SysVar("tidb_enable_outer_join_reorder", "ON", "both", _bool_validator),
        SysVar("tidb_enable_index_merge", "ON", "both", _bool_validator),
        SysVar("tidb_enable_window_function", "ON", "both", _bool_validator),
        SysVar("tidb_enable_null_aware_anti_join", "ON", "both", _bool_validator),
        SysVar("tidb_enable_unsafe_substitute", "OFF", "both", _bool_validator),
        SysVar("tidb_enable_clustered_index", "ON", "both"),
        SysVar("tidb_analyze_version", "2", "both", _int_validator(1, 2)),
        SysVar("tidb_enable_chunk_rpc", "ON", "session", _bool_validator),
        # which engines may serve reads (ref: sysvar.go
        # TiDBIsolationReadEngines): the tpu row store and/or the HTAP
        # columnar replica — validated at SET time, reference names
        # normalized, unknown names rejected
        SysVar("tidb_isolation_read_engines", "tpu,columnar", "both", _engines_validator),
        SysVar("tidb_opt_correlation_threshold", "0.9", "both"),
        SysVar("tidb_opt_limit_push_down_threshold", "100", "both", _int_validator(0, 1 << 30)),
        SysVar("tidb_opt_distinct_agg_push_down", "OFF", "both", _bool_validator),
        SysVar("tidb_retry_limit", "10", "both", _int_validator(0, 1 << 20)),
        SysVar("tidb_backoff_weight", "2", "both", _int_validator(0, 1 << 20)),
        SysVar("tidb_row_format_version", "2", "global", _int_validator(1, 2)),
        SysVar("tidb_slow_log_threshold", "300", "both", _int_validator(-1, 1 << 30)),
        SysVar("tidb_enable_slow_log", "ON", "both", _bool_validator),
        SysVar("tidb_stmt_summary_max_stmt_count", "3000", "global", _int_validator(1, 1 << 20)),
        SysVar("tidb_enable_stmt_summary", "ON", "both", _bool_validator),
        # ---- Top SQL (ref: tidb_enable_top_sql +
        # tidb_top_sql_max_statement_count, sysvar.go) — per-digest
        # CPU+device attribution; OFF skips tagging entirely so a
        # statement pays one sysvar read and nothing else
        SysVar("tidb_enable_top_sql", "ON", "both", _bool_validator),
        # top-K digests each reporter window retains per metric before
        # the "(others)" fold (ref default 200; scaled to in-process)
        SysVar("tidb_top_sql_max_statement_count", "30", "both", _int_validator(1, 5000)),
        # ---- production front door --------------------------
        # digest-keyed plan cache (ref: tidb_enable_prepared_plan_cache +
        # the non-prepared plan cache, sysvar.go): repeated statements
        # re-bind literals into a cached template, skipping parse+plan
        SysVar("tidb_enable_plan_cache", "ON", "both", _bool_validator),
        # LRU capacity of the instance plan cache (ref:
        # tidb_session_plan_cache_size)
        SysVar("tidb_plan_cache_size", "512", "both", _int_validator(1, 1 << 20)),
        # per-SESSION memory quota parenting every query tracker (0 =
        # unlimited; ref: the server/session tracker tree in util/memory)
        SysVar("tidb_mem_quota_session", "0", "both", _int_validator(0, 1 << 60)),
        # ---- cross-session fused execution ------------------
        # coalesce concurrent plan-cache-hit point gets into one batched
        # device launch and autocommit single-row writes into group
        # commits (OFF: every statement launches/proposes alone)
        SysVar("tidb_tpu_enable_coalesce", "OFF", "both", _bool_validator),
        # micro-batch window: how long the first lane waits for company
        SysVar("tidb_tpu_coalesce_wait_us", "300", "both", _int_validator(0, 1_000_000)),
        # lane count that closes the window early
        SysVar("tidb_tpu_coalesce_max_lanes", "64", "both", _int_validator(1, 4096)),
        # autocommit writes above this mutation count skip group commit
        SysVar("tidb_tpu_coalesce_max_write_keys", "16", "both", _int_validator(1, 1024)),
        # publish/adopt plan-cache entries through the process-wide
        # cross-catalog tier (every shared hit fingerprint-revalidates)
        SysVar("tidb_tpu_plan_cache_shared", "OFF", "both", _bool_validator),
        # ---- MySQL-compatibility variables -----------------------------
        SysVar("transaction_isolation", "REPEATABLE-READ", "both",
               _enum_validator("read-uncommitted", "read-committed", "repeatable-read", "serializable")),
        SysVar("tx_isolation", "REPEATABLE-READ", "both"),
        SysVar("character_set_client", "utf8mb4", "both"),
        SysVar("character_set_connection", "utf8mb4", "both"),
        SysVar("character_set_results", "utf8mb4", "both"),
        SysVar("character_set_database", "utf8mb4", "both"),
        SysVar("collation_connection", "utf8mb4_bin", "both"),
        SysVar("collation_database", "utf8mb4_bin", "both"),
        SysVar("default_collation_for_utf8mb4", "utf8mb4_bin", "both"),
        SysVar("foreign_key_checks", "ON", "both", _bool_validator),
        SysVar("block_encryption_mode", "aes-128-ecb", "both"),
        SysVar("max_execution_time", "0", "both", _int_validator(0, 1 << 31)),
        SysVar("wait_timeout", "28800", "both", _int_validator(0, 1 << 31)),
        SysVar("interactive_timeout", "28800", "both", _int_validator(1, 1 << 31)),
        SysVar("max_allowed_packet", str(64 << 20), "both", _int_validator(1024, 1 << 30)),
        SysVar("sql_safe_updates", "OFF", "both", _bool_validator),
        SysVar("innodb_lock_wait_timeout", "50", "both", _int_validator(1, 3600)),
        SysVar("version_comment", "TiDB-TPU", "global"),
        SysVar("last_insert_id", "0", "session", _int_validator(0, (1 << 64) - 1)),
    ]
}


def is_bool(name: str) -> bool:
    """Boolean-typed sysvars render 1/0 under SELECT @@x (MySQL prints the
    numeric form there; SHOW VARIABLES keeps ON/OFF)."""
    d = DEFINITIONS.get(name.lower())
    return d is not None and d.validator is _bool_validator


class SysVarStore:
    """Per-session values over the shared definitions."""

    def __init__(self):
        self._values: dict[str, str] = {}

    def get(self, name: str) -> str:
        name = name.lower()
        if name in self._values:
            return self._values[name]
        d = DEFINITIONS.get(name)
        if d is None:
            raise SysVarError(f"unknown system variable {name!r}")
        return d.default

    def get_bool(self, name: str) -> bool:
        return self.get(name) == "ON"

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def set(self, name: str, value: str):
        name = name.lower()
        d = DEFINITIONS.get(name)
        if d is None:
            raise SysVarError(f"unknown system variable {name!r}")
        self._values[name] = d.validate(str(value))

    def items(self):
        out = {name: d.default for name, d in DEFINITIONS.items()}
        out.update(self._values)
        return sorted(out.items())
