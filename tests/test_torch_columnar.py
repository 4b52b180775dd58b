"""The port's columnar replica (tidb_tpu_torch/columnar/) on the CPU.

The first part is tests/test_columnar.py on a port `Session(device="cpu")`:
its cases but three, which wait on subsystems the port does not have yet —
test_http_columnar_routes (the HTTP status server),
test_columnar_lockwatch_storm (analysis/lockwatch.py) and
test_htap_chaos_storm_acceptance (tools/chaos.py run_htap_storm) — and
tests/test_mpp.py's test_replica_served_probe_matches_row_store on a port
session with `mesh_devices=["cpu"] * 4`.

The second part holds the port against the JAX package: the same
statements through a JAX `Session` and a port `Session` give the same
routed answers (equal to each package's row store too) and the same replica
views after the same DML; a compacted full scan runs from the stable batch
on the store's device (run_dag_on_chunks is not called), an uncompacted
delta takes the host overlay. Tolerance: exact.
"""

import os
import sys

import pytest

from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.util import failpoint, metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def norm(v):
    return None if v is None else str(v)


def make_replicated(rows=40):
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, g BIGINT)")
    if rows:
        s.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{(i * 7) % 13},{i % 3})" for i in range(rows)))
    s.execute("ALTER TABLE t SET COLUMNAR REPLICA 1")
    s.store.pd.tick()  # birth incremental scan + first compaction
    return s


def both_engines(s, sql):
    """(routed result, row-store result) back to back — single-threaded,
    so both see the same snapshot."""
    s.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
    got = s.execute(sql).values()
    s.execute("SET tidb_isolation_read_engines = 'tpu'")
    want = s.execute(sql).values()
    s.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
    return got, want


# ------------------------------------------------------------ engine routing

class TestEngineRouting:
    def test_aggregate_scan_rides_the_replica_and_matches_row_store(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(
            s, "SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value == sc0 + 1

    def test_topn_rides_the_replica(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(
            s, "SELECT id, v FROM t ORDER BY v DESC, id LIMIT 7")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value == sc0 + 1

    def test_range_scan_with_agg_routes_and_agrees(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(
            s, "SELECT count(*), max(v) FROM t WHERE id BETWEEN 5 AND 25")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value > sc0

    def test_point_get_and_row_local_scans_never_route(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        s.execute("SELECT * FROM t WHERE id = 3")
        s.execute("SELECT id, v FROM t WHERE v > 4 ORDER BY id")
        assert metrics.COLUMNAR_SCANS.value == sc0

    def test_in_txn_reads_stay_on_the_row_store(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        s.execute("BEGIN")
        r = s.execute("SELECT count(*) FROM t").values()
        s.execute("COMMIT")
        assert r == [[40]]
        assert metrics.COLUMNAR_SCANS.value == sc0

    def test_partitioned_table_routes_across_pids(self):
        s = Session(device="cpu")
        s.execute("CREATE TABLE pt (a BIGINT PRIMARY KEY, v BIGINT) "
                  "PARTITION BY HASH(a) PARTITIONS 3")
        s.execute("INSERT INTO pt VALUES " + ",".join(
            f"({i},{i % 11})" for i in range(30)))
        s.execute("ALTER TABLE pt SET COLUMNAR REPLICA 1")
        s.store.pd.tick()
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(s, "SELECT count(*), sum(v) FROM pt")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value == sc0 + 1

    def test_join_probe_on_replica_matches(self):
        s = make_replicated()
        s.execute("CREATE TABLE d (g BIGINT PRIMARY KEY, name VARCHAR(8))")
        s.execute("INSERT INTO d VALUES (0,'a'),(1,'b'),(2,'c')")
        s.store.pd.tick()
        got, want = both_engines(
            s, "SELECT t.g, d.name, count(*) FROM t JOIN d ON t.g = d.g "
               "GROUP BY t.g, d.name ORDER BY t.g")
        assert got == want

    def test_explain_analyze_keeps_the_cop_path(self):
        s = make_replicated()
        sc0 = metrics.COLUMNAR_SCANS.value
        r = s.execute("EXPLAIN ANALYZE SELECT g, count(*) FROM t GROUP BY g")
        assert metrics.COLUMNAR_SCANS.value == sc0  # attribution needs cop
        assert any("push" in str(row[0]) for row in r.values())

    def test_trace_has_columnar_scan_span(self):
        s = make_replicated()
        r = s.execute("TRACE SELECT g, count(*) FROM t GROUP BY g").values()
        assert any("columnar.scan" in str(row[0]) for row in r)


# ---------------------------------------------------- sysvar validation

class TestIsolationReadEnginesSysvar:
    def test_unknown_engine_rejected_at_set_time(self):
        s = Session(device="cpu")
        with pytest.raises(SQLError, match="unknown isolation read engine"):
            s.execute("SET tidb_isolation_read_engines = 'bogus'")
        with pytest.raises(SQLError, match="unknown isolation read engine"):
            s.execute("SET GLOBAL tidb_isolation_read_engines = 'tpu,nope'")

    def test_reference_names_normalize_to_this_builds_engines(self):
        s = Session(device="cpu")
        s.execute("SET tidb_isolation_read_engines = 'tikv,tiflash,tidb'")
        assert s.execute("SELECT @@tidb_isolation_read_engines").values() == [["tpu,columnar"]]
        s.execute("SET SESSION tidb_isolation_read_engines = 'TiFlash'")
        assert s.execute("SELECT @@tidb_isolation_read_engines").values() == [["columnar"]]

    def test_empty_engine_list_rejected(self):
        s = Session(device="cpu")
        with pytest.raises(SQLError, match="at least one engine"):
            s.execute("SET tidb_isolation_read_engines = ''")

    def test_default_is_normalized(self):
        s = Session(device="cpu")
        assert s.execute("SELECT @@tidb_isolation_read_engines").values() == [["tpu,columnar"]]


# --------------------------------------------- mounter -> scan parity matrix

class TestTypeMatrixParity:
    def test_every_column_type_survives_delta_compaction_and_scan(self):
        """mounter -> delta -> compaction -> stable scan reproduces the
        row store byte for byte over the full type matrix, NULLs
        included (the cdc mounter-parity test's
        columnar sibling)."""
        s = Session(device="cpu")
        s.execute("""CREATE TABLE m (
            id BIGINT PRIMARY KEY, i INT, u BIGINT UNSIGNED, f FLOAT,
            d DOUBLE, dec DECIMAL(10,2), dt DATETIME, da DATE,
            j JSON, e ENUM('a','b','c'), cs VARCHAR(16) COLLATE utf8mb4_general_ci,
            vb VARBINARY(16))""")
        s.execute("INSERT INTO m VALUES "
                  "(1, -5, 18446744073709551610, 1.5, 2.25, '12345.67', "
                  "'2024-02-29 12:34:56', '2024-02-29', '{\"k\": [1, 2]}', 'b', 'Ab', x'00ff10'),"
                  "(2, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL),"
                  "(3, 7, 0, -0.5, 1e10, '-0.01', '1999-12-31 23:59:59', '1970-01-01', "
                  "'[true, null]', 'c', 'zz', x'')")
        s.execute("ALTER TABLE m SET COLUMNAR REPLICA 1")
        s.store.pd.tick()
        meta = s.catalog.table("m")
        t = s.store.columnar.table_for(meta.table_id)
        assert t.view()["stable_rows"] == 3 and t.view()["delta_rows"] == 0
        chunk, _batch = t.scan(t.frontier()[0], None)
        got = [[norm(None if d.is_null() else d.val) for d in chunk.row(i)]
               for i in range(chunk.num_rows())]
        want = [[norm(v) for v in row]
                for row in s.execute("SELECT * FROM m ORDER BY id").values()]
        assert got == want

    def test_delete_and_overwrite_fold_in_compaction(self):
        s = make_replicated(rows=10)
        s.execute("UPDATE t SET v = 100 WHERE id = 3")
        s.execute("UPDATE t SET v = 200 WHERE id = 3")
        s.execute("DELETE FROM t WHERE id = 4")
        s.store.pd.tick()
        meta = s.catalog.table("t")
        t = s.store.columnar.table_for(meta.table_id)
        v = t.view()
        assert v["delta_rows"] == 0  # everything folded
        assert v["stable_rows"] == 9  # 10 - 1 delete
        chunk, _ = t.scan(t.frontier()[0], None)
        by_id = {chunk.row(i)[0].val: chunk.row(i)[1].val
                 for i in range(chunk.num_rows())}
        assert by_id[3] == 200  # overwrite folded to the LATEST version
        assert 4 not in by_id  # delete folded away
        got, want = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got == want

    def test_delta_overlay_serves_before_compaction(self):
        """Applied-but-not-folded changes (compact-stall) serve through
        the delta overlay, still byte-identical to the row store."""
        s = make_replicated(rows=10)
        with failpoint.enabled("columnar/compact-stall"):
            s.execute("UPDATE t SET v = 999 WHERE id = 2")
            s.execute("DELETE FROM t WHERE id = 5")
            s.execute("INSERT INTO t VALUES (77, 7, 1)")
            s.store.pd.tick()  # advances the frontier, skips the fold
            meta = s.catalog.table("t")
            t = s.store.columnar.table_for(meta.table_id)
            assert t.view()["delta_rows"] > 0
            got, want = both_engines(
                s, "SELECT count(*), sum(v), max(v) FROM t")
            assert got == want
        s.store.pd.tick()
        assert t.view()["delta_rows"] == 0  # disarmed: the fold catches up


# ----------------------------------------------------------------- staleness

class TestStaleness:
    def test_scan_beyond_frontier_falls_back_not_torn(self):
        """A write the frontier has not resolved yet: the routed query
        answers from the ROW STORE (counted fallback) — correct data,
        never a torn columnar prefix."""
        s = make_replicated(rows=10)
        fb0 = metrics.COLUMNAR_FALLBACKS.value
        sc0 = metrics.COLUMNAR_SCANS.value
        s.execute("INSERT INTO t VALUES (50, 9, 0)")  # no tick: frontier lags
        got, want = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got == want
        assert got[0][0] == 11
        assert str(got[0][1]) == str(sum((i * 7) % 13 for i in range(10)) + 9)
        assert metrics.COLUMNAR_FALLBACKS.value > fb0
        assert metrics.COLUMNAR_SCANS.value == sc0
        s.store.pd.tick()  # frontier catches up: the replica serves again
        got2, _ = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got2 == got
        assert metrics.COLUMNAR_SCANS.value > sc0

    def test_in_flight_write_blocks_the_frontier_shortcut(self):
        """The applied>=max_committed equivalence shortcut must be
        proven under a quiescent WriteGuard double-sample: a writer
        inside its [commit-ts draw .. apply] window has a ts drawn but
        nothing in kv yet, so serving at the frontier could miss its
        commit — the routed read must fall back."""
        s = make_replicated(rows=8)
        fb0 = metrics.COLUMNAR_FALLBACKS.value
        sc0 = metrics.COLUMNAR_SCANS.value
        with s.store.cdc.guard.writing():  # an in-flight write bracket
            got, want = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value == sc0
        assert metrics.COLUMNAR_FALLBACKS.value > fb0
        # quiescent again: the shortcut serves
        got2, _ = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got2 == got
        assert metrics.COLUMNAR_SCANS.value > sc0

    def test_rename_table_keeps_replica_attached_and_disposable(self):
        """RENAME TABLE mutates meta.name in place: the replica registry
        is keyed by table id, so routing follows the new name and
        REPLICA 0 under the new name really drops the feed (no orphaned
        GC safepoint)."""
        s = make_replicated(rows=12)
        s.execute("ALTER TABLE t RENAME TO u")
        s.store.pd.tick()
        assert s.store.columnar.views()[0]["table"] == "u"
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(s, "SELECT count(*), sum(v) FROM u")
        assert got == want
        assert metrics.COLUMNAR_SCANS.value > sc0
        s.execute("ALTER TABLE u SET COLUMNAR REPLICA 0")
        assert s.execute("SHOW COLUMNAR TABLES").values() == []
        assert s.execute("SHOW CHANGEFEEDS").values() == []  # feed dropped,
        # its GC-safepoint pin released with it
        s.execute("ALTER TABLE u SET COLUMNAR REPLICA 1")  # re-enable works
        s.store.pd.tick()
        assert len(s.execute("SHOW CHANGEFEEDS").values()) == 1

    def test_stale_read_below_compaction_floor_falls_back(self):
        """tidb_snapshot older than the stable floor: the overwritten
        versions were folded away, so the replica declines and the row
        store's MVCC serves the historical read."""
        s = make_replicated(rows=6)
        old = s.store.kv.max_committed()
        s.execute("UPDATE t SET v = 500 WHERE id = 1")
        s.store.pd.tick()  # folds the overwrite; floor moves past `old`
        fb0 = metrics.COLUMNAR_FALLBACKS.value
        s.execute(f"SET tidb_snapshot = '{old}'")
        r = s.execute("SELECT max(v), count(*) FROM t").values()
        s.execute("SET tidb_snapshot = ''")
        assert r[0][1] == 6 and r[0][0] < 500  # pre-update snapshot
        assert metrics.COLUMNAR_FALLBACKS.value > fb0


# ------------------------------------------ mid-feed DDL through the feed

class TestSchemaChangeThroughFeed:
    """An older guard PARKED any feed whose table shape moved.
    DDL now replicates THROUGH the feed as an ordered SchemaEvent (the
    mounter tracks a per-feed snapshot advanced only by the schema
    stream), so a mid-feed ALTER is an event, never a park — and the
    legacy SchemaDriftError survives only as a counted fallback."""

    def test_alter_mid_feed_replicates_as_ordered_event(self):
        from tidb_tpu_torch.cdc import MemorySink, SchemaEvent

        s = Session(device="cpu")
        s.execute("CREATE TABLE g (id BIGINT PRIMARY KEY, v BIGINT)")
        meta = s.catalog.table("g")
        feed = s.store.cdc.create("gf", MemorySink(), s.catalog,
                                  table_ids={meta.table_id}, start_ts=0)
        s.execute("INSERT INTO g VALUES (1, 10)")
        s.store.cdc.tick()
        assert len(feed.sink.rows()) == 1
        ckpt_before = feed.view(s.store)["checkpoint_ts"]
        s.execute("ALTER TABLE g ADD COLUMN w BIGINT DEFAULT 7")
        s.execute("INSERT INTO g VALUES (2, 20, 21)")
        s.store.cdc.tick()
        v = feed.view(s.store)
        assert v["state"] == "normal" and v["error"] == ""
        assert v["checkpoint_ts"] > ckpt_before  # never held by the DDL
        events = feed.sink.rows()
        assert [type(e).__name__ for e in events[1:]] == ["SchemaEvent", "RowEvent"]
        ddl = events[1]
        assert isinstance(ddl, SchemaEvent) and ddl.op == "add column"
        assert "alter table g" in ddl.query.lower() and ddl.schema_version == 1
        assert ddl.commit_ts < events[2].commit_ts  # ordered, not out-of-band
        assert dict(events[2].columns)["w"].val == 21  # mounted on NEW shape

    def test_paused_feed_across_alter_resumes_without_parking(self):
        """A feed paused BEFORE the ALTER drains its old-shape backlog
        and the schema event in commit order on resume — the case that
        used to need a double RESUME to acknowledge the drift."""
        from tidb_tpu_torch.cdc import MemorySink, SchemaEvent

        s = Session(device="cpu")
        s.execute("CREATE TABLE g (id BIGINT PRIMARY KEY, v BIGINT)")
        meta = s.catalog.table("g")
        feed = s.store.cdc.create("gf", MemorySink(), s.catalog,
                                  table_ids={meta.table_id}, start_ts=0)
        s.execute("INSERT INTO g VALUES (1, 10)")
        s.store.cdc.pause("gf")
        s.execute("ALTER TABLE g ADD COLUMN w BIGINT DEFAULT 7")
        s.execute("INSERT INTO g VALUES (2, 20, 21)")
        s.store.cdc.resume("gf")
        s.store.cdc.tick()
        assert feed.view(s.store)["state"] == "normal"
        events = feed.sink.rows()
        rows = [e for e in events if not isinstance(e, SchemaEvent)]
        assert [r.handle for r in rows] == [1, 2]
        assert "w" not in dict(rows[0].columns)  # old row, old shape
        assert dict(rows[1].columns)["w"].val == 21
        assert sum(isinstance(e, SchemaEvent) for e in events) == 1

    def test_unexplained_drift_counts_legacy_fallback_not_park(self):
        """Bytes the tracked snapshot cannot decode AND the schema
        stream never explained: the mounter re-decodes against the live
        catalog as a counted CDC_SCHEMA_DRIFT_LEGACY fallback — the
        typed park is gone."""
        from tidb_tpu_torch.cdc import MemorySink
        from tidb_tpu_torch.cdc.schema import ColumnSnap, SchemaSnapshot

        s = Session(device="cpu")
        s.execute("CREATE TABLE g (id BIGINT PRIMARY KEY, v BIGINT)")
        meta = s.catalog.table("g")
        feed = s.store.cdc.create("gf", MemorySink(), s.catalog,
                                  table_ids={meta.table_id}, start_ts=0)
        s.execute("INSERT INTO g VALUES (1, 10)")
        s.store.cdc.tick()
        # wedge the tracked snapshot with a shape the row bytes cannot
        # satisfy — a schema move the journal never carried (ft=None on a
        # STORED column makes decode_row_value raise)
        vid = next(c.col_id for c in meta.columns if c.name == "v")
        with feed.mounter._mu:
            feed.mounter._tracked[meta.table_id] = SchemaSnapshot(
                0, (ColumnSnap("v", vid, None, None),))
        d0 = metrics.CDC_SCHEMA_DRIFT_LEGACY.value
        s.execute("INSERT INTO g VALUES (2, 20)")
        s.store.cdc.tick()
        assert metrics.CDC_SCHEMA_DRIFT_LEGACY.value > d0
        assert feed.view(s.store)["state"] == "normal"  # counted, not parked
        assert [r.handle for r in feed.sink.rows()] == [1, 2]
        # the fallback re-tracked the live shape: the next row is clean
        d1 = metrics.CDC_SCHEMA_DRIFT_LEGACY.value
        s.execute("INSERT INTO g VALUES (3, 30)")
        s.store.cdc.tick()
        assert metrics.CDC_SCHEMA_DRIFT_LEGACY.value == d1
        assert [r.handle for r in feed.sink.rows()] == [1, 2, 3]

    def test_columnar_replica_reshapes_and_keeps_serving(self):
        """The ColumnarSink applies the replicated ALTER as a reshape of
        the attached replica (old rows backfill the origin default) and
        keeps consuming — scans stay on the replica, no park, no rebuild
        toggle."""
        s = make_replicated(rows=8)
        s.execute("ALTER TABLE t ADD COLUMN extra BIGINT DEFAULT 0")
        s.execute("INSERT INTO t VALUES (90, 1, 1, 5)")
        r0 = metrics.COLUMNAR_RESHAPES.value
        s.store.pd.tick()
        assert metrics.COLUMNAR_RESHAPES.value > r0
        assert s.store.columnar.views()[0]["state"] == "normal"
        sc0 = metrics.COLUMNAR_SCANS.value
        got, want = both_engines(s, "SELECT count(*), sum(extra) FROM t")
        assert got == want
        assert got[0][0] == 9 and str(got[0][1]) == "5"
        assert metrics.COLUMNAR_SCANS.value > sc0  # served, not fallen back

    def test_change_column_rename_reshapes_in_place(self):
        s = make_replicated(rows=6)
        s.execute("ALTER TABLE t CHANGE COLUMN v vol BIGINT")
        s.execute("INSERT INTO t VALUES (90, 4, 1)")
        s.store.pd.tick()
        assert s.store.columnar.views()[0]["state"] == "normal"
        got, want = both_engines(s, "SELECT count(*), sum(vol) FROM t")
        assert got == want and got[0][0] == 7

    def test_partition_moving_update_keeps_the_row(self):
        """An UPDATE that moves a row across partitions emits delete(old
        pid) + put(new pid) at the SAME commit ts, and the value-less
        delete fans to every pid — the fold's put-wins-ties rule must
        keep the new partition's live row."""
        s = Session(device="cpu")
        s.execute("CREATE TABLE pm (id BIGINT, p BIGINT, v BIGINT) "
                  "PARTITION BY HASH(p) PARTITIONS 4")
        s.execute("INSERT INTO pm VALUES (1, 3, 10), (2, 1, 20), (3, 2, 30)")
        s.execute("ALTER TABLE pm SET COLUMNAR REPLICA 1")
        s.store.pd.tick()
        # move DOWN in pid order: the new pid's put sorts before the old
        # pid's delete in the (ts, key) batch, so without put-wins-ties
        # the fanned tombstone erases the freshly moved row
        s.execute("UPDATE pm SET p = 0 WHERE id = 1")
        s.store.pd.tick()
        got, want = both_engines(
            s, "SELECT count(*), sum(p), sum(v) FROM pm")
        assert got == want
        assert got[0][0] == 3  # the moved row survived the tombstone fan

    def test_reshape_remaps_uncompacted_delta_rows(self):
        """An ALTER landing while old-shape rows still sit in the delta
        layer (compaction stalled) must remap delta AND stable under the
        new shape — the misaligned-rows bug the old rebuild park
        guarded against."""
        s = make_replicated(rows=4)
        failpoint.enable("columnar/compact-stall", True)
        try:
            s.execute("INSERT INTO t VALUES (50, 2, 1)")  # old shape, delta
            s.store.pd.tick()  # applied but NOT compacted
            s.execute("ALTER TABLE t ADD COLUMN extra BIGINT DEFAULT 3")
            s.execute("INSERT INTO t VALUES (90, 1, 1, 5)")
            s.store.pd.tick()  # reshape + new-shape apply, still stalled
            assert s.store.columnar.views()[0]["state"] == "normal"
            got, want = both_engines(s, "SELECT count(*), sum(extra) FROM t")
            assert got == want
            assert got[0][0] == 6 and str(got[0][1]) == str(3 * 5 + 5)
        finally:
            failpoint.disable("columnar/compact-stall")
        s.store.pd.tick()  # drain: compaction folds the remapped delta
        got, want = both_engines(s, "SELECT count(*), sum(extra) FROM t")
        assert got == want and got[0][0] == 6

    def test_index_ddl_does_not_park(self):
        s = make_replicated(rows=8)
        s.execute("CREATE INDEX iv ON t (v)")
        s.execute("INSERT INTO t VALUES (90, 1, 1)")
        s.store.pd.tick()
        assert s.store.columnar.views()[0]["state"] == "normal"


# ------------------------------------------------------------------ surfaces

class TestSurfaces:
    def test_show_columnar_tables_and_disable(self):
        s = make_replicated()
        rows = s.execute("SHOW COLUMNAR TABLES").values()
        assert len(rows) == 1
        tbl, state, pids, delta, stable = rows[0][:5]
        assert (tbl, state, pids, delta, stable) == ("t", "normal", 1, 0, 40)
        s.execute("ALTER TABLE t SET COLUMNAR REPLICA 1")  # idempotent
        assert len(s.execute("SHOW COLUMNAR TABLES").values()) == 1
        s.execute("ALTER TABLE t SET COLUMNAR REPLICA 0")
        assert s.execute("SHOW COLUMNAR TABLES").values() == []
        assert s.execute("SHOW CHANGEFEEDS").values() == []  # feed dropped

    def test_tiflash_spelling_accepted(self):
        s = Session(device="cpu")
        s.execute("CREATE TABLE ft (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("ALTER TABLE ft SET TIFLASH REPLICA 1")
        assert s.execute("SHOW COLUMNAR TABLES").values()[0][0] == "ft"

    def test_columnar_metric_families_pass_scrape_check(self):
        """scrape_check tier-1 coverage of the tidb_tpu_columnar_*
        families."""
        s = make_replicated()
        both_engines(s, "SELECT count(*) , sum(v) FROM t")
        text = metrics.REGISTRY.dump()
        for family in (
            "tidb_tpu_columnar_applied_events_total",
            "tidb_tpu_columnar_compactions_total",
            "tidb_tpu_columnar_scans_total",
            "tidb_tpu_columnar_fallbacks_total",
            "tidb_tpu_columnar_resolved_ts_lag",
        ):
            assert f"# TYPE {family}" in text, family
        assert 'tidb_tpu_columnar_resolved_ts_lag{table="t"}' in text
        from scrape_check import validate

        assert validate(text) == []

    def test_trace_has_pd_columnar_phase(self):
        s = make_replicated()
        s.store.pd.tick()
        root = s.store.pd.last_tick_root
        assert any(c.name == "pd.columnar" for c in root.children)


# ---------------------------------------------------------------- failpoints

class TestFailpoints:
    def test_apply_stall_parks_feed_and_resume_replays(self):
        s = make_replicated(rows=6)
        with failpoint.enabled("columnar/apply-stall"):
            s.execute("INSERT INTO t VALUES (60, 3, 0)")
            s.store.pd.tick()
            v = s.store.columnar.views()[0]
            assert v["state"] == "error"
        s.store.columnar.resume_all()
        s.store.pd.tick()
        v = s.store.columnar.views()[0]
        assert v["state"] == "normal"
        assert v["stable_rows"] == 7  # the stalled write replayed
        got, want = both_engines(s, "SELECT count(*), sum(v) FROM t")
        assert got == want

    def test_compact_stall_grows_delta_then_drains(self):
        s = make_replicated(rows=6)
        with failpoint.enabled("columnar/compact-stall"):
            s.execute("INSERT INTO t VALUES (61, 4, 1)")
            s.store.pd.tick()
            assert s.store.columnar.views()[0]["delta_rows"] > 0
        s.store.pd.tick()
        v = s.store.columnar.views()[0]
        assert v["delta_rows"] == 0 and v["stable_rows"] == 7


# ------------------------------------ the MPP tier's probe from the replica

def _q3_session(nl=600, no=40, nc=12):
    s = Session(device="cpu", mesh_devices=["cpu"] * 4)
    s.execute("create table cust (c_id bigint primary key, seg varchar(2))")
    s.execute("insert into cust values " + ",".join(f"({i}, '{'AB'[i % 2]}')" for i in range(nc)))
    s.execute("create table ords (o_id bigint primary key, ckey bigint, odate bigint)")
    s.execute("insert into ords values " + ",".join(f"({i}, {i % nc}, {1000 + i % 9})" for i in range(no)))
    s.execute("create table items (i_id bigint primary key, oid bigint, v decimal(10,2))")
    s.execute("insert into items values " + ",".join(f"({i}, {(i * 3) % (no + 4)}, {i}.25)" for i in range(nl)))
    return s


Q3_SQL = ("select oid, count(*), sum(v) from items join ords on oid = o_id join cust on ckey = c_id "
          "where seg = 'B' and odate < 1007 group by oid")


def _canon(rows):
    return sorted(tuple(None if d.is_null() else str(d.val) for d in r) for r in rows)


class TestMppReplicaProbe:
    def test_replica_served_probe_matches_row_store(self):
        """tests/test_mpp.py's case on four CPU shards, with the span's
        replica_served read as well."""
        from tidb_tpu_torch.util import tracing

        s = _q3_session()
        s.execute("ALTER TABLE items SET COLUMNAR REPLICA 1")
        s.store.pd.tick()
        m0 = metrics.MPP_SELECTS.value
        with tracing.trace("q3") as root:
            rows = s.execute(Q3_SQL).rows
        assert metrics.MPP_SELECTS.value == m0 + 1
        assert [sp.attrs.get("replica_served") for sp in root.find("mpp.dispatch")] == [True]
        r = s.execute("TRACE " + Q3_SQL).values()
        assert any("mpp.dispatch" in str(row[0]) for row in r)
        s.execute("set tidb_enable_tpu_mesh = OFF")
        assert _canon(rows) == _canon(s.execute(Q3_SQL).rows)


# ------------------------------------------------ parity with the JAX package

from torch_sql_parity import JAX, PORT, norm, run_both  # noqa: E402


def replicated_pair(P, rows=40):
    s = P.new_session()
    s.execute("SET tidb_enable_tpu_mesh = 0")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, g BIGINT, name VARCHAR(8))")
    s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{(i * 7) % 13},{i % 3},'n{i % 5}')" for i in range(rows)))
    s.execute("CREATE TABLE d (g BIGINT PRIMARY KEY, label VARCHAR(8))")
    s.execute("INSERT INTO d VALUES (0,'a'),(1,'b'),(2,'c')")
    s.execute("CREATE TABLE pt (a BIGINT PRIMARY KEY, v BIGINT) PARTITION BY HASH(a) PARTITIONS 3")
    s.execute("INSERT INTO pt VALUES " + ",".join(f"({i},{i % 11})" for i in range(30)))
    for name in ("t", "pt"):
        s.execute(f"ALTER TABLE {name} SET COLUMNAR REPLICA 1")
    s.store.pd.tick()
    return s


ROUTED = {
    "group_by": "SELECT g, count(*), sum(v), min(name), max(v) FROM t GROUP BY g ORDER BY g",
    "scalar": "SELECT count(*), sum(v), avg(v) FROM t WHERE v > 3",
    "range": "SELECT count(*), max(v) FROM t WHERE id BETWEEN 5 AND 25",
    "topn": "SELECT id, v, name FROM t ORDER BY v DESC, id LIMIT 7",
    "join": "SELECT t.g, d.label, count(*), sum(v) FROM t JOIN d ON t.g = d.g GROUP BY t.g, d.label ORDER BY t.g",
    "partitioned": "SELECT count(*), sum(v) FROM pt",
    "distinct": "SELECT count(DISTINCT v), count(DISTINCT name) FROM t",
}


def _engines(P, s, sql):
    """(routed rows, COLUMNAR_SCANS moved, COLUMNAR_FALLBACKS moved,
    row-store rows) of one statement."""
    sc0, fb0 = P.metrics.COLUMNAR_SCANS.value, P.metrics.COLUMNAR_FALLBACKS.value
    s.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
    got = norm(s.execute(sql).rows)
    moved = (P.metrics.COLUMNAR_SCANS.value - sc0, P.metrics.COLUMNAR_FALLBACKS.value - fb0)
    s.execute("SET tidb_isolation_read_engines = 'tpu'")
    want = norm(s.execute(sql).rows)
    s.execute("SET tidb_isolation_read_engines = 'tpu,columnar'")
    assert got == want
    return got, moved


@pytest.mark.parametrize("stmt", list(ROUTED))
@pytest.mark.parametrize("layer", ["stable", "overlay"])
def test_routed_answers_equal_the_jax_package(stmt, layer):
    """Each statement, routed to the replica, equals the JAX package's
    routed answer and both row stores; from the compacted stable layer, and
    from the delta overlay of DML the compaction has not folded."""
    def case(P):
        s = replicated_pair(P)
        if layer == "overlay":
            P.fp.enable("columnar/compact-stall", True)
        try:
            if layer == "overlay":
                s.execute("UPDATE t SET v = v + 100 WHERE id < 6")
                s.execute("DELETE FROM t WHERE id BETWEEN 10 AND 12")
                s.execute("INSERT INTO t VALUES (77, 5, 1, 'z'), (78, 6, 2, 'y')")
                s.execute("UPDATE pt SET v = v * 3 WHERE a < 9")
                s.store.pd.tick()
            got, moved = _engines(P, s, ROUTED[stmt])
        finally:
            P.fp.disable("columnar/compact-stall")
        assert moved == (1, 0)
        return got

    run_both(case)


def test_replica_views_equal_the_jax_package():
    """The same DML on both packages leaves the same replica: stable and
    delta rows, applied events, compactions, the applied and stable floors,
    the feeds' views."""
    def case(P):
        s = replicated_pair(P)
        views = [s.store.columnar.views()]
        s.execute("UPDATE t SET v = 100 WHERE id = 3")
        s.execute("UPDATE t SET v = 200 WHERE id = 3")
        s.execute("DELETE FROM t WHERE id = 4")
        s.execute("INSERT INTO pt VALUES (90, 1), (91, 2)")
        with P.fp.enabled("columnar/compact-stall"):
            s.store.pd.tick()
            views.append(s.store.columnar.views())
        s.store.pd.tick()
        views.append(s.store.columnar.views())
        tables = sorted((t.pid, t.view()) for t in s.store.columnar.tables())
        feeds = sorted((v["name"], v["state"], v["checkpoint_ts"], v["emitted"], v["skipped"])
                       for v in s.store.cdc.views())
        assert all(v["on_device"] and not v["error"] for _pid, v in tables)
        return views, tables, feeds

    run_both(case)


class _Counted:
    """Counts the calls of a module function and passes them on."""

    def __init__(self, monkeypatch, mod, name):
        self.calls, self.args = 0, []
        real = getattr(mod, name)

        def fn(*a, **k):
            self.calls += 1
            self.args.append((a, k))
            return real(*a, **k)

        monkeypatch.setattr(mod, name, fn)


def test_compacted_full_scan_runs_from_the_stable_batch(monkeypatch):
    """The routed GROUP BY over a compacted table drives the program
    straight from the table's stable batch: drive_program_info gets that
    batch object, and run_dag_on_chunks (the host chunk path) is not
    called."""
    import tidb_tpu_torch.exec.executor as EX

    s = replicated_pair(PORT)
    t = s.store.columnar.table_for(s.catalog.table("t").table_id)
    chunks = _Counted(monkeypatch, EX, "run_dag_on_chunks")
    drive = _Counted(monkeypatch, EX, "drive_program_info")
    sc0 = metrics.COLUMNAR_SCANS.value
    rows = s.execute("SELECT g, count(*), sum(v) FROM t GROUP BY g").values()
    assert metrics.COLUMNAR_SCANS.value == sc0 + 1
    assert chunks.calls == 0
    assert drive.calls == 1 and drive.args[0][0][2][0] is t._stable_batch
    s.execute("SET tidb_isolation_read_engines = 'tpu'")
    assert sorted(map(str, rows)) == sorted(map(str, s.execute("SELECT g, count(*), sum(v) FROM t GROUP BY g").values()))


def test_uncompacted_delta_takes_the_overlay_path(monkeypatch):
    """Applied but unfolded DML: the routed read merges the delta overlay
    on the host and runs through run_dag_on_chunks once, on the store's
    device; after the fold it is back on the stable batch."""
    import tidb_tpu_torch.exec.executor as EX

    s = replicated_pair(PORT)
    sql = "SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g"
    with failpoint.enabled("columnar/compact-stall"):
        s.execute("UPDATE t SET v = v + 1 WHERE id < 5")
        s.store.pd.tick()
        chunks = _Counted(monkeypatch, EX, "run_dag_on_chunks")
        sc0 = metrics.COLUMNAR_SCANS.value
        got = s.execute(sql).values()
        assert metrics.COLUMNAR_SCANS.value == sc0 + 1
        assert chunks.calls == 1 and chunks.args[0][1]["device"] == s.store.device
    s.store.pd.tick()
    again = _Counted(monkeypatch, EX, "run_dag_on_chunks")
    assert s.execute(sql).values() == got and again.calls == 0
    s.execute("SET tidb_isolation_read_engines = 'tpu'")
    assert s.execute(sql).values() == got


def test_stable_batch_lives_on_the_store_device(monkeypatch):
    """compact() uploads to the store's device: every tensor of the stable
    batch is there, and the upload was asked for that device."""
    import tidb_tpu_torch.chunk.device as CD

    uploads = _Counted(monkeypatch, CD, "to_device_batch")
    s = replicated_pair(PORT)
    assert uploads.calls == 4  # t and pt's three partitions, one each
    assert all(k["device"] == s.store.device for _a, k in uploads.args)
    for t in s.store.columnar.tables():
        b = t._stable_batch
        assert b is not None and b.device == s.store.device
        assert all(c.data.device == s.store.device and c.null.device == s.store.device for c in b.cols)
