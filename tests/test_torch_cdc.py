"""The port's change data capture (tidb_tpu_torch/cdc/) on the CPU.

The first part is tests/test_cdc.py on a port `Session(device="cpu")`: its
cases but four, which live beside the harness they need —
test_resume_after_stall_redelivers_exactly_once_in_order and
test_cdc_chaos_mirror_equality_acceptance (the port's
tidb_tpu_torch/tools/chaos.py) in tests/test_torch_storms.py,
test_cdc_lockwatch_storm (tidb_tpu_torch/analysis/lockwatch.py) in
tests/test_torch_lockwatch.py, and test_http_api_routes in
tests/test_torch_http_api.py.

The second part holds the port's event streams against the JAX package's:
the same statements go through a JAX `Session` and a port `Session`,
single-threaded, each with its own feed, and the events (commit_ts, table,
handle, op, column ids and datums; the SchemaEvents of a mid-feed ADD /
CHANGE COLUMN with their payloads) and a file:// feed's parsed records must
be equal. Tolerance: exact.
"""

import os
import sys

import pytest

from tidb_tpu_torch.cdc import (
    ChangefeedError,
    FileSink,
    MemorySink,
    SessionReplaySink,
)
from tidb_tpu_torch.codec import tablecodec
from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.util import failpoint, metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def make_session():
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))")
    return s


def feed_on(s, name="f", sink=None, tables=("t",), start_ts=0):
    sink = sink or MemorySink()
    ids = None
    if tables is not None:
        ids = set()
        for t in tables:
            meta = s.catalog.table(t)
            ids.add(meta.table_id)
            ids.update(meta.physical_ids())
    return s.store.cdc.create(name, sink, s.catalog, table_ids=ids, start_ts=start_ts)


def plain(ev):
    return (ev.table, ev.handle, ev.op, ev.commit_ts,
            tuple((n, None if d.is_null() else d.val) for n, d in ev.columns))


# ------------------------------------------------------------ the pipeline

class TestPipeline:
    def test_insert_update_delete_stream_in_commit_order(self):
        s = make_session()
        feed = feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b')")
        s.execute("UPDATE t SET v = 11 WHERE id = 1")
        s.execute("DELETE FROM t WHERE id = 2")
        emitted = s.store.cdc.tick()
        rows = feed.sink.rows()
        assert emitted == len(rows) == 4
        # commit-ts order, ops decoded, deletes carry no columns
        assert [r.commit_ts for r in rows] == sorted(r.commit_ts for r in rows)
        assert [(r.handle, r.op) for r in rows] == [(1, "put"), (2, "put"), (1, "put"), (2, "delete")]
        assert dict(rows[2].columns)["v"].val == 11
        assert rows[3].columns == ()

    def test_emission_gated_on_resolved_frontier(self):
        """Every emitted row's commit_ts is at or below the resolved ts
        flushed right after it — the transactionally-complete-prefix
        contract."""
        s = make_session()
        feed = feed_on(s)
        for i in range(6):
            s.execute(f"INSERT INTO t VALUES ({i}, {i}, 'x')")
            s.store.cdc.tick()
        marks = feed.sink.resolved_view()
        assert marks == sorted(marks)
        assert all(ev.commit_ts <= marks[-1] for ev in feed.sink.rows())

    def test_initial_incremental_scan_replays_history(self):
        """A feed created AFTER writes still streams them: the birth
        incremental scan covers (start_ts, now]."""
        s = make_session()
        s.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b')")
        s.execute("UPDATE t SET v = 99 WHERE id = 2")
        feed = feed_on(s)
        s.store.cdc.tick()
        got = [(r.handle, r.op) for r in feed.sink.rows()]
        assert got == [(1, "put"), (2, "put"), (2, "put")]  # full MVCC history
        assert metrics.CDC_RECOVERY_SCANS.value > 0

    def test_start_ts_excludes_older_commits(self):
        s = make_session()
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        cut = s.store.kv.max_committed()
        s.execute("INSERT INTO t VALUES (2, 20, 'b')")
        feed = feed_on(s, start_ts=cut)
        s.store.cdc.tick()
        assert [r.handle for r in feed.sink.rows()] == [2]

    def test_table_filter_and_index_entries_skipped(self):
        s = make_session()
        s.execute("CREATE TABLE other (id BIGINT PRIMARY KEY, x BIGINT)")
        s.execute("CREATE INDEX iv ON t (v)")
        feed = feed_on(s, tables=("t",))
        sk0 = metrics.CDC_EVENTS_SKIPPED.value
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")  # row + index entry
        s.execute("INSERT INTO other VALUES (5, 50)")  # filtered out
        s.store.cdc.tick()
        assert [(r.table, r.handle) for r in feed.sink.rows()] == [("t", 1)]
        # the index entry was captured (same table) but skipped at mount
        assert metrics.CDC_EVENTS_SKIPPED.value > sk0

    def test_split_and_merge_hand_off_watermarks(self):
        s = make_session()
        s.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i},'x')" for i in range(40)))
        feed = feed_on(s)
        s.store.cdc.tick()
        tid = s.catalog.table("t").table_id
        parent = s.store.cluster.locate(tablecodec.encode_row_key(tid, 0))
        child = s.store.cluster.split(tablecodec.encode_row_key(tid, 20))
        with feed._mu:
            assert feed._watermark[child.region_id] == feed._watermark[parent.region_id]
        before = feed.view(s.store)["checkpoint_ts"]
        s.execute("UPDATE t SET v = 100 WHERE id = 30")  # lands in the child
        s.store.cdc.tick()
        assert feed.view(s.store)["checkpoint_ts"] > before
        merged = s.store.cluster.merge(parent.region_id)
        assert merged is not None
        s.execute("UPDATE t SET v = 101 WHERE id = 5")
        s.store.cdc.tick()
        rows = [r for r in feed.sink.rows() if r.op == "put" and dict(r.columns)["v"].val == 101]
        assert rows, "event across a merge was lost"

    def test_changefeed_pins_gc_safepoint_at_checkpoint(self):
        """The checkpoint is a GC service safepoint (TiCDC's PD service
        safepoint): versions the feed still has to scan survive GC."""
        s = make_session()
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.execute("UPDATE t SET v = 11 WHERE id = 1")
        s.execute("UPDATE t SET v = 12 WHERE id = 1")
        feed = feed_on(s)  # checkpoint 0: everything pinned
        s.store.run_gc()
        key = tablecodec.encode_row_key(s.catalog.table("t").table_id, 1)
        with s.store.kv.lock:
            versions = list(s.store.kv._data.get(key, ()))
        assert len(versions) == 3, "GC collected history a feed still needs"
        s.store.cdc.tick()
        assert [dict(r.columns)["v"].val for r in feed.sink.rows()] == [10, 11, 12]
        s.store.run_gc()  # checkpoint advanced past the history: GC may fold
        with s.store.kv.lock:
            assert len(s.store.kv._data.get(key, ())) == 1


# ------------------------------------------------------- mounter parity

class TestMounterParity:
    def test_every_column_type_round_trips(self):
        """put_row -> replication log -> mounter
        equals a direct table scan for every supported column type."""
        s = Session(device="cpu")
        s.execute(
            "CREATE TABLE alltypes ("
            " id BIGINT PRIMARY KEY, ti TINYINT, u BIGINT UNSIGNED,"
            " f FLOAT, d DOUBLE, dec DECIMAL(12,3), dt DATETIME, da DATE,"
            " j JSON, e ENUM('red','green','blue'),"
            " sc VARCHAR(32) COLLATE utf8mb4_general_ci, sb VARBINARY(32))"
        )
        s.execute(
            "INSERT INTO alltypes VALUES"
            " (1, -7, 18446744073709551610, 1.5, 2.25, 12345.678,"
            "  '2024-03-01 12:30:45', '2023-12-31', '{\"k\": [1, 2, {\"n\": true}]}',"
            "  'green', 'MixedCase', 'raw'),"
            " (2, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL)"
        )
        feed = feed_on(s, tables=("alltypes",))
        s.store.cdc.tick()
        rows = {r.handle: dict(r.columns) for r in feed.sink.rows()}
        assert set(rows) == {1, 2}
        res = s.execute("SELECT * FROM alltypes ORDER BY id")
        names = [c.lower() for c in res.columns]
        for handle, sel in zip((1, 2), res.rows):
            mounted = rows[handle]
            for name, d in zip(names, sel):
                m = mounted[name]
                assert m.is_null() == d.is_null(), (name, m, d)
                if not d.is_null():
                    assert str(m.val) == str(d.val), (name, m, d)


# ----------------------------------------------------------- lifecycle

class TestLifecycle:
    def test_pause_resume_catches_up_from_checkpoint(self):
        s = make_session()
        feed = feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.cdc.tick()
        s.store.cdc.pause("f")
        s.execute("INSERT INTO t VALUES (2, 20, 'b')")
        s.store.cdc.tick()
        assert [r.handle for r in feed.sink.rows()] == [1]  # paused: nothing
        s.store.cdc.resume("f")
        s.store.cdc.tick()
        assert [r.handle for r in feed.sink.rows()] == [1, 2]  # caught up

    def test_duplicate_and_unknown_names_are_typed_errors(self):
        s = make_session()
        feed_on(s)
        with pytest.raises(ChangefeedError):
            feed_on(s)
        with pytest.raises(ChangefeedError):
            s.store.cdc.drop("nope")

    def test_drop_unpins_gc_and_closes_sink(self):
        s = make_session()
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.execute("UPDATE t SET v = 11 WHERE id = 1")
        feed = feed_on(s)
        s.store.cdc.drop("f")
        s.store.run_gc()
        key = tablecodec.encode_row_key(s.catalog.table("t").table_id, 1)
        with s.store.kv.lock:
            assert len(s.store.kv._data.get(key, ())) == 1  # pin released
        assert feed.state == "removed"

    def test_sink_failure_parks_feed_in_error_and_resume_retries(self):
        class FlakySink(MemorySink):
            def __init__(self):
                super().__init__()
                self.fail = True

            def write(self, events):
                if self.fail:
                    raise OSError("downstream unavailable")
                super().write(events)

        s = make_session()
        sink = FlakySink()
        feed = feed_on(s, sink=sink)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.cdc.tick()
        assert feed.view(s.store)["state"] == "error"
        assert "downstream unavailable" in feed.view(s.store)["error"]
        sink.fail = False
        s.store.cdc.resume("f")
        s.store.cdc.tick()
        assert feed.view(s.store)["state"] == "normal"
        assert [r.handle for r in sink.rows()] == [1]  # the batch was not lost


# ----------------------------------------------------- SQL + HTTP surfaces

class TestSurfaces:
    def test_sql_lifecycle_and_show(self, tmp_path):
        s = make_session()
        s.execute(f"CREATE CHANGEFEED cf INTO 'file://{tmp_path}/out' FOR TABLE t WITH start_ts = 0")
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.pd.tick()  # the pd.cdc phase drives the feed
        row = s.execute("SHOW CHANGEFEEDS").values()[0]
        assert row[0] == "cf" and row[1] == "normal" and row[7] >= 1
        s.execute("PAUSE CHANGEFEED cf")
        assert s.execute("SHOW CHANGEFEEDS").values()[0][1] == "paused"
        s.execute("RESUME CHANGEFEED cf")
        # the file sink writes atomic segments per flush, each
        # ending in a resolved mark — never a single append-mode file
        recs = FileSink(f"{tmp_path}/out", "cf").read_records()
        assert "row" in {r.get("type") for r in recs}
        assert recs[-1]["type"] == "resolved"
        s.execute("DROP CHANGEFEED cf")
        assert s.execute("SHOW CHANGEFEEDS").values() == []
        with pytest.raises(SQLError):
            s.execute("DROP CHANGEFEED cf")
        with pytest.raises(SQLError):
            s.execute("CREATE CHANGEFEED bad INTO 'kafka://x'")

    def test_bad_start_ts_is_a_typed_error(self):
        s = make_session()
        with pytest.raises(SQLError):
            s.execute("CREATE CHANGEFEED b INTO 'memory://' WITH start_ts = 'abc'")
        with pytest.raises(SQLError):
            s.execute("CREATE CHANGEFEED b INTO 'memory://' WITH start_ts = 1.5")
        with pytest.raises(SQLError):
            s.execute("CREATE CHANGEFEED b INTO 'memory://' WITH start_ts")
        assert s.execute("SHOW CHANGEFEEDS").values() == []  # nothing created

    def test_show_changefeed_name_is_exact_not_like(self):
        s = make_session()
        feed_on(s, name="my_feed")
        feed_on(s, name="myxfeed")
        rows = s.execute("SHOW CHANGEFEED my_feed").values()
        assert [r[0] for r in rows] == ["my_feed"]  # `_` is not a wildcard

    def test_partial_sink_failure_redelivers_without_duplicates(self):
        """At-least-once across a sink failure: the replay sink applies a
        prefix, fails mid-batch, and after RESUME the redelivered prefix
        dedupes by (key, commit_ts) — the mirror ends exact, one version
        per commit."""
        src = make_session()
        mirror = Session(device="cpu")
        mirror.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))")
        feed = feed_on(src, sink=SessionReplaySink(mirror), tables=None)
        src.execute("INSERT INTO t VALUES (1, 10, 'a')")
        src.execute("CREATE TABLE t2 (id BIGINT PRIMARY KEY)")  # not on mirror
        src.execute("INSERT INTO t2 VALUES (7)")
        src.store.cdc.tick()  # t row applies, then t2 fails the batch
        assert feed.view(src.store)["state"] == "error"
        mirror.execute("CREATE TABLE t2 (id BIGINT PRIMARY KEY)")
        src.store.cdc.resume("f")
        src.store.cdc.tick()
        assert feed.view(src.store)["state"] == "normal"
        assert mirror.execute("SELECT * FROM t ORDER BY id").values() == [[1, 10, "a"]]
        assert mirror.execute("SELECT * FROM t2").values() == [[7]]
        key = tablecodec.encode_row_key(src.catalog.table("t").table_id, 1)
        with mirror.store.kv.lock:
            versions = list(mirror.store.kv._data.get(key, ()))
        assert len(versions) == 1, versions  # redelivery deduped

    def test_trace_has_pd_cdc_phase(self):
        s = make_session()
        feed_on(s)
        s.store.pd.tick()
        root = s.store.pd.last_tick_root
        assert any(c.name == "pd.cdc" for c in root.children)

    def test_cdc_metric_families_pass_scrape_check(self):
        """The tier-1 exposition gate extended to the
        tidb_tpu_cdc_* families."""
        s = make_session()
        feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.cdc.tick()
        text = metrics.REGISTRY.dump()
        for family in (
            "tidb_tpu_cdc_events_total",
            "tidb_tpu_cdc_events_emitted_total",
            "tidb_tpu_cdc_events_skipped_total",
            "tidb_tpu_cdc_resolved_ts_lag",
            "tidb_tpu_cdc_sink_flush_seconds",
            "tidb_tpu_cdc_recovery_scans_total",
        ):
            assert f"# TYPE {family} " in text, family
        assert 'tidb_tpu_cdc_resolved_ts_lag{changefeed="f"}' in text
        from scrape_check import validate

        assert validate(text) == []


# ----------------------------------------------------------- failpoints

class TestFailpoints:
    def test_puller_drop_recovers_by_incremental_scan(self):
        s = make_session()
        feed = feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        with failpoint.enabled("cdc/puller-drop"):
            s.execute("INSERT INTO t VALUES (2, 20, 'b')")
            s.execute("DELETE FROM t WHERE id = 1")
        s.store.cdc.tick()
        got = [(r.handle, r.op) for r in feed.sink.rows()]
        assert got == [(1, "put"), (2, "put"), (1, "delete")]  # late, not lost

    def test_resolved_stuck_pins_then_resumes(self):
        s = make_session()
        feed = feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.cdc.tick()
        pinned = feed.view(s.store)["checkpoint_ts"]
        with failpoint.enabled("cdc/resolved-stuck"):
            s.execute("INSERT INTO t VALUES (2, 20, 'b')")
            for _ in range(3):
                s.store.cdc.tick()
            assert feed.view(s.store)["checkpoint_ts"] == pinned
            assert [r.handle for r in feed.sink.rows()] == [1]  # gated
        s.store.cdc.tick()
        assert feed.view(s.store)["checkpoint_ts"] > pinned
        assert [r.handle for r in feed.sink.rows()] == [1, 2]

    def test_sink_stall_holds_checkpoint_then_flushes_backlog(self):
        s = make_session()
        feed = feed_on(s)
        s.execute("INSERT INTO t VALUES (1, 10, 'a')")
        s.store.cdc.tick()
        held = feed.view(s.store)["checkpoint_ts"]
        with failpoint.enabled("cdc/sink-stall"):
            s.execute("INSERT INTO t VALUES (2, 20, 'b')")
            s.store.cdc.tick()
            assert feed.view(s.store)["checkpoint_ts"] == held
            assert len(feed.sink.rows()) == 1
        s.store.cdc.tick()
        assert len(feed.sink.rows()) == 2
        assert feed.view(s.store)["checkpoint_ts"] > held


# ------------------------------------------------ parity with the JAX package

import tidb_tpu.cdc as j_cdc  # noqa: E402
import tidb_tpu_torch.cdc as p_cdc  # noqa: E402
from torch_sql_parity import JAX, PORT, norm, run_both  # noqa: E402

CDC = {"jax": j_cdc, "port": p_cdc}


def event_list(events) -> list:
    """A sink's events as plain values: a row's commit_ts, table, table id,
    handle, op, column ids and datums; a schema event's commit_ts, table,
    version, DDL type, text and payload."""
    out = []
    for e in events:
        if type(e).__name__ == "SchemaEvent":
            out.append(["schema", e.commit_ts, e.table, e.table_id, e.schema_version, e.op, e.query,
                        norm(e.payload)])
        else:
            out.append(["row", e.commit_ts, e.table, e.table_id, e.handle, e.op, list(e.col_ids),
                        norm(list(e.columns))])
    return out


def parity_session(P):
    s = P.new_session()
    s.execute("SET tidb_enable_tpu_mesh = 0")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))")
    return s


def memory_feed(P, s, tables=("t",), name="f", start_ts=0):
    ids = set()
    for t in tables:
        meta = s.catalog.table(t)
        ids.add(meta.table_id)
        ids.update(meta.physical_ids())
    return s.store.cdc.create(name, CDC[P.name].MemorySink(), s.catalog, table_ids=ids, start_ts=start_ts)


def _dml(P):
    s = parity_session(P)
    s.execute("CREATE INDEX iv ON t (v)")
    s.execute("CREATE TABLE other (id BIGINT PRIMARY KEY, x BIGINT)")
    feed = memory_feed(P, s)
    s.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, NULL)")
    s.execute("INSERT INTO other VALUES (5, 50)")
    s.store.cdc.tick()
    s.execute("UPDATE t SET v = v + 1 WHERE id >= 2")
    s.execute("BEGIN")
    s.execute("INSERT INTO t VALUES (4, 40, 'd')")
    s.execute("DELETE FROM t WHERE id = 1")
    s.execute("UPDATE t SET name = 'bb' WHERE id = 2")
    s.execute("COMMIT")
    s.store.pd.tick()
    return event_list(feed.sink.rows()), feed.view(s.store)["emitted"], feed.view(s.store)["skipped"]


def _history(P):
    s = parity_session(P)
    s.execute("INSERT INTO t VALUES " + ",".join(f"({i}, {i * 3}, 'n{i}')" for i in range(12)))
    s.execute("UPDATE t SET v = 99 WHERE id < 4")
    s.execute("DELETE FROM t WHERE id > 9")
    feed = memory_feed(P, s)  # born after the writes: the birth scan replays them
    s.store.cdc.tick()
    return event_list(feed.sink.rows())


def _alter(P):
    s = parity_session(P)
    feed = memory_feed(P, s)
    s.execute("INSERT INTO t VALUES (1, 10, 'a')")
    s.store.cdc.tick()
    s.execute("ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 7")
    s.execute("INSERT INTO t VALUES (2, 20, 'b', 21)")
    s.execute("ALTER TABLE t CHANGE COLUMN v vol BIGINT")
    s.execute("INSERT INTO t VALUES (3, 30, 'c', 31)")
    s.execute("UPDATE t SET vol = vol + 1 WHERE id = 1")
    s.store.cdc.tick()
    evs = event_list(feed.sink.rows())
    assert [e[5] for e in evs if e[0] == "schema"] == ["add column", "rename column"]
    journal = len(s.store.schema_journal)
    s.store.pd.tick()  # pd.pitr trims the journal below every feed's checkpoint
    return evs, journal, len(s.store.schema_journal)


def _paused_across_alter(P):
    s = parity_session(P)
    feed = memory_feed(P, s)
    s.execute("INSERT INTO t VALUES (1, 10, 'a')")
    s.store.cdc.pause("f")
    s.execute("ALTER TABLE t ADD COLUMN w BIGINT DEFAULT 7")
    s.execute("INSERT INTO t VALUES (2, 20, 'b', 21)")
    s.store.cdc.resume("f")
    s.store.cdc.tick()
    return event_list(feed.sink.rows()), feed.view(s.store)["state"]


def _types(P):
    s = P.new_session()
    s.execute("CREATE TABLE alltypes (id BIGINT PRIMARY KEY, ti TINYINT, u BIGINT UNSIGNED, f FLOAT, d DOUBLE,"
              " dec DECIMAL(12,3), dt DATETIME, da DATE, j JSON, e ENUM('red','green','blue'),"
              " sc VARCHAR(32) COLLATE utf8mb4_general_ci, sb VARBINARY(32))")
    feed = memory_feed(P, s, tables=("alltypes",))
    s.execute("INSERT INTO alltypes VALUES (1, -7, 18446744073709551610, 1.5, 2.25, 12345.678,"
              " '2024-03-01 12:30:45', '2023-12-31', '{\"k\": [1, 2, {\"n\": true}]}', 'green', 'MixedCase', 'raw'),"
              " (2, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL)")
    s.execute("UPDATE alltypes SET dec = dec * 2, sc = 'x' WHERE id = 1")
    s.store.cdc.tick()
    return event_list(feed.sink.rows())


def _partitioned(P):
    s = P.new_session()
    s.execute("CREATE TABLE pm (id BIGINT, p BIGINT, v BIGINT) PARTITION BY HASH(p) PARTITIONS 4")
    feed = memory_feed(P, s, tables=("pm",))
    s.execute("INSERT INTO pm VALUES (1, 3, 10), (2, 1, 20), (3, 2, 30)")
    s.execute("UPDATE pm SET p = 0 WHERE id = 1")  # moves the row across partitions
    s.execute("DELETE FROM pm WHERE id = 2")
    s.store.cdc.tick()
    return event_list(feed.sink.rows())


def _failpoints(P):
    s = parity_session(P)
    feed = memory_feed(P, s)
    s.execute("INSERT INTO t VALUES (1, 10, 'a')")
    with P.fp.enabled("cdc/puller-drop"):
        s.execute("INSERT INTO t VALUES (2, 20, 'b')")
    with P.fp.enabled("cdc/resolved-stuck"):
        s.execute("UPDATE t SET v = 11 WHERE id = 1")
        s.store.cdc.tick()
    with P.fp.enabled("cdc/sink-stall"):
        s.execute("DELETE FROM t WHERE id = 2")
        s.store.cdc.tick()
    held = len(feed.sink.rows())
    s.store.cdc.tick()
    return held, event_list(feed.sink.rows())


def _replay(P):
    src = parity_session(P)
    mirror = P.new_session()
    mirror.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, name VARCHAR(16))")
    src.store.cdc.create("m", CDC[P.name].SessionReplaySink(mirror), src.catalog, start_ts=0)
    src.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c')")
    src.execute("UPDATE t SET v = v * 2 WHERE id > 1")
    src.execute("DELETE FROM t WHERE id = 1")
    src.store.cdc.tick()
    return norm(mirror.execute("SELECT * FROM t ORDER BY id").rows)


SCENARIOS = {"dml": _dml, "history": _history, "alter": _alter, "paused_across_alter": _paused_across_alter,
             "types": _types, "partitioned": _partitioned, "failpoints": _failpoints, "replay": _replay}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_event_streams_equal_the_jax_package(scenario):
    run_both(SCENARIOS[scenario])


def test_file_sink_records_equal_the_jax_package(tmp_path):
    """A file:// feed over SQL: the parsed segment records (rows, resolved
    marks) of the two packages are equal, and their rows are exactly the
    committed changes, each once, in commit order."""
    def case(P):
        s = parity_session(P)
        out = tmp_path / P.name
        s.execute(f"CREATE CHANGEFEED cf INTO 'file://{out}' FOR TABLE t WITH start_ts = 0")
        s.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b')")
        s.store.pd.tick()
        s.execute("BEGIN")
        s.execute("UPDATE t SET v = 11 WHERE id = 1")
        s.execute("DELETE FROM t WHERE id = 2")
        s.execute("COMMIT")
        s.store.pd.tick()
        recs = CDC[P.name].FileSink(str(out), "cf").read_records()
        rows = [r for r in recs if r["type"] == "row"]
        assert [(r["handle"], r["op"]) for r in rows] == [(1, "put"), (2, "put"), (1, "put"), (2, "delete")]
        assert [r["commit_ts"] for r in rows] == sorted(r["commit_ts"] for r in rows)
        s.execute("DROP CHANGEFEED cf")
        return recs

    run_both(case)
