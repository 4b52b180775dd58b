"""The production front door of the port's session on the CPU: the cases
of tests/test_front_door.py over port `Session(device="cpu")`s but
test_shared_plan_cache_lockwatch_storm, which runs under the port's
tidb_tpu_torch/analysis/lockwatch.py in tests/test_torch_lockwatch.py —
the digest-keyed plan cache across its three tiers
(pointget / dag / ast), typed decline reasons, invalidation on schema,
sysvar and binding drift, PREPARE / EXECUTE digest sharing, the probe that
never leaks into nested selects, admission control with typed
ServerIsBusy shedding on the Backoffer's server_busy budget, and the
per-session memory quota. Re-bound hits are held to the cold plan's rows,
Datum by kind and value.
"""

import os
import sys
import threading
import time

import pytest

from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.util import failpoint, metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def make_session(rows=8):
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, "
              "k VARCHAR(20), KEY iv (v))")
    if rows:
        s.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{i * 10},'x{i}')" for i in range(rows)))
    return s


def hits():
    return metrics.PLAN_CACHE_HITS.value


def misses():
    return metrics.PLAN_CACHE_MISSES.value


def declines(reason):
    return metrics.PLAN_CACHE_DECLINES.labels(reason).value


def cold_rows(s, sql):
    """The statement's rows with the plan cache OFF — the byte-equality
    oracle for re-bound hits."""
    s.execute("SET tidb_enable_plan_cache = OFF")
    try:
        return s.execute(sql).rows
    finally:
        s.execute("SET tidb_enable_plan_cache = ON")


def same_rows(a, b):
    """Byte-level row equality: datum kinds AND values."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for da, db in zip(ra, rb):
            assert da.kind == db.kind and da.val == db.val, (da, db)


# ------------------------------------------------------------ cache matrix

class TestPlanCacheMatrix:
    def test_pointget_tier_hit_and_value_rebind(self):
        s = make_session()
        h0, m0 = hits(), misses()
        assert s.execute("select v from t where id = 3").values() == [[30]]
        assert (hits(), misses()) == (h0, m0 + 1)  # cold: install
        assert s.execute("select v from t where id = 3").values() == [[30]]
        assert (hits(), misses()) == (h0 + 1, m0 + 1)  # identical shape: hit
        # a DIFFERENT literal re-binds into the same template
        assert s.execute("select v from t where id = 5").values() == [[50]]
        assert hits() == h0 + 2
        assert s.catalog.plan_cache.stats()["tiers"]["pointget"] == 1

    def test_dag_tier_selection_rebind_byte_equal(self):
        s = make_session()
        sql = "select v from t where k = 'x4'"
        oracle = cold_rows(s, sql)
        s.execute("select v from t where k = 'x2'")  # install
        assert s.catalog.plan_cache.stats()["tiers"]["dag"] >= 1
        h0 = hits()
        got = s.execute(sql).rows
        assert hits() == h0 + 1
        same_rows(got, oracle)

    def test_handle_range_rebind_byte_equal(self):
        s = make_session()
        sql = "select v, k from t where id >= 2 and id < 6 order by id"
        oracle = cold_rows(s, sql)
        s.execute("select v, k from t where id >= 1 and id < 3 order by id")
        h0 = hits()
        got = s.execute(sql).rows
        assert hits() == h0 + 1
        same_rows(got, oracle)

    def test_ast_tier_index_range_hit(self):
        s = make_session()
        sql = "select k from t where v >= 20 and v < 51 order by v"
        oracle = cold_rows(s, sql)
        s.execute("select k from t where v >= 10 and v < 31 order by v")
        h0 = hits()
        got = s.execute(sql).rows
        assert hits() == h0 + 1
        same_rows(got, oracle)

    def test_miss_on_alter_table_schema_fingerprint(self):
        s = make_session()
        s.execute("select v from t where id = 2")
        h0 = hits()
        assert s.execute("select v from t where id = 2").values() == [[20]]
        assert hits() == h0 + 1
        s.execute("alter table t add column w bigint")
        h1, m1 = hits(), misses()
        assert s.execute("select v from t where id = 2").values() == [[20]]
        # schema drift dropped the entry: miss + reinstall, then hits again
        assert (hits(), misses()) == (h1, m1 + 1)
        assert s.execute("select v from t where id = 2").values() == [[20]]
        assert hits() == h1 + 1

    def test_miss_on_plan_sysvar_change(self):
        s = make_session()
        s.execute("select v from t where id = 2")
        for set_sql in ("set tidb_isolation_read_engines = 'tpu'",
                        "set sql_mode = ''"):
            s.execute(set_sql)
            h0, m0 = hits(), misses()
            assert s.execute("select v from t where id = 2").values() == [[20]]
            # the sysvar fingerprint is part of the KEY: other entries
            assert (hits(), misses()) == (h0, m0 + 1)

    def test_prepare_execute_shares_entry_and_summary_digest(self):
        s = make_session()
        s.execute("prepare st from 'select v from t where id = ?'")
        s.execute("set @a = 2")
        m0 = misses()
        assert s.execute("execute st using @a").values() == [[20]]
        assert misses() == m0 + 1  # EXECUTE installed the entry
        h0 = hits()
        # the DIRECT textual form digests identically: instant hit
        assert s.execute("select v from t where id = 6").values() == [[60]]
        assert hits() == h0 + 1
        assert s.execute("execute st using @a").values() == [[20]]
        assert hits() == h0 + 2
        # satellite: EXECUTE records under the UNDERLYING statement's
        # digest — one summary row for the prepared + direct forms
        r = s.execute(
            "select exec_count from information_schema.statements_summary "
            "where digest_text = 'select v from t where id = ?'")
        assert len(r.rows) == 1 and int(r.rows[0][0].val) == 3

    def test_execute_param_rebind_byte_equal_cold(self):
        s = make_session()
        oracle = cold_rows(s, "select v, k from t where id = 5")
        s.execute("prepare st from 'select v, k from t where id = ?'")
        s.execute("set @p = 1")
        s.execute("execute st using @p")  # install
        s.execute("set @p = 5")
        h0 = hits()
        got = s.execute("execute st using @p").rows
        assert hits() == h0 + 1
        same_rows(got, oracle)

    def test_decline_reasons_typed_and_counted(self):
        s = make_session()
        cases = [
            ("select v from t where id = (select max(id) from t)", "subquery"),
            ("select * from (select v from t) d", "derived_table"),
            ("select @x", "user_var"),
            ("select 1", "no_table"),
        ]
        for sql, reason in cases:
            d0 = declines(reason)
            s.execute(sql)
            assert declines(reason) == d0 + 1, reason
        # session-state reasons: open txn + stale read
        s.execute("begin")
        d0 = declines("in_txn")
        s.execute("select v from t where id = 1")
        assert declines("in_txn") == d0 + 1
        s.execute("commit")
        ts = s.store.kv.max_committed()
        s.execute(f"set tidb_snapshot = '{ts}'")
        d0 = declines("stale_read")
        s.execute("select v from t where id = 1")
        assert declines("stale_read") == d0 + 1
        s.execute("set tidb_snapshot = ''")
        # non-SELECT kinds decline typed too
        d0 = declines("not_select")
        s.execute("insert into t values (100, 1000, 'y')")
        assert declines("not_select") == d0 + 1

    def test_explain_surfaces_cacheability(self):
        s = make_session()
        r = s.execute("explain select v from t where id = 1").values()
        assert ["plan_cache: cacheable"] in r
        r = s.execute(
            "explain select v from t where id = (select max(id) from t)"
        ).values()
        assert ["plan_cache: decline(subquery)"] in r

    def test_explain_analyze_plan_cache_row_and_trace_span(self):
        s = make_session()
        # EXPLAIN ANALYZE probes with the INNER statement's digest, so
        # the first run misses and the second hits — attributably
        r = s.execute("explain analyze select v from t where id = 1")
        rows = {str(x[0].val): str(x[5].val) for x in r.rows}
        assert rows.get("plan_cache") == "miss"
        r = s.execute("explain analyze select v from t where id = 1")
        rows = {str(x[0].val): str(x[5].val) for x in r.rows}
        assert rows.get("plan_cache") == "hit(pointget)"
        tr = s.execute("TRACE select v from t where id = 1").values()
        assert any("session.plan_cache" in str(row[0]) for row in tr)

    def test_lru_eviction_bounded_and_counted(self):
        s = make_session()
        s.execute("set tidb_plan_cache_size = 2")
        e0 = metrics.PLAN_CACHE_EVICTIONS.value
        s.execute("select v from t where id = 1")
        s.execute("select k from t where id = 1")
        s.execute("select id from t where v = 10")
        assert len(s.catalog.plan_cache) <= 2
        assert metrics.PLAN_CACHE_EVICTIONS.value > e0

    def test_binding_change_invalidates(self):
        s = make_session()
        s.execute("select v from t where id = 2")
        h0 = hits()
        s.execute("select v from t where id = 2")
        assert hits() == h0 + 1
        s.execute("create global binding for select v from t where id = 1 "
                  "using select /*+ use_index(t, iv) */ v from t where id = 1")
        h1, m1 = hits(), misses()
        s.execute("select v from t where id = 2")
        assert misses() == m1 + 1  # bindings_rev moved: revalidate cold

    def test_disabled_consults_nothing(self):
        s = make_session()
        s.execute("set tidb_enable_plan_cache = OFF")
        h0, m0 = hits(), misses()
        s.execute("select v from t where id = 1")
        s.execute("select v from t where id = 1")
        assert (hits(), misses()) == (h0, m0)


class TestProbeNeverLeaksIntoNestedSelects:
    """The probe names the WHOLE statement's text. A non-SELECT statement
    must drop it before any nested _run_select could install the inner
    select under the outer digest — a later digest-equal statement would
    then serve rows instead of running the DML."""

    def test_insert_select_never_installs_under_insert_digest(self):
        s = make_session(rows=4)
        s.execute("create table t2 (id bigint primary key, v bigint)")
        n0 = len(s.catalog.plan_cache)
        s.execute("insert into t2 select id, v from t where v = 20")
        assert len(s.catalog.plan_cache) == n0  # nothing installed
        s.execute("delete from t2")
        # digest-equal re-run must INSERT, not serve cached select rows
        r = s.execute("insert into t2 select id, v from t where v = 20")
        assert r.affected == 1 and not r.rows
        assert s.execute("select count(*) from t2").values() == [[1]]

    def test_prepared_dml_execute_never_arms_the_plan_cache(self):
        s = make_session(rows=4)
        s.execute("create table t3 (id bigint primary key, v bigint)")
        s.execute("prepare pi from 'insert into t3 select id, v from t where v = ?'")
        s.execute("set @w = 20")
        n0 = len(s.catalog.plan_cache)
        s.execute("execute pi using @w")
        assert len(s.catalog.plan_cache) == n0
        s.execute("delete from t3")
        r = s.execute("execute pi using @w")
        assert r.affected == 1 and not r.rows
        # the summary still joins the underlying digest (the logging ride
        # is independent of the plan-cache arm)
        r = s.execute(
            "select exec_count from information_schema.statements_summary "
            "where digest_text = 'insert into t3 select id , v from t where v = ?'")
        assert len(r.rows) == 1 and int(r.rows[0][0].val) == 2

    def test_create_view_never_installs_under_ddl_digest(self):
        s = make_session(rows=4)
        n0 = len(s.catalog.plan_cache)
        s.execute("create view vv as select id from t where v = 20")
        assert len(s.catalog.plan_cache) == n0
        s.execute("drop view vv")
        s.execute("create view vv as select id from t where v = 20")
        assert s.catalog.view_of("vv") is not None


# ------------------------------------------------------------- admission

class TestAdmission:
    def test_failpoint_shed_is_typed_9003_with_backoff_hint(self):
        s = make_session(rows=2)
        a0 = metrics.ADMISSION_SHED.labels("gate").value
        failpoint.enable("server/admission-full", True)
        try:
            with pytest.raises(SQLError) as ei:
                s.execute("select v from t where id = 1")
        finally:
            failpoint.disable("server/admission-full")
        assert ei.value.code == 9003
        assert ei.value.backoff_ms > 0
        assert "server_is_busy" in str(ei.value)
        assert metrics.ADMISSION_SHED.labels("gate").value == a0 + 1
        # gate cleared: the statement runs
        assert s.execute("select v from t where id = 1").values() == [[10]]

    def test_saturation_sheds_and_backoffer_retry_succeeds(self):
        from tidb_tpu_torch.util.backoff import Backoffer

        s = make_session(rows=2)
        gate = s.store.admission
        gate.configure(max_inflight=1, session_queue=1, queue_wait_ms=2.0,
                       shed_backoff_ms=5)
        entered = threading.Event()
        release = threading.Event()

        def holder():
            with gate.admit("holder"):
                entered.set()
                release.wait(timeout=30)

        th = threading.Thread(target=holder, daemon=True)
        th.start()
        entered.wait(timeout=30)
        s2 = Session(store=s.store, catalog=s.catalog)
        try:
            with pytest.raises(SQLError) as ei:
                s2.execute("select v from t where id = 1")
            assert ei.value.code == 9003
            # the client contract: classify as server_busy, back off on
            # the existing budget, retry — and succeed once load drains
            bo = Backoffer(budget_ms=4000)
            release.set()
            th.join(timeout=30)
            for _ in range(50):
                try:
                    got = s2.execute("select v from t where id = 1").values()
                    break
                except SQLError as exc:
                    assert exc.code == 9003
                    bo.backoff("server_busy",
                               suggested_ms=getattr(exc, "backoff_ms", 0))
            else:
                raise AssertionError("backoffer retries never admitted")
            assert got == [[10]]
        finally:
            gate.configure(max_inflight=0)

    def test_dispatch_gate_sheds_before_tasks(self):
        s = make_session()
        gate = s.store.admission
        gate.configure(max_dispatch=1)
        tok = gate.before_dispatch()  # occupy the only dispatch slot
        try:
            with tok:
                with pytest.raises(SQLError) as ei:
                    # a scan must go through distsql dispatch (not pointget)
                    s.execute("select sum(v) from t")  # noqa: B017
                assert ei.value.code == 9003
        finally:
            gate.configure(max_dispatch=0)
        assert str(s.execute("select sum(v) from t").values()[0][0]) == "280"

    def test_queue_admits_when_slot_frees_in_time(self):
        s = make_session(rows=2)
        gate = s.store.admission
        gate.configure(max_inflight=1, session_queue=2, queue_wait_ms=2000.0)
        entered = threading.Event()

        def holder():
            with gate.admit("holder"):
                entered.set()
                time.sleep(0.15)

        th = threading.Thread(target=holder, daemon=True)
        th.start()
        entered.wait(timeout=30)
        q0 = metrics.ADMISSION_QUEUE_WAITS.value
        try:
            s2 = Session(store=s.store, catalog=s.catalog)
            # waits in the per-session queue, admitted when the holder exits
            assert s2.execute("select v from t where id = 1").values() == [[10]]
            assert metrics.ADMISSION_QUEUE_WAITS.value == q0 + 1
        finally:
            th.join(timeout=30)
            gate.configure(max_inflight=0)

    def test_metric_families_pass_scrape_check(self):
        s = make_session(rows=2)
        failpoint.enable("server/admission-full", True)
        try:
            with pytest.raises(SQLError):
                s.execute("select v from t where id = 1")
        finally:
            failpoint.disable("server/admission-full")
        s.execute("select v from t where id = 1")
        s.execute("select v from t where id = 1")
        text = metrics.REGISTRY.dump()
        for family in (
            "tidb_tpu_plan_cache_hits_total",
            "tidb_tpu_plan_cache_misses_total",
            "tidb_tpu_plan_cache_evictions_total",
            "tidb_tpu_plan_cache_declines_total",
            "tidb_tpu_plan_cache_entries",
            "tidb_tpu_admission_admitted_total",
            "tidb_tpu_admission_shed_total",
            "tidb_tpu_admission_queue_waits_total",
            "tidb_tpu_admission_inflight",
        ):
            assert f"# TYPE {family}" in text, family
        from scrape_check import validate

        assert validate(text) == []


# ------------------------------------------------- session memory quota

class TestSessionMemQuota:
    def test_over_quota_spills_then_types_the_error(self):
        s = make_session(rows=64)
        e0 = metrics.MEM_EVICTIONS.value
        s.execute("set tidb_mem_quota_session = 1")
        try:
            with pytest.raises(SQLError, match="memory quota exceeded"):
                s.execute("select v, count(*) from t group by v")
        finally:
            s.execute("set tidb_mem_quota_session = 0")
        # the breach ran the spill hook (host eviction) before cancelling
        assert metrics.MEM_EVICTIONS.value > e0
        # the session survives: quota released, statements run again
        assert s.execute("select count(*) from t").values() == [[64]]

    def test_generous_quota_unaffected(self):
        s = make_session(rows=32)
        s.execute("set tidb_mem_quota_session = 1073741824")
        try:
            r = s.execute("select v, count(*) from t group by v order by v")
            assert len(r.rows) == 32
        finally:
            s.execute("set tidb_mem_quota_session = 0")
