"""Sysvars and the TPU feature gate, failpoints, metrics, memory tracking
and config through both packages (the port's counterpart of
tests/test_subsystems.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. Unit cases feed the same inputs to
both packages' functions. Failpoints are armed in each package's own
registry, and each package's counters are read.
"""

import contextlib

import pytest

import tidb_tpu.config as j_config
import tidb_tpu.sql.sysvar as j_sysvar
import tidb_tpu.util as j_util
import tidb_tpu_torch.config as p_config
import tidb_tpu_torch.sql.sysvar as p_sysvar
import tidb_tpu_torch.util as p_util
from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import JAX, PORT, Both, both_pkgs, session_pair

ROWS = "INSERT INTO t (id, g, v) VALUES " + ", ".join(f"({i}, {i % 5}, {i}.25)" for i in range(100))
SYSVAR = {"jax": j_sysvar, "port": p_sysvar}
CONFIG = {"jax": j_config, "port": p_config}
UTIL = {"jax": j_util, "port": p_util}


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v DECIMAL(8,2))")
    b.execute(ROWS)
    return b


@contextlib.contextmanager
def armed(name, value=True):
    """The failpoint armed in both packages' registries."""
    with JAX.fp.enabled(name, value), PORT.fp.enabled(name, value):
        yield


def deltas(family: str, fn):
    """fn() and how far each package's counter `family` moved."""
    before = {pkg.name: getattr(pkg.metrics, family).value for pkg in (JAX, PORT)}
    out = fn()
    return out, {pkg.name: getattr(pkg.metrics, family).value - before[pkg.name] for pkg in (JAX, PORT)}


class TestSysVars:
    def test_validation(self):
        def run(pkg):
            m = SYSVAR[pkg.name]
            sv = m.SysVarStore()
            sv.set("tidb_distsql_scan_concurrency", "8")
            out = [sv.get_int("tidb_distsql_scan_concurrency")]
            for name, val in (("tidb_distsql_scan_concurrency", "0"), ("tidb_enable_tpu_coprocessor", "maybe"),
                              ("no_such_variable", "1")):
                try:
                    sv.set(name, val)
                    out.append("accepted")
                except m.SysVarError as exc:
                    out.append(("SysVarError", str(exc)))
            return out

        got = both_pkgs(run)
        assert got[0] == 8 and all(o[0] == "SysVarError" for o in got[1:])

    def test_set_through_sql(self, sess):
        sess.execute("SET tidb_distsql_scan_concurrency = 2")
        assert sess.call(lambda s, _: s.sysvars.get_int("tidb_distsql_scan_concurrency")) == 2
        with pytest.raises(SQLError):
            sess.execute("SET tidb_distsql_scan_concurrency = 'lots'")
        r = sess.execute("SHOW VARIABLES")
        names = [row[0].val for row in r.rows]
        assert "tidb_enable_tpu_coprocessor" in names

    def test_tpu_gate_off_same_results(self, sess):
        want = sess.execute("SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g").values()
        sess.execute("SET tidb_enable_tpu_coprocessor = OFF")
        got = sess.execute("SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g").values()
        assert [[a, b, str(c)] for a, b, c in got] == [[a, b, str(c)] for a, b, c in want]
        sess.execute("SET tidb_enable_tpu_coprocessor = ON")

    def test_paging_sysvar(self, sess):
        sess.execute("SET tidb_enable_paging = ON")
        sess.execute("SET tidb_max_chunk_size = 32")
        r = sess.execute("SELECT id FROM t WHERE g = 1 ORDER BY id")
        assert [x for x, in r.values()] == [i for i in range(100) if i % 5 == 1]
        assert sess.execute("SELECT count(*) FROM t").scalar() == 100

    def test_mem_quota(self, sess):
        sess.execute("SET tidb_mem_quota_query = 1")
        with pytest.raises(SQLError, match="memory quota") as ei:
            sess.execute("SELECT * FROM t")
        assert ei.value.code == 1105
        sess.execute(f"SET tidb_mem_quota_query = {1 << 30}")
        assert sess.execute("SELECT count(*) FROM t").scalar() == 100


class TestFailpoints:
    def test_injected_region_error_retried(self, sess):
        with armed("cop-region-error", 1):  # fire once in each package
            got, moved = deltas("DISTSQL_RETRIES", lambda: sess.execute("SELECT count(*) FROM t").scalar())
        assert got == 100 and moved == {"jax": 1, "port": 1}

    def test_injected_other_error_surfaces(self, sess):
        with armed("cop-other-error"):
            with pytest.raises(SQLError, match="injected") as ei:
                sess.execute("SELECT count(*) FROM t")
        assert ei.value.code == 1105

    def test_counted_failpoint_expires(self):
        def run(pkg):
            fp = UTIL[pkg.name].failpoint
            fp.enable("fp-x", 2)
            return [fp.eval("fp-x"), fp.eval("fp-x"), fp.eval("fp-x")]

        got = both_pkgs(run)
        assert got[0] and got[1] and got[2] is None


class TestMetrics:
    def test_cop_counters_move(self, sess):
        before = {pkg.name: (pkg.metrics.COP_REQUESTS.value, pkg.metrics.COP_DURATION.count) for pkg in (JAX, PORT)}
        sess.execute("SELECT sum(v) FROM t")
        for pkg in (JAX, PORT):
            c0, d0 = before[pkg.name]
            assert pkg.metrics.COP_REQUESTS.value > c0
            assert pkg.metrics.COP_DURATION.count > d0
            dump = UTIL[pkg.name].REGISTRY.dump()
            assert "tidb_tpu_cop_requests_total" in dump
            assert "tidb_tpu_cop_duration_seconds_count" in dump


class TestMemTracker:
    def test_quota_and_action(self):
        def run(pkg):
            u = UTIL[pkg.name]
            freed = []

            def action(tr, n):
                freed.append(n)
                tr.consume(-tr.consumed)  # free everything (spill analog)

            parent = u.MemTracker("root", quota=None)
            t = u.MemTracker("q", quota=100, parent=parent, action=action)
            t.consume(80)
            t.consume(50)  # over quota -> action frees -> passes
            hard = u.MemTracker("hard", quota=10)
            try:
                hard.consume(11)
                raised = None
            except u.QuotaExceeded as exc:
                raised = str(exc)
            return freed, t.consumed, parent.consumed, raised

        freed, consumed, _parent, raised = both_pkgs(run)
        assert freed and consumed <= 100
        assert raised == "memory quota exceeded: tracker 'hard' at 11 + 11 > 10"

    def test_peak_and_release(self):
        def run(pkg):
            u = UTIL[pkg.name]
            p = u.MemTracker("p")
            c = u.MemTracker("c", parent=p)
            c.consume(40)
            c.consume(-10)
            out = [c.peak, p.consumed]
            c.release_all()
            return out + [c.consumed, p.consumed]

        assert both_pkgs(run) == [40, 30, 0, 0]


class TestConfig:
    def test_from_toml(self, tmp_path):
        f = tmp_path / "cfg.toml"
        f.write_text("group_capacity = 128\n[performance]\ndistsql_scan_concurrency = 9\n")

        def run(pkg):
            cfg = CONFIG[pkg.name].Config.from_toml(str(f))
            return cfg.group_capacity, cfg.distsql_scan_concurrency, cfg.mem_quota_query

        assert both_pkgs(run) == (128, 9, 1 << 30)  # the default quota survives


class TestVarsAndConfig2:
    def test_user_vars_readable(self, sess):
        sess.execute("SET @thresh = 50")
        r = sess.execute("SELECT count(*) FROM t WHERE id >= @thresh")
        assert r.scalar() == 50
        assert sess.execute("SELECT @thresh + 1").scalar() == 51
        assert sess.execute("SELECT @undefined").scalar() is None

    def test_sysvar_reference(self, sess):
        assert sess.execute("SELECT @@tidb_distsql_scan_concurrency").scalar() == 4

    def test_session_from_config(self):
        def run(pkg):
            cfg = CONFIG[pkg.name].Config(distsql_scan_concurrency=2, mem_quota_query=1 << 20, paging_size=64)
            kw = {"device": "cpu"} if pkg is PORT else {}
            s = pkg.sql.Session(config=cfg, **kw)
            return s.sysvars.get_int("tidb_distsql_scan_concurrency"), s.sysvars.get_bool("tidb_enable_paging")

        assert both_pkgs(run) == (2, True)

    def test_update_pk_same_unique_value_ok(self, sess):
        sess.execute("CREATE TABLE pu (id BIGINT PRIMARY KEY, u INT)")
        sess.execute("INSERT INTO pu VALUES (1, 5), (3, 7)")
        sess.execute("CREATE UNIQUE INDEX uu ON pu (u)")
        sess.execute("UPDATE pu SET id = 2 WHERE id = 1")  # u unchanged
        assert sorted(x for x, in sess.execute("SELECT id FROM pu").values()) == [2, 3]
        with pytest.raises(SQLError, match="duplicate"):
            sess.execute("UPDATE pu SET u = 7 WHERE id = 2")


class TestSpillDegrade:
    """A quota-bounded aggregation completes through the degraded
    low-memory fold instead of failing; the eviction runs first."""

    @staticmethod
    def _big_agg_session():
        b = Both(session_pair())
        b.execute("create table sp (id bigint primary key, g bigint, v bigint)")
        b.execute("insert into sp values " + ",".join(f"({i}, {i % 500}, {i})" for i in range(3000)))

        def split(s, pkg):
            tid = s.catalog.table("sp").table_id
            for h in range(500, 3000, 500):
                s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))

        b.call(split)
        return b

    def test_degraded_path_completes(self):
        s = self._big_agg_session()
        want = {}
        for i in range(3000):
            want[i % 500] = want.get(i % 500, 0) + i
        s.execute("set tidb_enable_tpu_mesh = OFF")
        s.execute("set tidb_mem_quota_query = 30000")
        r, moved = deltas("MEM_DEGRADED_QUERIES", lambda: s.execute("select g, sum(v) from sp group by g"))
        assert moved == {"jax": 1, "port": 1}, "did not degrade"
        got = {int(x[0].val): int(str(x[1].val).split(".")[0]) for x in r.rows}
        assert got == want

    def test_eviction_action_runs_first(self):
        s = self._big_agg_session()
        s.execute("select g, sum(v) from sp group by g")  # warm the caches
        s.execute("set tidb_enable_tpu_mesh = OFF")
        s.execute("set tidb_mem_quota_query = 30000")
        _r, moved = deltas("MEM_EVICTIONS", lambda: s.execute("select g, sum(v) from sp group by g"))
        assert moved == {"jax": 1, "port": 1}
