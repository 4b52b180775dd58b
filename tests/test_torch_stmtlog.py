"""The slow-query log, the statement summary and Top SQL through both
packages (the port's counterpart of tests/test_stmtlog.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. `normalize_sql` gets the same texts
in both packages. Top SQL's times differ between the packages, so its
case reads each package's own collector; it sums the digest over every
window the run sealed, so it does not depend on where a 1-s window
falls.
"""

import tidb_tpu.topsql as j_topsql
import tidb_tpu.util.stmtlog as j_stmtlog
import tidb_tpu_torch.topsql as p_topsql
import tidb_tpu_torch.util.stmtlog as p_stmtlog
from torch_sql_parity import Both, both_pkgs

STMTLOG = {"jax": j_stmtlog, "port": p_stmtlog}
TOPSQL = {"jax": j_topsql, "port": p_topsql}


def normalize_sql(text: str):
    return both_pkgs(lambda pkg: STMTLOG[pkg.name].normalize_sql(text))


def scalar(res) -> int:
    return int(res.rows[0][0].val)


class TestStmtSummary:
    def test_digest_groups_literal_variants(self):
        n1, d1 = normalize_sql("select * from t where a = 5")
        n2, d2 = normalize_sql("SELECT * FROM t WHERE a = 99")
        _n3, d3 = normalize_sql("select * from t where b = 5")
        assert d1 == d2 and n1 == n2 == "select * from t where a = ?"
        assert d3 != d1

    def test_summary_via_information_schema(self):
        s = Both()
        s.execute("create table t (a bigint primary key)")
        s.execute("insert into t values (1),(2),(3)")
        for v in (1, 2, 3):
            s.execute(f"select * from t where a = {v}")
        r = s.execute("select exec_count, sum_rows from information_schema.statements_summary "
                      "where digest_text = 'select * from t where a = ?'")
        assert len(r.rows) == 1
        assert int(r.rows[0][0].val) == 3 and int(r.rows[0][1].val) == 3

    def test_errors_counted(self):
        s = Both()
        try:
            s.execute("select * from missing_table")
        except Exception:  # noqa: BLE001 — the failure is the point; Both held it equal
            pass
        r = s.execute("select errors from information_schema.statements_summary "
                      "where digest_text = 'select * from missing_table'")
        assert scalar(r) == 1

    def test_summary_toggle(self):
        s = Both()
        s.execute("set tidb_enable_stmt_summary = OFF")
        s.execute("select 1")
        n_off = scalar(s.execute("select count(*) from information_schema.statements_summary"))
        s.execute("set tidb_enable_stmt_summary = ON")
        s.execute("select 1")
        assert scalar(s.execute("select count(*) from information_schema.statements_summary")) > n_off


class TestSlowLog:
    def test_slow_statement_lands_in_slow_query(self):
        s = Both()
        s.execute("create table t (a bigint primary key)")
        s.execute("set tidb_slow_log_threshold = 0")  # everything is slow now
        s.execute("insert into t values (42)")
        s.execute("set tidb_slow_log_threshold = 300")
        digest = normalize_sql("insert into t values (42)")[1]
        r = s.execute(f"select query, success from information_schema.slow_query where digest = {digest!r}")
        assert len(r.rows) >= 1
        assert "insert into t values (42)" in str(r.rows[0][0].val)
        assert int(r.rows[0][1].val) == 1

    def test_disabled_slow_log_records_nothing(self):
        s = Both()
        s.execute("set tidb_enable_slow_log = OFF")
        s.execute("set tidb_slow_log_threshold = 0")
        s.execute("select 1")
        s.execute("set tidb_slow_log_threshold = 300")
        s.execute("set tidb_enable_slow_log = ON")
        assert s.call(lambda sess, _: sess.catalog.stmtlog.slow_entries()) == []


def test_top_sql_cpu_attribution():
    """Per-digest CPU time lands in the windowed reporter, and
    information_schema.tidb_top_sql shows it ranked by cpu + device time.
    Every window the run sealed is summed, in each package."""
    for m in TOPSQL.values():
        m.COLLECTOR.reset()
    s = Both()
    s.execute("create table t (a bigint primary key, b bigint)")
    s.execute("insert into t values " + ",".join(f"({i},{i})" for i in range(300)))
    for i in range(5):
        s.execute(f"select sum(b) from t where a > {i}")
    s.execute("select 1")
    digest = normalize_sql("select sum(b) from t where a > 0")[1]

    def attributed(sess, pkg):
        rows = sess.execute("select exec_count, cpu_ns, cost_class from information_schema.tidb_top_sql "
                            f"where digest = '{digest}'").values()
        top = [r[0] for r in sess.execute("select digest from information_schema.tidb_top_sql").values()]
        col = TOPSQL[pkg.name].COLLECTOR
        col.rotate(force=True)
        windows = col.digest_view(digest)["windows"]
        cost = {d: sum(w["cpu_ns"] + w["device_ns"] for w in col.digest_view(d)["windows"])
                for d in (digest, one)}
        return (sum(r[0] for r in rows), all(r[1] > 0 for r in rows), {r[2] for r in rows} <= {
            "point", "small", "scan", "heavy"}, digest in top, sum(w["exec_count"] for w in windows),
            all(w["cpu_ns"] > 0 for w in windows), cost[digest] > cost[one])

    one = normalize_sql("select 1")[1]
    count, cpu, classes, listed, sealed, sealed_cpu, outranks = s.call(attributed)
    assert count == 5 and cpu and classes and listed
    assert sealed == 5 and sealed_cpu
    # the repeated aggregation outranks `select 1` over the sealed windows
    assert outranks
