"""Statistics (ANALYZE, histograms, TopN, NDV, the CM sketch), the
planner's estimates and the PointGet / BatchPointGet fast path through
both packages (the port's counterpart of tests/test_stats_pointget.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. `build_column_stats`,
`est_selectivity`, `est_interval_rows`, `CMSketch` and `plan_select` get
the same inputs in both packages.
"""

import importlib

import numpy as np
import pytest

from torch_sql_parity import JAX, Both, both_pkgs


def mod(pkg, name: str):
    return importlib.import_module(("tidb_tpu." if pkg is JAX else "tidb_tpu_torch.") + name)


def stats_of(pkg, cs) -> dict:
    """A ColumnStats as plain values."""
    return {"null_count": cs.null_count, "ndv": cs.ndv, "total": cs.total,
            "topn": [(d.val, c) for d, c in cs.topn], "buckets": [b.count for b in cs.buckets]}


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT, s VARCHAR(10))")
    b.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i % 10},'{chr(97 + i % 3)}')" for i in range(1, 101)))
    return b


def test_build_column_stats_basic():
    def run(pkg):
        D = pkg.types.Datum
        return stats_of(pkg, mod(pkg, "sql.stats").build_column_stats([D.i64(i % 5) for i in range(100)] + [D.NULL] * 10))

    cs = both_pkgs(run)
    assert (cs["null_count"], cs["ndv"], cs["total"]) == (10, 5, 100)
    # every value repeats 20x: all in TopN
    assert sum(c for _, c in cs["topn"]) == 100


def test_histogram_buckets_uniform():
    def run(pkg):
        st, D = mod(pkg, "sql.stats"), pkg.types.Datum
        cs = st.build_column_stats([D.i64(i) for i in range(1000)], n_buckets=16)
        iv = mod(pkg, "sql.ranger").Interval(None, D.i64(500), True, False)
        return stats_of(pkg, cs), st.est_selectivity(cs, [iv])

    cs, sel = both_pkgs(run)
    assert cs["ndv"] == 1000 and not cs["topn"]
    assert sum(cs["buckets"]) == 1000
    assert 0.4 < sel < 0.6  # the lower half


def test_point_selectivity_via_topn():
    def run(pkg):
        st, D = mod(pkg, "sql.stats"), pkg.types.Datum
        cs = st.build_column_stats([D.i64(1)] * 90 + [D.i64(i + 10) for i in range(10)])
        return st.est_selectivity(cs, [mod(pkg, "sql.ranger").Interval(D.i64(1), D.i64(1), True, True)])

    assert 0.85 < both_pkgs(run) <= 0.95


def _table_stats(sess, table):
    def run(s, _pkg):
        st = s.catalog.stats[s.catalog.table(table).table_id]
        return st.row_count, {name: c.ndv for name, c in st.columns.items()}

    return sess.call(run)


def test_analyze_registers_stats(sess):
    sess.execute("ANALYZE TABLE t")
    rows, ndv = _table_stats(sess, "t")
    assert rows == 100 and ndv["v"] == 10 and ndv["id"] == 100


def test_analyze_specific_columns(sess):
    sess.execute("ANALYZE TABLE t COLUMNS v")
    _rows, ndv = _table_stats(sess, "t")
    assert "v" in ndv and "id" not in ndv


# ---------------------------------------------------------------- pointget


@pytest.mark.parametrize("sql, want", [
    ("SELECT id, v FROM t WHERE id = 42", [[42, 2]]),
    ("SELECT id FROM t WHERE id = 4242", []),
    ("SELECT id FROM t WHERE id IN (5, 3, 999) ORDER BY id", [[3], [5]]),
], ids=["point_get_eq", "point_get_missing", "batch_point_get_in"])
def test_point_get(sess, sql, want):
    assert sess.execute(sql).values() == want


def test_point_get_extra_filter(sess):
    assert sess.execute("SELECT id FROM t WHERE id = 42 AND v > 5").values() == []
    assert sess.execute("SELECT id FROM t WHERE id = 47 AND v > 5").values() == [[47]]


def test_point_get_projection_alias(sess):
    got = sess.execute("SELECT v * 10 AS x FROM t WHERE id = 7")
    assert got.columns == ["x"] and got.values() == [[70]]


def test_point_get_star(sess):
    assert sess.execute("SELECT * FROM t WHERE id = 7").values() == [[7, 7, "b"]]


def test_point_get_in_txn_sees_buffer(sess):
    sess.execute("BEGIN")
    sess.execute("UPDATE t SET v = 777 WHERE id = 7")
    assert sess.execute("SELECT v FROM t WHERE id = 7").values() == [[777]]
    sess.execute("DELETE FROM t WHERE id = 8")
    assert sess.execute("SELECT v FROM t WHERE id = 8").values() == []
    sess.execute("ROLLBACK")
    assert sess.execute("SELECT v FROM t WHERE id = 7").values() == [[7]]


def test_point_get_not_used_for_aggregates(sess):
    # an aggregate takes the full path and still answers
    assert sess.execute("SELECT count(*) FROM t WHERE id = 7").values() == [[1]]


def test_estimate_drives_probe_choice():
    s = Both()
    s.execute("CREATE TABLE big (id INT PRIMARY KEY, k INT)")
    s.execute("CREATE TABLE small (id INT PRIMARY KEY, k INT)")
    s.execute("INSERT INTO big VALUES " + ",".join(f"({i},{i % 7})" for i in range(1, 201)))
    s.execute("INSERT INTO small VALUES (1,1),(2,2),(3,3)")
    s.execute("ANALYZE TABLE big")
    s.execute("ANALYZE TABLE small")
    # ids 1..7, k in {1..6, 0}: k = 1, 2, 3 match
    assert s.execute("SELECT count(*) FROM big JOIN small ON big.k = small.k WHERE big.id < 8").values() == [[3]]


class TestStatsDepth:
    """The CM sketch and the NDV's consumers."""

    def test_cmsketch_point_frequency(self):
        def run(pkg):
            D = pkg.types.Datum
            cm = mod(pkg, "sql.stats").CMSketch()
            for v, c in ((5, 40), (9, 7), (123456, 1)):
                cm.insert(D.i64(v), c)
            return [cm.query(D.i64(v)) for v in (5, 9, 123456)]

        f5, f9, f_single = both_pkgs(run)
        # count-min never underestimates; a non-TopN point reads far below
        # a uniform guess
        assert f5 >= 40 and f9 >= 7 and f_single < 40

    def test_analyze_builds_sketch_and_est_uses_it(self):
        s = Both()
        s.execute("create table cs (v bigint)")
        vals = np.random.default_rng(1).permutation(5000)[:200]  # 200 singletons: all sketch-backed
        s.execute("insert into cs values " + ",".join(f"({int(v)})" for v in vals))
        s.execute("analyze table cs")

        def run(sess, pkg):
            cst = sess.catalog.stats[sess.catalog.table("cs").table_id].columns["v"]
            d = pkg.types.Datum.i64(int(vals[0]))
            est = mod(pkg, "sql.stats").est_interval_rows(cst, mod(pkg, "sql.ranger").Interval(low=d, high=d))
            return cst.cmsketch is not None, cst.ndv, est

        has_sketch, ndv, est = s.call(run)
        assert has_sketch and ndv == 200
        assert 1 <= est <= 4  # near exact, not smeared over a bucket

    def test_ndv_hint_reaches_plan_and_wrong_hint_stays_correct(self):
        """The ANALYZE NDV makes the few-groups hint; stale stats (the NDV
        grew after ANALYZE) still give exact rows through the overflow
        fallback."""
        s = Both()
        s.execute("create table g (k bigint, v bigint)")
        s.execute("insert into g values " + ",".join(f"({i % 4}, {i})" for i in range(64)))
        s.execute("analyze table g")

        def hints(sess, pkg):
            plan_select = mod(pkg, "sql.planner").plan_select
            return [plan_select(pkg.parse_one(q), sess.catalog).small_groups
                    for q in ("select k, count(*) from g group by k", "select k + 1, count(*) from g group by k + 1")]

        assert s.call(hints) == [16, None]  # NDV 4 (pow2 floor 16); no stats on an expression key
        s.execute("insert into g values " + ",".join(f"({i}, {i})" for i in range(100, 3100)))
        r = s.execute("select count(*) from (select k, count(*) as c from g group by k) d")
        assert int(r.rows[0][0].val) == 3004
        r = s.execute("select k, count(*) from g where k < 4 group by k order by k")
        assert [(int(x[0].val), int(x[1].val)) for x in r.rows] == [(0, 16), (1, 16), (2, 16), (3, 16)]
