"""The ranger, PK range pruning, covering index scans, index maintenance
and the index-lookup double read through both packages (the port's
counterpart of tests/test_index_ranger.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. The ranger's `intervals_for_column`
and each package's planner / `select` get the same inputs.
"""

import importlib

import pytest

from tidb_tpu_torch.sql import CatalogError, SQLError
from torch_sql_parity import JAX, Both, both_pkgs, session_pair

ROWS = "INSERT INTO t (id, g, v, s) VALUES " + ", ".join(f"({i}, {i % 7}, {i}.50, 'w{i % 5}')" for i in range(300))


def mod(pkg, name: str):
    return importlib.import_module(("tidb_tpu." if pkg is JAX else "tidb_tpu_torch.") + name)


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v DECIMAL(8,2), s VARCHAR(10))")
    b.execute(ROWS)
    return b


def _scanned_rows(b: Both, sql: str):
    """Rows the probe scan produced (the scan executor's summaries) and
    the plan's access path, equal in both packages."""

    def run(sess, pkg):
        d = mod(pkg, "distsql")
        plan = mod(pkg, "sql.planner").plan_select(pkg.parse_one(sql), sess.catalog)
        rp = d.split_dag(plan.dag)
        ranges = plan.ranges if plan.ranges is not None else d.full_table_ranges(plan.probe_table.table_id)
        res = d.select(sess.store, d.KVRequest(rp.push_dag, ranges, start_ts=10_000))
        return sum(sm[0].num_produced_rows for sm in res.exec_summaries), plan.access_path

    return b.call(run)


def _intervals(sqls, col: str):
    """intervals_for_column over the WHERE conjuncts of `sqls` in each
    package: None, or [(low, low_inc, high, high_inc)]."""

    def run(pkg):
        ranger = mod(pkg, "sql.ranger")
        ev = lambda lit: pkg.types.Datum.i64(int(lit.value))  # noqa: E731
        conj = []
        for sql in sqls:
            w = pkg.parse_one(sql).where
            conj += [w.left, w.right] if sql.endswith("a <= 20") else [w]
        ivs = ranger.intervals_for_column(conj, col, ev)
        return None if ivs is None else [(iv.low.val, iv.low_inc, iv.high.val, iv.high_inc) for iv in ivs]

    return both_pkgs(run)


class TestRanger:
    def test_intervals_basics(self):
        # the AND split by hand: the planner makes the conjunct list
        assert _intervals(["SELECT 1 FROM t WHERE a > 5 AND a <= 20"], "a") == [(5, False, 20, True)]

    def test_intervals_in_and_empty(self):
        ivs = _intervals(["SELECT 1 FROM t WHERE a IN (3, 7, 9)"], "a")
        assert [(lo, hi) for lo, _li, hi, _hi in ivs] == [(3, 3), (7, 7), (9, 9)]
        assert _intervals(["SELECT 1 FROM t WHERE a = 5", "SELECT 1 FROM t WHERE a = 6"], "a") == []

    def test_unrelated_conjuncts_ignored(self):
        assert _intervals(["SELECT 1 FROM t WHERE b < 9"], "a") is None


class TestPKPruning:
    def test_range_scan_reads_fewer_rows(self, sess):
        assert _scanned_rows(sess, "SELECT v FROM t WHERE id BETWEEN 10 AND 20") == (11, "table-range")

    def test_point_get(self, sess):
        assert _scanned_rows(sess, "SELECT v FROM t WHERE id = 42") == (1, "table-range")
        assert str(sess.execute("SELECT v FROM t WHERE id = 42").scalar()) == "42.50"

    def test_correct_results_with_pruning(self, sess):
        r = sess.execute("SELECT sum(v), count(*) FROM t WHERE id >= 290")
        assert r.rows[0][1].val == 10
        assert float(str(r.rows[0][0].val)) == sum(i + 0.5 for i in range(290, 300))

    def test_empty_range(self, sess):
        assert sess.execute("SELECT count(*) FROM t WHERE id = 5 AND id = 6").scalar() == 0
        assert sess.execute("SELECT v FROM t WHERE id = -1").rows == []


class TestCoveringIndex:
    @pytest.fixture()
    def isess(self, sess):
        sess.execute("CREATE INDEX ig ON t (g, id)")
        return sess

    def test_index_selected_and_fewer_rows(self, isess):
        assert _scanned_rows(isess, "SELECT count(*) FROM t WHERE g = 3") == (43, "index(ig)")

    def test_index_results_match_table_scan(self, isess):
        got = isess.execute("SELECT g, count(*), min(id), max(id) FROM t WHERE g IN (2, 5) GROUP BY g ORDER BY g")
        want = [[g, len(ids), min(ids), max(ids)] for g, ids in
                ((2, [i for i in range(300) if i % 7 == 2]), (5, [i for i in range(300) if i % 7 == 5]))]
        assert got.values() == want

    def test_non_covering_uses_index_lookup(self, isess):
        # v is not in the index: the selective point predicate on g takes
        # the double read
        assert _scanned_rows(isess, "SELECT v FROM t WHERE g = 3")[1] == "index_lookup(ig)"

    def test_index_range(self, isess):
        assert _scanned_rows(isess, "SELECT g FROM t WHERE g > 4") == (
            sum(1 for i in range(300) if i % 7 > 4), "index(ig)")

    def test_index_maintained_by_dml(self, isess):
        isess.execute("DELETE FROM t WHERE g = 3 AND id < 100")
        left = sum(1 for i in range(100, 300) if i % 7 == 3)
        assert isess.execute("SELECT count(*) FROM t WHERE g = 3").scalar() == left
        isess.execute("UPDATE t SET g = 3 WHERE id = 0")
        assert isess.execute("SELECT count(*) FROM t WHERE g = 3").scalar() == 1 + left
        isess.execute("INSERT INTO t (id, g, v, s) VALUES (1000, 3, 1.00, 'x')")
        assert isess.execute("SELECT max(id) FROM t WHERE g = 3").scalar() == 1000

    def test_create_index_backfills(self, sess):
        # an index created after the inserts sees the rows (backfill)
        sess.execute("CREATE INDEX iv ON t (g)")
        assert _scanned_rows(sess, "SELECT count(*) FROM t WHERE g = 0")[1] == "index(iv)"
        assert sess.execute("SELECT count(*) FROM t WHERE g = 0").scalar() == sum(1 for i in range(300) if i % 7 == 0)

    def test_drop_index(self, isess):
        isess.execute("DROP INDEX ig ON t")
        assert _scanned_rows(isess, "SELECT count(*) FROM t WHERE g = 3")[1] == "table"
        with pytest.raises(CatalogError, match="unknown index"):
            isess.execute("DROP INDEX nope ON t")


class TestReviewRegressions:
    def test_lossy_literal_does_not_prune(self, sess):
        # 1.5 rounds to 2 for a BIGINT column: the conjunct stays a filter
        r = sess.execute("SELECT id FROM t WHERE id > 1.5 AND id < 3.5 ORDER BY id")
        assert [x for x, in r.values()] == [2, 3]

    def test_unique_index_enforced(self, sess):
        sess.execute("CREATE TABLE u (id BIGINT PRIMARY KEY, a INT)")
        sess.execute("INSERT INTO u VALUES (1, 5), (2, 6)")
        sess.execute("CREATE UNIQUE INDEX ua ON u (a)")
        with pytest.raises(SQLError, match="duplicate entry"):
            sess.execute("INSERT INTO u VALUES (3, 5)")
        with pytest.raises(SQLError, match="duplicate entry"):
            sess.execute("UPDATE u SET a = 6 WHERE id = 1")
        sess.execute("INSERT INTO u VALUES (4, NULL), (5, NULL)")  # NULLs ok
        sess.execute("INSERT INTO u VALUES (6, 7)")

    def test_unique_backfill_detects_dup(self, sess):
        sess.execute("CREATE TABLE ub (id BIGINT PRIMARY KEY, a INT)")
        sess.execute("INSERT INTO ub VALUES (1, 5), (2, 5)")
        with pytest.raises(SQLError, match="backfill"):
            sess.execute("CREATE UNIQUE INDEX ua ON ub (a)")
        # rolled back: the index is gone
        assert not sess.call(lambda s, _: bool(s.catalog.table("ub").indices))


class TestIndexLookup:
    """Non-covering selective index predicates take the index-lookup
    double read instead of a full table scan."""

    @staticmethod
    def _mk():
        b = Both(session_pair())
        b.execute("create table lk (id bigint primary key, k bigint, payload varchar(20), key ik (k))")
        b.execute("insert into lk values " + ",".join(f"({i}, {i % 50}, 'p{i}')" for i in range(1000)))
        b.execute("analyze table lk")
        return b

    def test_plan_chooses_index_lookup(self):
        r = self._mk().execute("explain select payload from lk where k = 7")
        plan_text = "\n".join(str(x[0].val) for x in r.rows)
        assert "index_lookup(ik)" in plan_text, plan_text

    def test_results_match_full_scan(self):
        got = sorted(str(x[0].val) for x in self._mk().execute("select payload from lk where k = 7").rows)
        want = sorted(f"p{i}" for i in range(1000) if i % 50 == 7)
        assert got == want and len(got) == 20

    def test_reads_o_of_table_rows(self):
        """The second-phase scan touches only the looked-up handles (each
        package's EXPLAIN ANALYZE; its time columns differ run to run)."""
        s = self._mk()

        def scan_rows(sess, _pkg):
            r = sess.execute("explain analyze select payload from lk where k = 3")
            return [int(row[1].val) for row in r.rows if "TableScan" in str(row[0].val)]

        rows = s.call(scan_rows)
        assert rows and rows[-1] <= 20, rows

    def test_unselective_predicate_stays_full_scan(self):
        r = self._mk().execute("explain select payload from lk where k >= 0")
        plan_text = "\n".join(str(x[0].val) for x in r.rows)
        assert "index_lookup" not in plan_text, plan_text
