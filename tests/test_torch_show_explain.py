"""SHOW CREATE TABLE / COLUMNS / INDEX / STATUS and EXPLAIN ANALYZE
through both packages (the port's counterpart of
tests/test_show_explain.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. EXPLAIN ANALYZE and SHOW STATUS carry
times and process-wide counters, so their rows are compared without the
columns that are clocks or counts of earlier work.
"""

import pytest

from torch_sql_parity import JAX, PORT, Both


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT, s VARCHAR(8))")
    b.execute("INSERT INTO t VALUES " + ",".join(f"({i},{i % 7},'x{i % 3}')" for i in range(1, 101)))
    return b


def analyzed(sql: str):
    """fn(session, pkg): EXPLAIN ANALYZE's columns and each row as
    (executor, rows, tasks, cache, compile is in ms, bytes > 0)."""

    def run(s, _pkg):
        res = s.execute(sql)
        return res.columns, [(r[0], r[1], r[2], r[5], str(r[4]).endswith("ms"), (r[6] or 0) > 0)
                             for r in res.values()]

    return run


def test_show_create_table_reimports(sess):
    ddl = sess.execute("SHOW CREATE TABLE t").values()[0][1]
    s2 = Both()
    s2.execute(ddl.rstrip().rstrip(";"))
    assert s2.call(lambda s, _: [c.name for c in s.catalog.table("t").columns]) == ["id", "v", "s"]


def test_show_columns(sess):
    rows = sess.execute("SHOW COLUMNS FROM t").values()
    # the declared type's spelling is kept (TiDB prints int, not bigint)
    assert rows[0][:4] == ["id", "int", "NO", "PRI"]
    assert rows[2][0] == "s" and rows[2][1] == "varchar(8)"


def test_show_index(sess):
    sess.execute("CREATE UNIQUE INDEX uv ON t (id, v)")
    assert sess.execute("SHOW INDEX FROM t").values() == [["t", 0, "uv", 1, "id"], ["t", 0, "uv", 2, "v"]]


def test_show_status_metrics(sess):
    # the series listed depend on what the process ran before (a labelled
    # series appears once used), so each package is held to the claim alone
    for s in (sess.jax, sess.port):
        assert any("cop_requests" in r[0] for r in s.execute("SHOW STATUS").values())


def test_explain_analyze_row_counts(sess):
    _cols, rows = sess.call(analyzed("EXPLAIN ANALYZE SELECT count(*) FROM t WHERE v < 3"))
    by_exec = {r[0]: r for r in rows}
    assert by_exec["push[Selection]"][1] == 44  # rows that pass the filter
    assert by_exec["result"][1] == 1
    assert rows[0][0].startswith("push[") and rows[0][2] >= 1  # tasks


def test_explain_analyze_multi_region(sess):
    def split(s, pkg):
        tid = s.catalog.table("t").table_id
        for h in (30, 60):
            s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))

    sess.call(split)
    _cols, rows = sess.call(analyzed("EXPLAIN ANALYZE SELECT count(*) FROM t"))
    scan = {r[0]: r for r in rows}["push[TableScan]"]
    assert scan[1] == 100 and scan[2] == 3  # one summary a region task


def test_explain_analyze_attribution_columns(sess):
    """The compile, cache and bytes columns of the scan row."""
    sql = "EXPLAIN ANALYZE SELECT count(*) FROM t WHERE v < 3"
    cols, rows = sess.call(analyzed(sql))
    assert cols == ["executor", "rows", "tasks", "time", "compile", "cache", "bytes"]
    scan = {r[0]: r for r in rows}["push[TableScan]"]
    hits, total = scan[3].split("/")
    assert int(total) == scan[2] and 0 <= int(hits) <= scan[2]
    assert scan[4] and scan[5]  # a compile time in ms; decoded region bytes on the scan row
    # the same statement again: every task's program comes from the cache
    again = {pkg.name: {r[0]: r for r in s.execute(sql).values()}["push[TableScan]"]
             for pkg, s in ((JAX, sess.jax), (PORT, sess.port))}
    for scan2 in again.values():
        hits2, total2 = scan2[5].split("/")
        assert hits2 == total2 and scan2[4] == "0.00ms"
