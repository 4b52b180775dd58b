"""Index merge through both packages (the port's counterpart of
tests/test_index_merge.py): an OR of range predicates on two indexed
columns unions the indexes' handle sets before one table read, gated by
tidb_enable_index_merge and the USE_INDEX_MERGE / NO_INDEX_MERGE hints.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values.
"""

from torch_sql_parity import Both

SQL = "select w from t where a = 5 or b = 11"


def _sess() -> Both:
    b = Both()
    b.execute("create table t (id bigint primary key, a bigint, b bigint, w bigint)")
    b.execute("create index ia on t (a)")
    b.execute("create index ib on t (b)")
    b.execute("insert into t values " + ",".join(f"({i}, {i % 97}, {(i * 7) % 89}, {i})" for i in range(500)))
    return b


def _access(s: Both, sql: str) -> str:
    return s.execute("explain " + sql).values()[0][0]


def test_sysvar_gates_index_merge():
    s = _sess()
    assert "index_merge(union:ia,ib)" in _access(s, SQL)  # ON by default
    s.execute("set tidb_enable_index_merge = OFF")
    assert "index_merge" not in _access(s, SQL)


def test_hint_forces_and_disables():
    s = _sess()
    assert "index_merge" in _access(s, "select /*+ USE_INDEX_MERGE(t) */ w from t where a = 5 or b = 11")
    s.execute("set tidb_enable_index_merge = ON")
    assert "index_merge" not in _access(s, "select /*+ NO_INDEX_MERGE() */ w from t where a = 5 or b = 11")


def test_results_match_full_scan():
    s = _sess()
    want = s.execute(SQL + " order by w").values()
    s.execute("set tidb_enable_index_merge = ON")
    assert "index_merge" in _access(s, SQL)
    got = s.execute(SQL + " order by w").values()
    assert got == want and len(got) > 5
    assert [w for w, in got] == [i for i in range(500) if i % 97 == 5 or (i * 7) % 89 == 11]


def test_non_or_predicates_unaffected():
    s = _sess()
    s.execute("set tidb_enable_index_merge = ON")
    # AND predicates keep the ordinary single-index paths
    assert "index_merge" not in _access(s, "select w from t where a = 5 and b = 11")
