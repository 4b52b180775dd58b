"""Percolator transactions of the port against the JAX package's, on the
CPU: every case of tests/test_txn.py.

The engine cases drive `TxnEngine` over a `MemKV` of each package through
the same operations and compare what each returns or raises (class and
message) and the locks left behind. The session cases run the same
statements through two sessions sharing one store and one catalog in each
package (tests/torch_sql_parity.py compares every outcome). Beside them:
the port store's write-side hooks (snapshot registry, GC safe point,
`advance_tso`, `ping_store`) against the JAX store's.
"""

import pytest

from torch_sql_parity import JAX, PORT, Call, Sql, norm, outcome, run_case, same, session_pair

# ---------------------------------------------------------------- engine

ENGINE_CASES = {
    "engine_prewrite_commit": [
        ("commit_txn", {b"a": b"1", b"b": b"2"}, 10, 11),
        ("get", b"a", 11), ("get", b"b", 11), ("get", b"a", 10),
    ],
    "engine_write_conflict": [
        ("commit_txn", {b"a": b"1"}, 10, 15),
        ("commit_txn", {b"a": b"2"}, 12, 16),
        ("get", b"a", 100), ("locks",),
    ],
    "engine_key_is_locked": [
        ("prewrite", {b"a": b"1"}, b"a", 10),
        ("prewrite", {b"a": b"2"}, b"a", 12),
        ("rollback", [b"a"], 10),
        ("commit_txn", {b"a": b"2"}, 12, 13),
        ("get", b"a", 13), ("locks",),
    ],
    "engine_pessimistic_converts": [
        ("acquire_pessimistic", [b"a"], b"a", 10, 10),
        ("acquire_pessimistic", [b"a"], b"a", 20, 20),
        ("commit_txn", {b"a": b"x"}, 10, 12),
        ("get", b"a", 12), ("locks",),
    ],
}


def _engine_trace(pkg, ops):
    kv = pkg.kv.MemKV()
    eng = pkg.txn.TxnEngine(kv)
    out = []
    for op, *args in ops:
        if op == "get":
            out.append(outcome(lambda: kv.get(*args)))
        elif op == "locks":
            out.append(sorted((k, norm(l)) for k, l in eng.locks.items()))
        else:
            out.append(outcome(lambda: getattr(eng, op)(*args)))
    return out


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_case(name):
    j, p = _engine_trace(JAX, ENGINE_CASES[name]), _engine_trace(PORT, ENGINE_CASES[name])
    assert same(norm(j), norm(p)), f"jax {j}\nport {p}"
    errors = [o for o in j if isinstance(o, tuple) and o[0] == "err"]
    want = {"engine_prewrite_commit": 0, "engine_write_conflict": 1, "engine_key_is_locked": 1,
            "engine_pessimistic_converts": 1}[name]
    assert len(errors) == want  # the case's conflict did fire


# ---------------------------------------------------------------- session

PAIR = [
    Sql("CREATE TABLE t (id INT PRIMARY KEY, v INT)", on="s1"),
    Sql("INSERT INTO t VALUES (1,10),(2,20)", on="s1"),
]


def s1(text, err=False):
    return Sql(text, on="s1", err=err)


def s2(text, err=False):
    return Sql(text, on="s2", err=err)


def _txn_is_none(pkg, sessions):
    return sessions["s1"].txn is None


def _no_locks(pkg, sessions):
    return len(sessions["s1"].store.txn.locks)


SESSION_CASES = {
    "read_your_writes_and_isolation": [
        s1("BEGIN"), s1("UPDATE t SET v = 99 WHERE id = 1"), s1("INSERT INTO t VALUES (3,30)"),
        s1("DELETE FROM t WHERE id = 2"), s1("SELECT * FROM t ORDER BY id"), s2("SELECT * FROM t ORDER BY id"),
        s1("COMMIT"), s2("SELECT * FROM t ORDER BY id"),
    ],
    "rollback_discards": [
        s1("BEGIN"), s1("UPDATE t SET v = 0"), s1("ROLLBACK"), s1("SELECT * FROM t ORDER BY id"),
    ],
    "repeatable_read_snapshot": [
        s1("BEGIN"), s1("SELECT v FROM t WHERE id = 1"), s2("UPDATE t SET v = 77 WHERE id = 1"),
        s1("SELECT v FROM t WHERE id = 1"), s1("COMMIT"), s1("SELECT v FROM t WHERE id = 1"),
    ],
    "pessimistic_lock_conflict": [
        s1("BEGIN"), s1("UPDATE t SET v = 1 WHERE id = 2"), s2("UPDATE t SET v = 2 WHERE id = 2", err=True),
        s1("COMMIT"), s2("UPDATE t SET v = 2 WHERE id = 2"), s2("SELECT v FROM t WHERE id = 2"),
    ],
    "optimistic_write_conflict": [
        s1("SET tidb_txn_mode = 'optimistic'"), s1("BEGIN"), s1("UPDATE t SET v = 5 WHERE id = 1"),
        s2("UPDATE t SET v = 7 WHERE id = 1"), s1("COMMIT", err=True), s2("SELECT v FROM t WHERE id = 1"),
    ],
    "select_for_update_locks": [
        s1("BEGIN"), s1("SELECT * FROM t WHERE id = 2 FOR UPDATE"), s2("DELETE FROM t WHERE id = 2", err=True),
        s1("ROLLBACK"), s2("DELETE FROM t WHERE id = 2"), s2("SELECT count(*) FROM t"),
    ],
    "txn_aggregate_sees_own_writes": [
        s1("BEGIN"), s1("INSERT INTO t VALUES (10, 100), (11, 200)"), s1("SELECT count(*), sum(v) FROM t"),
        s1("COMMIT"), s1("SELECT count(*) FROM t"),
    ],
    "txn_join_with_dirty_table": [
        s1("CREATE TABLE u (id INT PRIMARY KEY, tv INT)"), s1("INSERT INTO u VALUES (1, 10)"), s1("BEGIN"),
        s1("INSERT INTO u VALUES (2, 20)"), s1("SELECT t.id, u.id FROM t JOIN u ON t.v = u.tv ORDER BY t.id"),
        s1("ROLLBACK"), s1("SELECT t.id, u.id FROM t JOIN u ON t.v = u.tv ORDER BY t.id"),
    ],
    "ddl_implicitly_commits": [
        s1("BEGIN"), s1("UPDATE t SET v = 1 WHERE id = 1"), s1("CREATE TABLE z (a INT PRIMARY KEY)"),
        s2("SELECT v FROM t WHERE id = 1"), Call(_txn_is_none),
    ],
    "begin_commits_previous": [
        s1("BEGIN"), s1("UPDATE t SET v = 42 WHERE id = 1"), s1("BEGIN"), s2("SELECT v FROM t WHERE id = 1"),
        s1("ROLLBACK"),
    ],
    "unique_check_sees_buffer": [
        s1("CREATE UNIQUE INDEX uv ON t (v)"), s1("BEGIN"), s1("INSERT INTO t VALUES (5, 50)"),
        s1("INSERT INTO t VALUES (6, 50)", err=True), s1("ROLLBACK"),
    ],
    "failed_statement_in_autocommit_leaves_no_trace": [
        s1("INSERT INTO t VALUES (1, 999)", err=True), s1("SELECT count(*) FROM t"), Call(_no_locks),
    ],
}

UNIQUE = [
    "create table t (id bigint primary key, u bigint, v varchar(10), unique key uk (u))",
    "insert into t values (1, 10, 'a'), (2, 20, 'b')",
]
SINGLE_CASES = {
    # TestReplaceIgnoreUnique
    "replace_deletes_conflicting_row": UNIQUE + ["replace into t values (3, 10, 'c')", "select * from t order by id"],
    "replace_conflicting_pk_and_unique": UNIQUE + ["replace into t values (2, 10, 'z')", "select * from t order by id"],
    "insert_ignore_skips_unique_conflict": UNIQUE + [
        "insert ignore into t values (3, 10, 'c'), (4, 40, 'd')", "select * from t order by id"],
    # TestNamedSavepoints
    "rollback_to_savepoint": [
        "create table sv (a bigint primary key)", "begin", "insert into sv values (1)", "savepoint sp1",
        "insert into sv values (2)", "rollback to savepoint sp1", "commit", "select * from sv order by a",
    ],
    "rollback_to_missing_savepoint_errors": [
        "create table sv2 (a bigint)", "begin", Sql("rollback to savepoint nope", err=True), "rollback",
    ],
}


@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_session_case(name):
    sessions = session_pair(shared=True, names=("s1", "s2"))
    run_case(PAIR + SESSION_CASES[name], sessions)


@pytest.mark.parametrize("name", list(SINGLE_CASES))
def test_single_session_case(name):
    run_case(SINGLE_CASES[name])


def test_case_counts():
    assert len(ENGINE_CASES) + len(SESSION_CASES) + len(SINGLE_CASES) == 21


# ---------------------------------------------------------------- store hooks


def _hooks(pkg):
    """The snapshot registry bounds GC; advance_tso moves the clock;
    ping_store follows set_down / set_up."""
    st = pkg.new_store()
    key = pkg.tablecodec.encode_row_key(7, 1)
    out = []
    for v in (b"1", b"2", b"3"):
        st.txn.commit_txn({key: v}, st.next_ts(), st.next_ts())
    snap = st.next_ts()
    st.txn.commit_txn({key: b"4"}, st.next_ts(), st.next_ts())
    st.register_snapshot(snap)
    out.append(st.run_gc())
    out.append(st.gc_safepoint == snap - 1)
    out.append(st.kv.get(key, snap))
    st.unregister_snapshot(snap)
    out.append(st.run_gc())
    out.append(st.kv.get(key, st.next_ts()))
    st.advance_tso(10_000)
    out.append(st.next_ts())
    st.advance_tso(5)
    out.append(st.next_ts())
    out.append(st.ping_store(0))
    st.set_down(0)
    out.append(st.ping_store(0))
    st.set_up(0)
    out.append(st.ping_store(0))
    return out


def test_store_hooks_match_the_jax_store():
    j, p = _hooks(JAX), _hooks(PORT)
    assert j == p, (j, p)
    assert p[1] is True and p[2] == b"3" and p[4] == b"4" and p[5] == 10_001 and p[-3:] == [True, False, True]


def test_a_commit_drops_the_result_cache():
    """The trap a commit must not fall into: a warm region's cached
    response served after the write. Every commit bumps the write version."""
    sessions = session_pair()
    steps = [
        "CREATE TABLE w (id BIGINT PRIMARY KEY, v BIGINT)",
        "INSERT INTO w VALUES (1, 1), (2, 2), (3, 3)",
        "SELECT sum(v), count(*) FROM w",
        "SELECT sum(v), count(*) FROM w",
        "BEGIN", "UPDATE w SET v = 100 WHERE id = 2", "COMMIT",
        "SELECT sum(v), count(*) FROM w",
    ]
    run_case(steps, sessions)
    s = sessions["port"]["s"]
    assert s.store.stats()["result_cache_hits"] >= 1
    assert s.execute("SELECT sum(v), count(*) FROM w").values()[0][1] == 3
    assert int(str(s.execute("SELECT sum(v) FROM w").scalar())) == 104
