"""Subqueries, derived tables, CTEs, UNION and the row evaluator's
extension ops, through both packages (the port's counterpart of
tests/test_subquery.py and of the extension cases of
tests/test_priv_prepared_ext.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` over the same rows
(tests/torch_sql_parity.py); the two outcomes must agree exactly, and the
hand-computed MySQL answers of the reference's tests hold for the port's
rows too. Correlated subqueries run as `__apply_*` extension ops in the
row evaluator, as do the host builtins (`sql/builtins_host.py`) and user
functions registered with `EXTENSIONS.register_function`.
"""

import hashlib

import pytest

from torch_sql_parity import Sql, _result, run_case, same, session_pair

T_ROWS = "INSERT INTO t VALUES (1,1,10),(2,1,20),(3,2,30),(4,3,40),(5,NULL,50)"
U_ROWS = "INSERT INTO u VALUES (1,1,100),(2,2,200),(3,2,250),(4,9,300)"


@pytest.fixture()
def pair():
    sessions = session_pair()
    run_case(["CREATE TABLE t (id INT PRIMARY KEY, k INT, v INT)",
              "CREATE TABLE u (id INT PRIMARY KEY, tk INT, w INT)", T_ROWS, U_ROWS], sessions)
    return sessions


def q(pair, sql):
    """The statement's rows, equal in both packages; the port's values."""
    got = {name: pair[name]["s"].execute(sql) for name in ("jax", "port")}
    j, p = _result(got["jax"]), _result(got["port"])
    assert same(j, p), f"{sql}:\n  jax  {j}\n  port {p}"
    return got["port"].values()


def fails(pair, sql, match):
    """The statement fails alike in both packages (class, code, message)."""
    run_case([Sql(sql, err=True)], pair)
    with pytest.raises(Exception, match=match):
        pair["port"]["s"].execute(sql)


# ---------------------------------------------------------------- scalar


def test_scalar_uncorrelated(pair):
    assert q(pair, "SELECT max(v) FROM t WHERE v < (SELECT avg(w) FROM u)") == [[50]]


def test_scalar_empty_is_null(pair):
    assert q(pair, "SELECT (SELECT w FROM u WHERE tk = 777)") == [[None]]


def test_scalar_multirow_errors(pair):
    fails(pair, "SELECT (SELECT w FROM u)", "more than 1 row")


def test_scalar_no_from(pair):
    assert q(pair, "SELECT 1 + (SELECT count(*) FROM u)") == [[5]]


def test_scalar_correlated_count_empty_group_is_zero(pair):
    got = q(pair, "SELECT id, (SELECT count(*) FROM u WHERE u.tk = t.k) FROM t ORDER BY id")
    assert got == [[1, 1], [2, 1], [3, 2], [4, 0], [5, 0]]


def test_scalar_correlated_sum_empty_group_is_null(pair):
    got = q(pair, "SELECT id, (SELECT sum(w) FROM u WHERE u.tk = t.k) FROM t ORDER BY id")
    assert [[r[0], None if r[1] is None else int(str(r[1]))] for r in got] == [
        [1, 100], [2, 100], [3, 450], [4, None], [5, None]]


def test_scalar_correlated_nonagg_dup_errors(pair):
    # tk=2 has two rows — a non-aggregated correlated scalar must error
    fails(pair, "SELECT id, (SELECT w FROM u WHERE u.tk = t.k) FROM t", "more than 1 row")


# ---------------------------------------------------------------- IN / EXISTS


def test_in_uncorrelated(pair):
    assert q(pair, "SELECT id FROM t WHERE k IN (SELECT tk FROM u) ORDER BY id") == [[1], [2], [3]]


def test_not_in_uncorrelated(pair):
    # k=NULL row never passes NOT IN; k=3 not in {1,2,9}
    assert q(pair, "SELECT id FROM t WHERE k NOT IN (SELECT tk FROM u) ORDER BY id") == [[4]]


def test_not_in_with_null_in_set_is_empty(pair):
    run_case(["INSERT INTO u VALUES (5, NULL, 0)"], pair)
    assert q(pair, "SELECT id FROM t WHERE k NOT IN (SELECT tk FROM u)") == []


def test_exists_correlated(pair):
    assert q(pair, "SELECT id FROM t WHERE EXISTS (SELECT 1 FROM u WHERE u.tk = t.k) ORDER BY id") == [[1], [2], [3]]


def test_not_exists_correlated(pair):
    assert q(pair, "SELECT id FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE u.tk = t.k) ORDER BY id") == [[4], [5]]


def test_exists_uncorrelated(pair):
    assert q(pair, "SELECT count(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE w > 250)") == [[5]]
    assert q(pair, "SELECT count(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE w > 999)") == [[0]]


def test_in_correlated(pair):
    assert q(pair, "SELECT id FROM t WHERE v IN (SELECT w/10 FROM u WHERE u.tk = t.k) ORDER BY id") == [[1]]


def test_in_large_set_semi_join():
    s = session_pair()
    vals = ",".join(f"({i},{i * 3})" for i in range(1, 201))
    run_case(["CREATE TABLE big (id INT PRIMARY KEY, x INT)", "CREATE TABLE probe (id INT PRIMARY KEY, x INT)",
              f"INSERT INTO big VALUES {vals}", "INSERT INTO probe VALUES (1,3),(2,4),(3,300),(4,601),(5,NULL)"], s)
    assert q(s, "SELECT id FROM probe WHERE x IN (SELECT x FROM big) ORDER BY id") == [[1], [3]]
    assert q(s, "SELECT id FROM probe WHERE x NOT IN (SELECT x FROM big) ORDER BY id") == [[2], [4]]


def test_any_all(pair):
    assert q(pair, "SELECT id FROM t WHERE v >= ALL (SELECT w/10 FROM u) ORDER BY id") == [[3], [4], [5]]
    assert q(pair, "SELECT id FROM t WHERE v < ANY (SELECT w/10 FROM u) ORDER BY id") == [[1], [2]]
    # empty set: ALL true, ANY false
    assert q(pair, "SELECT count(*) FROM t WHERE v > ALL (SELECT w FROM u WHERE tk = 777)") == [[5]]
    assert q(pair, "SELECT count(*) FROM t WHERE v > ANY (SELECT w FROM u WHERE tk = 777)") == [[0]]


# ---------------------------------------------------------------- derived / CTE


def test_derived_table(pair):
    got = q(pair, "SELECT a.k, a.s FROM (SELECT k, sum(v) AS s FROM t GROUP BY k) a ORDER BY a.k")
    assert [[r[0], int(str(r[1]))] for r in got] == [[None, 50], [1, 30], [2, 30], [3, 40]]


def test_derived_join_real_table(pair):
    got = q(pair, """
        SELECT t.id, a.cnt FROM t
        JOIN (SELECT tk, count(*) AS cnt FROM u GROUP BY tk) a ON a.tk = t.k
        ORDER BY t.id""")
    assert got == [[1, 1], [2, 1], [3, 2]]


def test_cte_basic(pair):
    assert q(pair, "WITH big AS (SELECT * FROM t WHERE v >= 30) SELECT count(*) FROM big") == [[3]]


def test_cte_chained(pair):
    got = q(pair, """
        WITH a AS (SELECT k, v FROM t WHERE v > 10),
             b AS (SELECT k, sum(v) AS s FROM a GROUP BY k)
        SELECT count(*), max(s) FROM b""")
    assert [[got[0][0], int(str(got[0][1]))]] == [[4, 50]]


def test_cte_column_aliases(pair):
    assert q(pair, "WITH c (x) AS (SELECT v FROM t) SELECT max(x) FROM c") == [[50]]


def test_recursive_cte(pair):
    got = q(pair, """
        WITH RECURSIVE seq AS (SELECT 1 AS n UNION ALL SELECT n+1 FROM seq WHERE n < 10)
        SELECT count(*), sum(n) FROM seq""")
    assert got[0][0] == 10 and int(str(got[0][1])) == 55


def test_recursive_cte_distinct_terminates(pair):
    # UNION (distinct) recursion reaches a fixpoint instead of the cap
    got = q(pair, """
        WITH RECURSIVE r AS (SELECT 1 AS n UNION SELECT 3 - n FROM r)
        SELECT count(*) FROM r""")
    assert got == [[2]]  # {1, 2}


def test_recursive_cte_depth_cap(pair):
    run_case(["SET cte_max_recursion_depth = 10"], pair)
    fails(pair, "WITH RECURSIVE s AS (SELECT 1 AS n UNION ALL SELECT n+1 FROM s) SELECT count(*) FROM s",
          "recursion")


# ---------------------------------------------------------------- UNION


def test_union_distinct(pair):
    assert q(pair, "SELECT k FROM t UNION SELECT tk FROM u ORDER BY k") == [[None], [1], [2], [3], [9]]


def test_union_all(pair):
    assert len(q(pair, "SELECT k FROM t UNION ALL SELECT tk FROM u")) == 9


def test_union_order_limit(pair):
    assert q(pair, "SELECT v FROM t UNION SELECT w FROM u ORDER BY v DESC LIMIT 3") == [[300], [250], [200]]


def test_union_column_count_mismatch(pair):
    fails(pair, "SELECT id, k FROM t UNION SELECT id FROM u", "different number")


def test_union_in_subquery(pair):
    assert q(pair, "SELECT count(*) FROM t WHERE k IN (SELECT tk FROM u WHERE w < 150 UNION SELECT 3)") == [[3]]


# ------------------------------------------------- the row evaluator's extension ops


@pytest.fixture()
def strs():
    sessions = session_pair()
    run_case(["CREATE TABLE p (id INT PRIMARY KEY, v INT, s VARCHAR(20))",
              "INSERT INTO p VALUES (1,10,'abc'),(2,20,'xbz'),(3,5,'cc'),(4,NULL,NULL)"], sessions)
    return sessions


HOST_SELECT = [
    ("SELECT id, instr(s, 'b') FROM p ORDER BY id", [[1, 2], [2, 2], [3, 0], [4, None]]),
    ("SELECT id, lpad(s, 5, '*') FROM p ORDER BY id", [[1, "**abc"], [2, "**xbz"], [3, "***cc"], [4, None]]),
    ("SELECT id, concat_ws('-', s, s) FROM p ORDER BY id", [[1, "abc-abc"], [2, "xbz-xbz"], [3, "cc-cc"], [4, ""]]),
    ("SELECT id, md5(s) FROM p ORDER BY id", None),
    ("SELECT id, sha1(s) FROM p ORDER BY id", None),
    ("SELECT id, truncate(v / 3, 2) FROM p ORDER BY id", None),
]

HOST_WHERE = [
    ("SELECT id FROM p WHERE instr(s, 'b') = 2 ORDER BY id", [[1], [2]]),
    ("SELECT id FROM p WHERE lpad(s, 5, '*') = '**abc' ORDER BY id", [[1]]),
    ("SELECT id FROM p WHERE concat_ws('-', s, 'z') = 'cc-z' ORDER BY id", [[3]]),
    ("SELECT id FROM p WHERE md5(s) = '900150983cd24fb0d6963f7d28e17f72' ORDER BY id", [[1]]),
    ("SELECT id FROM p WHERE sha1(s) = 'a9993e364706816aba3e25717850c26c9cd0d89d' ORDER BY id", [[1]]),
    ("SELECT id FROM p WHERE truncate(v / 3, 1) > 4 ORDER BY id", [[2]]),
]


@pytest.mark.parametrize("sql,want", HOST_SELECT, ids=[f"select-{i}" for i in range(len(HOST_SELECT))])
def test_host_builtin_in_select_list(strs, sql, want):
    got = q(strs, sql)
    if want is not None:
        assert got == want
    if "md5" in sql or "sha1" in sql:
        h = hashlib.md5 if "md5" in sql else hashlib.sha1
        words = {1: "abc", 2: "xbz", 3: "cc"}
        assert got == [[i, h(words[i].encode()).hexdigest() if i in words else None] for i in (1, 2, 3, 4)]
    if "truncate" in sql:
        assert [r[0] for r in got] == [1, 2, 3, 4] and got[3][1] is None
        assert [float(str(r[1])) for r in got[:3]] == [3.33, 6.66, 1.66]


@pytest.mark.parametrize("sql,want", HOST_WHERE, ids=[f"where-{i}" for i in range(len(HOST_WHERE))])
def test_host_builtin_in_where(strs, sql, want):
    assert q(strs, sql) == want


def test_scalar_subquery_in_select_list(strs):
    got = q(strs, "SELECT id, (SELECT max(v) FROM p p2 WHERE p2.id < p.id) FROM p ORDER BY id")
    assert got == [[1, None], [2, 10], [3, 20], [4, 20]]


def test_exists_and_not_exists_over_an_outer_column(strs):
    assert q(strs, "SELECT id FROM p WHERE EXISTS (SELECT 1 FROM p p2 WHERE p2.v > p.v) ORDER BY id") == [[1], [3]]
    assert q(strs, "SELECT id FROM p WHERE NOT EXISTS (SELECT 1 FROM p p2 WHERE p2.v > p.v) ORDER BY id") == [
        [2], [4]]


def test_greatest_matches_the_jax_package(strs):
    # a shared defect: GREATEST over an INT column answers a string of NUL
    # bytes in both packages; the port is held to the JAX package's answer
    q(strs, "SELECT id, greatest(v, 15) FROM p ORDER BY id")
    q(strs, "SELECT greatest(3, 7)")


@pytest.fixture()
def charsets():
    sessions = session_pair()
    run_case(["CREATE TABLE c (id INT PRIMARY KEY, s VARCHAR(20) CHARSET latin1, g VARCHAR(20) CHARSET gbk, "
              "b VARBINARY(20))",
              "INSERT INTO c VALUES (1,'café','中文','é'),(2,'abc','汉','b')"], sessions)
    return sessions


def test_byte_semantics_ops_hash_the_column_charset_bytes(charsets):
    got = q(charsets, "SELECT id, md5(s), md5(g), sha1(g) FROM c ORDER BY id")
    want = [[1, "café", "中文"], [2, "abc", "汉"]]
    assert got == [[i, hashlib.md5(s.encode("latin-1")).hexdigest(), hashlib.md5(g.encode("gbk")).hexdigest(),
                    hashlib.sha1(g.encode("gbk")).hexdigest()] for i, s, g in want]


def test_binary_operand_converts_to_the_string_charset(charsets):
    got = q(charsets, "SELECT id, instr(b, 'é'), instr(s, b), lpad(b, 4, 'x'), concat_ws(',', b, s) "
                      "FROM c ORDER BY id")
    assert got == [[1, 1, 0, "xxxé", "é,café"], [2, 0, 2, "xxxb", "b,abc"]]


# ---------------------------------------------------------------- user functions


def test_extension_function():
    from tidb_tpu.sql.extension import EXTENSIONS as J_EXT
    from tidb_tpu.types import new_longlong as j_longlong
    from tidb_tpu_torch.sql.extension import EXTENSIONS as P_EXT
    from tidb_tpu_torch.types import new_longlong as p_longlong

    sessions = session_pair()
    run_case(["CREATE TABLE t (id INT PRIMARY KEY, v INT)", "INSERT INTO t VALUES (1,10),(2,20)"], sessions)
    J_EXT.register_function("tri_ple", lambda x: None if x is None else x * 3, j_longlong())
    P_EXT.register_function("tri_ple", lambda x: None if x is None else x * 3, p_longlong())
    try:
        assert q(sessions, "SELECT tri_ple(v) FROM t ORDER BY id") == [[30], [60]]
        # inside WHERE too (host-only, root-side evaluation)
        assert q(sessions, "SELECT id FROM t WHERE tri_ple(v) = 60") == [[2]]
    finally:
        J_EXT.unregister_function("tri_ple")
        P_EXT.unregister_function("tri_ple")
    # gone from both registries: the statement fails alike
    run_case([Sql("SELECT tri_ple(v) FROM t", err=True)], sessions)


def test_extension_function_cannot_shadow_builtin():
    from tidb_tpu.sql.extension import EXTENSIONS as J_EXT
    from tidb_tpu_torch.sql.extension import EXTENSIONS as P_EXT

    for ext in (J_EXT, P_EXT):
        with pytest.raises(ValueError):
            ext.register_function("concat", lambda *a: "")


def test_extension_sysvar():
    from tidb_tpu.sql.sysvar import DEFINITIONS as J_DEFS
    from tidb_tpu.sql.extension import EXTENSIONS as J_EXT
    from tidb_tpu_torch.sql.sysvar import DEFINITIONS as P_DEFS
    from tidb_tpu_torch.sql.extension import EXTENSIONS as P_EXT

    for ext, defs in ((J_EXT, J_DEFS), (P_EXT, P_DEFS)):
        if "x_custom_flag" not in defs:
            ext.register_sysvar("x_custom_flag", "default_val")
    sessions = session_pair()
    for name in ("jax", "port"):
        assert sessions[name]["s"].sysvars.get("x_custom_flag") == "default_val"
    run_case(["SET x_custom_flag = 'on2'"], sessions)
    for name in ("jax", "port"):
        assert sessions[name]["s"].sysvars.get("x_custom_flag") == "on2"


def test_an_op_neither_method_nor_extension_raises():
    from tidb_tpu_torch.expr.eval_ref import RefEvaluator
    from tidb_tpu_torch.expr.ir import ScalarFunc, lit
    from tidb_tpu_torch.sql.extension import EXTENSIONS
    from tidb_tpu_torch.types import Datum, new_longlong

    ft = new_longlong()
    EXTENSIONS.register_function("dou_ble", lambda x: None if x is None else x * 2, ft)
    try:
        e = ScalarFunc("dou_ble", (lit(21, ft),), ft)
        assert RefEvaluator().eval(e, []) == Datum.i64(42)
    finally:
        EXTENSIONS.unregister_function("dou_ble")
    # the expression outlives its registration: no method, no extension
    with pytest.raises(NotImplementedError, match="no reference evaluator"):
        RefEvaluator().eval(e, [])
