"""The SQL session of the port against the JAX package's, on the CPU.

Every case of tests/test_sql.py (46: basics, aggregation, joins, DML, the
review regressions, SHOW / EXPLAIN / DROP, a region-split store, the
select limit and stale reads) and the SQL cases of
tests/test_expr_breadth.py run the same statements through
`tidb_tpu.sql.Session()` and `tidb_tpu_torch.sql.Session(device="cpu")`;
column names, field types, rows, affected counts, plan-cache outcomes and
errors (class, MySQL code, message) must agree, reals to 1e-12 relative
(tests/torch_sql_parity.py). Beside them: the stale result-cache trap (a
region warmed, then written, then read back through the coprocessor),
PREPARE / EXECUTE with a plan-cache hit, LOAD DATA, LOAD STATS and the
statement tiers.
"""

import json

import pytest

from torch_sql_parity import Call, Sql, run_case, session_pair, split_at

EMP = [
    "CREATE TABLE emp (id BIGINT PRIMARY KEY, dept VARCHAR(10), salary DECIMAL(10,2),"
    " age INT, hired DATETIME, bonus DOUBLE)",
    "INSERT INTO emp (id, dept, salary, age, hired, bonus) VALUES"
    " (1, 'eng', 1000.00, 30, '2020-01-15 00:00:00', 0.1),"
    " (2, 'eng', 2000.00, 35, '2019-06-01 00:00:00', 0.2),"
    " (3, 'sales', 1500.00, 28, '2021-03-10 00:00:00', NULL),"
    " (4, 'sales', 500.00, 45, '2018-11-20 00:00:00', 0.05),"
    " (5, 'hr', 800.00, 30, '2022-07-04 00:00:00', 0.0),"
    " (6, NULL, 1200.00, NULL, NULL, 0.15)",
]
DEPT = EMP + [
    "CREATE TABLE dept (dname VARCHAR(10), head VARCHAR(20), budget BIGINT)",
    "INSERT INTO dept VALUES ('eng','ada',100), ('sales','tina',50), ('ops','zed',10)",
]


def _save_ts(pkg, sessions):
    """Draw a timestamp from the store's TSO and keep it for a later step."""
    sessions["saved_ts"] = sessions["s"].store.next_ts()
    return sessions["saved_ts"]


def _snapshot_at_saved_ts(pkg, sessions):
    return sessions["s"].execute(f"set tidb_snapshot = {sessions['saved_ts']}")


def _run_gc(pkg, sessions):
    return sessions["s"].store.run_gc()


SQL_CASES = {
    # TestBasics
    "count_scan": EMP + ["SELECT count(*) FROM emp"],
    "where_filter": EMP + ["SELECT id FROM emp WHERE salary > 1000 ORDER BY id"],
    "projection_expr": EMP + ["SELECT id, salary * 2 FROM emp WHERE id = 1"],
    "select_star": EMP + ["SELECT * FROM emp WHERE id = 5"],
    "order_desc_limit_offset": EMP + ["SELECT id FROM emp ORDER BY salary DESC LIMIT 2 OFFSET 1"],
    "limit_no_order": EMP + ["SELECT id FROM emp LIMIT 3"],
    "order_without_limit_sorts_all": EMP + ["SELECT id FROM emp ORDER BY age, id"],
    "in_between_like_case": EMP + [
        "SELECT id FROM emp WHERE dept IN ('eng', 'hr')",
        "SELECT id FROM emp WHERE age BETWEEN 28 AND 35",
        "SELECT id FROM emp WHERE dept LIKE 'e%'",
        "SELECT id, CASE WHEN salary >= 1500 THEN 'high' WHEN salary >= 800 THEN 'mid' ELSE 'low' END"
        " FROM emp ORDER BY id",
    ],
    "null_semantics": EMP + [
        "SELECT count(*) FROM emp WHERE dept IS NULL",
        "SELECT count(*) FROM emp WHERE dept IS NOT NULL",
        "SELECT count(*) FROM emp WHERE age <> 30",
    ],
    "datetime_compare": EMP + ["SELECT id FROM emp WHERE hired >= '2021-01-01' ORDER BY id"],
    "select_no_from": EMP + ["SELECT 2 + 3 * 4"],
    # TestAggregation
    "scalar_aggs": EMP + ["SELECT count(*), count(age), sum(salary), min(age), max(age), avg(salary) FROM emp"],
    "group_by_having_order": EMP + [
        "SELECT dept, count(*) c, sum(salary) FROM emp GROUP BY dept HAVING c >= 2 ORDER BY dept"],
    "implicit_first_row": EMP + ["SELECT dept, age FROM emp GROUP BY dept ORDER BY dept"],
    "distinct": EMP + ["SELECT DISTINCT age FROM emp ORDER BY age"],
    "count_distinct": EMP + ["SELECT count(DISTINCT age) FROM emp"],
    "group_expr_key": EMP + ["SELECT age > 30, count(*) FROM emp GROUP BY age > 30 ORDER BY count(*)"],
    "min_max_string": EMP + ["SELECT min(dept), max(dept) FROM emp"],
    # TestJoins
    "inner_join_where": DEPT + ["SELECT e.id, d.head FROM emp e, dept d WHERE e.dept = d.dname ORDER BY e.id"],
    "join_on_syntax": DEPT + [
        "SELECT d.head, sum(e.salary) FROM emp e JOIN dept d ON e.dept = d.dname GROUP BY d.head ORDER BY d.head"],
    "left_join": DEPT + [
        "SELECT d.dname, e.id FROM dept d LEFT JOIN emp e ON d.dname = e.dept ORDER BY d.dname, e.id"],
    "cartesian": DEPT + ["SELECT count(*) FROM emp, dept"],
    "three_way_join": DEPT + [
        "CREATE TABLE region (head2 VARCHAR(20), zone VARCHAR(8))",
        "INSERT INTO region VALUES ('ada','west'), ('tina','east')",
        "SELECT e.id, r.zone FROM emp e, dept d, region r"
        " WHERE e.dept = d.dname AND d.head = r.head2 AND e.salary >= 1500 ORDER BY e.id",
    ],
    # TestDML
    "update_delete_truncate": EMP + [
        "UPDATE emp SET salary = salary + 100 WHERE dept = 'eng'",
        "SELECT sum(salary) FROM emp WHERE dept = 'eng'",
        "DELETE FROM emp WHERE age > 40",
        "SELECT count(*) FROM emp",
        "TRUNCATE TABLE emp",
        "SELECT count(*) FROM emp",
    ],
    "insert_select": EMP + [
        "CREATE TABLE emp2 (id BIGINT PRIMARY KEY, salary DECIMAL(10,2))",
        "INSERT INTO emp2 (id, salary) SELECT id, salary FROM emp WHERE salary >= 1000",
        "SELECT count(*) FROM emp2",
    ],
    "autoid": EMP + ["CREATE TABLE noid (v INT)", "INSERT INTO noid VALUES (7), (8)", "SELECT count(*) FROM noid"],
    # TestReviewRegressions
    "left_join_where_applies_post_join": EMP + [
        "CREATE TABLE dept2 (dname VARCHAR(10))",
        "INSERT INTO dept2 VALUES ('eng'), ('sales'), ('ops')",
        "SELECT d.dname, e.id FROM dept2 d LEFT JOIN emp e ON d.dname = e.dept WHERE e.salary > 1500",
    ],
    "delete_order_limit": EMP + [
        "DELETE FROM emp ORDER BY salary LIMIT 2",
        "SELECT min(salary) FROM emp",
    ],
    "join_using": EMP + [
        "CREATE TABLE u1 (g INT, x INT)",
        "CREATE TABLE u2 (g INT, y INT)",
        "INSERT INTO u1 VALUES (1,10),(1,11),(2,20)",
        "INSERT INTO u2 VALUES (1,100),(2,200),(3,300)",
        "SELECT count(*) FROM u1 JOIN u2 USING (g)",
    ],
    "alias_shadowing": EMP + [
        "SELECT salary * 2 AS salary, id FROM emp WHERE salary > 1800 ORDER BY id",
        "SELECT salary AS salary FROM emp",
    ],
    "duplicate_pk": EMP + [
        Sql("INSERT INTO emp (id, salary) VALUES (1, 1.00)", err=True),
        "INSERT IGNORE INTO emp (id, salary) VALUES (1, 1.00)",
        "SELECT salary FROM emp WHERE id = 1",
        "REPLACE INTO emp (id, dept, salary, age, hired, bonus) VALUES (1, 'ops', 9.00, 1, NULL, 0)",
        "SELECT salary FROM emp WHERE id = 1",
        "SELECT count(*) FROM emp",
    ],
    "update_sequential_assignment": EMP + [
        "CREATE TABLE seqt (id BIGINT PRIMARY KEY, a INT, b INT)",
        "INSERT INTO seqt VALUES (1, 1, 100)",
        "UPDATE seqt SET a = 5, b = a WHERE id = 1",
        "SELECT b FROM seqt",
    ],
    "order_by_position": EMP + ["SELECT id FROM emp ORDER BY 1 DESC LIMIT 3"],
    "insert_select_width_mismatch": EMP + [
        "CREATE TABLE w (a INT)",
        Sql("INSERT INTO w (a) SELECT id, age FROM emp", err=True),
    ],
    "update_pk_moves_row": EMP + [
        "CREATE TABLE pk (id BIGINT PRIMARY KEY, v INT)",
        "INSERT INTO pk VALUES (1, 10)",
        "UPDATE pk SET id = 5 WHERE id = 1",
        "SELECT count(*) FROM pk",
        Sql("INSERT INTO pk VALUES (5, 99)", err=True),
        "INSERT INTO pk VALUES (1, 99)",
        Sql("UPDATE pk SET id = 5 WHERE id = 1", err=True),
        "SELECT id, v FROM pk ORDER BY id",
    ],
    "non_int_pk_nonclustered": EMP + [
        "CREATE TABLE sp (a VARCHAR(10) PRIMARY KEY)",
        "INSERT INTO sp VALUES ('x')",
        Sql("INSERT INTO sp VALUES ('x')", err=True),
        Sql("INSERT INTO sp VALUES (NULL)", err=True),
        "CREATE TABLE cp (a INT, b INT, PRIMARY KEY (a, b))",
        "INSERT INTO cp VALUES (1, 2)",
        Sql("INSERT INTO cp VALUES (1, 2)", err=True),
        "SELECT a FROM sp",
    ],
    "star_textual_order_after_reorder": EMP + [
        "CREATE TABLE small (k BIGINT PRIMARY KEY, s VARCHAR(4))",
        "INSERT INTO small VALUES (30, 'x')",
        "SELECT * FROM small, emp WHERE small.k = emp.age AND emp.id = 1",
    ],
    "ambiguous_column": EMP + [
        "CREATE TABLE amb1 (x INT, a INT)",
        "CREATE TABLE amb2 (x INT, b INT)",
        "INSERT INTO amb1 VALUES (1, 1)",
        "INSERT INTO amb2 VALUES (1, 2)",
        Sql("SELECT a FROM amb1, amb2 WHERE x > 0 AND amb1.a = amb2.b", err=True),
    ],
    # TestMeta
    "show_tables": EMP + ["SHOW TABLES"],
    "explain_shows_split": EMP + ["EXPLAIN SELECT dept, count(*) FROM emp GROUP BY dept"],
    "drop_and_errors": EMP + [
        "DROP TABLE emp",
        Sql("SELECT * FROM emp", err=True),
        Sql("DROP TABLE emp", err=True),
        "DROP TABLE IF EXISTS emp",
    ],
    "unknown_column": EMP + [Sql("SELECT nope FROM emp", err=True)],
    "multi_region_sql": [
        "CREATE TABLE big (id BIGINT PRIMARY KEY, g INT, v DECIMAL(8,2))",
        "INSERT INTO big (id, g, v) VALUES " + ", ".join(f"({i}, {i % 5}, {i}.25)" for i in range(200)),
        split_at("big", 50, 100, 150),
        "SELECT g, count(*), sum(v) FROM big GROUP BY g ORDER BY g",
    ],
    # TestStaleReadAndSelectLimit
    "sql_select_limit_top_level_only": [
        "create table sl (a bigint primary key)",
        "insert into sl values (1),(2),(3),(4),(5)",
        "set sql_select_limit = 2",
        "select * from sl",
        "select count(*) from (select * from sl) d",
        "select a from sl where a in (select a from sl) order by a",
        "select a from sl union select a from sl",
        "set sql_select_limit = 18446744073709551615",
        "select * from sl",
    ],
    "tidb_snapshot_stale_read": [
        "create table sr (id bigint primary key, v bigint)",
        "insert into sr values (1, 10)",
        Call(_save_ts),
        "update sr set v = 20 where id = 1",
        Call(_snapshot_at_saved_ts),
        "select v from sr",
        Sql("update sr set v = 30 where id = 1", err=True),
        "set tidb_snapshot = ''",
        "select v from sr",
    ],
    "tidb_snapshot_rejects_begin_ddl_and_pre_gc_ts": [
        "create table sg (id bigint primary key, v bigint)",
        "insert into sg values (1, 10)",
        Call(_save_ts),
        "update sg set v = 20 where id = 1",
        Call(_run_gc),
        Call(_snapshot_at_saved_ts),
        Sql("select v from sg", err=True),
        Call(_save_ts),
        Call(_snapshot_at_saved_ts),
        Sql("begin", err=True),
        Sql("create table nope (a bigint)", err=True),
        "set tidb_snapshot = ''",
        "begin",
        "commit",
    ],
}

BREADTH_CASES = {
    # tests/test_expr_breadth.py, the cases that go through a Session
    "sql_stddev_group_concat": [
        "CREATE TABLE m (id BIGINT PRIMARY KEY, g INT, v DOUBLE, w VARCHAR(8))",
        "INSERT INTO m VALUES (1,1,2.0,'a'), (2,1,4.0,'b'), (3,1,6.0,'c'), (4,2,5.0,'z')",
        "SELECT g, stddev(v), var_pop(v), group_concat(w SEPARATOR '|') FROM m GROUP BY g ORDER BY g",
        "SELECT var_samp(v) FROM m WHERE g = 2",
    ],
    "moment_aggs_split_over_regions": [
        "CREATE TABLE mm (id BIGINT PRIMARY KEY, v DOUBLE)",
        "INSERT INTO mm (id, v) VALUES " + ", ".join(f"({i}, {i * 0.5})" for i in range(200)),
        split_at("mm", 100),
        "SELECT var_pop(v), stddev_samp(v) FROM mm",
    ],
    "sql_string_and_date": [
        "CREATE TABLE e (id BIGINT PRIMARY KEY, name VARCHAR(20), hired DATETIME)",
        "INSERT INTO e VALUES (1, '  Ada  ', '2020-01-31 00:00:00'), (2, 'bob', '2019-06-15 00:00:00')",
        "SELECT upper(trim(name)), concat(name, '!') FROM e ORDER BY id",
        "SELECT id FROM e WHERE hired + INTERVAL 1 MONTH > '2020-02-28' ORDER BY id",
        "SELECT datediff('2020-03-01', hired) FROM e WHERE id = 1",
        "SELECT replace(name, 'o', '0') FROM e WHERE id = 2",
    ],
    "update_unique_failure_keeps_index": [
        "CREATE TABLE u (id BIGINT PRIMARY KEY, a INT)",
        "INSERT INTO u VALUES (1, 5), (2, 6)",
        "CREATE UNIQUE INDEX ua ON u (a)",
        Sql("UPDATE u SET a = 6 WHERE id = 1", err=True),
        "SELECT count(*) FROM u WHERE a = 5",
    ],
    "in_duplicates_no_double_scan": [
        "CREATE TABLE t2 (id BIGINT PRIMARY KEY)",
        "INSERT INTO t2 VALUES (4), (5), (6)",
        "SELECT count(*) FROM t2 WHERE id IN (5, 5)",
        "SELECT count(*) FROM t2 WHERE id IN (4, 5, 5, 6)",
        "SELECT count(*) FROM t2 WHERE id >= 4 AND id IN (4, 5)",
    ],
    "distinct_new_aggs": [
        "CREATE TABLE d (id BIGINT PRIMARY KEY, g INT)",
        "INSERT INTO d VALUES (1,1),(2,1),(3,1),(4,2)",
        "SELECT group_concat(DISTINCT g) FROM d",
        "SELECT var_pop(DISTINCT g) FROM d",
    ],
}


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_sql_case(name):
    run_case(SQL_CASES[name])


@pytest.mark.parametrize("name", list(BREADTH_CASES))
def test_expr_breadth_sql_case(name):
    run_case(BREADTH_CASES[name])


def test_case_counts():
    assert len(SQL_CASES) == 46


def _grouped_or_joined(steps) -> bool:
    return any(isinstance(q, str) and q.upper().startswith("SELECT") and (" GROUP BY " in q.upper()
                                                                          or " JOIN " in q.upper())
               for q in steps)


MESH_CASES = [name for name, steps in SQL_CASES.items() if _grouped_or_joined(steps)]


@pytest.mark.parametrize("name", MESH_CASES)
def test_sql_case_mesh_on(name):
    """The GROUP BY and join cases with the mesh on: the JAX session on
    eight devices, the port's on eight CPU shards (statement tier "mpp":
    each package's try_mpp_select, the mesh select where it declines)."""
    run_case(SQL_CASES[name], session_pair(mesh=True))


# the stale result-cache trap: a region's response is cached by the store;
# a write that did not bump the write version would have the next read
# served the pre-write rows
STALE_CACHE = [
    "CREATE TABLE sc (id BIGINT PRIMARY KEY, g INT, v BIGINT)",
    "INSERT INTO sc VALUES " + ", ".join(f"({i}, {i % 3}, {i})" for i in range(64)),
    split_at("sc", 32),
    "SELECT g, count(*), sum(v) FROM sc GROUP BY g ORDER BY g",
    "SELECT g, count(*), sum(v) FROM sc GROUP BY g ORDER BY g",  # a result-cache hit
    "UPDATE sc SET v = v + 1000 WHERE id = 40",
    "SELECT g, count(*), sum(v) FROM sc GROUP BY g ORDER BY g",
    "BEGIN",
    "DELETE FROM sc WHERE id < 8",
    "INSERT INTO sc VALUES (100, 1, 5)",
    "COMMIT",
    "SELECT g, count(*), sum(v) FROM sc GROUP BY g ORDER BY g",
    "SELECT sum(v) FROM sc WHERE v > 10",
]


def test_stale_result_cache_after_writes():
    sessions = session_pair()
    run_case(STALE_CACHE, sessions)
    store = sessions["port"]["s"].store
    hits = store.stats()["result_cache_hits"]
    assert hits >= 1  # the warm read was served from the cache
    # and every read after a commit saw the write (checked by run_case
    # against the JAX package); the values themselves:
    got = sessions["port"]["s"].execute("SELECT sum(v) FROM sc").scalar()
    want = sum(range(8, 64)) + 1000 + 5
    assert int(str(got)) == want
    assert store.stats()["oracle_fallbacks"] == 0


PREPARE = EMP + [
    "PREPARE q FROM 'SELECT dept, count(*), sum(salary) FROM emp WHERE age > ? GROUP BY dept ORDER BY dept'",
    "SET @a = 20",
    "EXECUTE q USING @a",
    "EXECUTE q USING @a",
]
AFTER_HIT = [
    "SET @a = 29",
    "EXECUTE q USING @a",
    "PREPARE p FROM 'SELECT id, salary FROM emp WHERE id = ?'",
    "EXECUTE p USING @a",
    "SET @a = 3",
    "EXECUTE p USING @a",
    "DEALLOCATE PREPARE q",
    Sql("EXECUTE q USING @a", err=True),
]


def test_prepare_execute_plan_cache_hit():
    sessions = session_pair()
    run_case(PREPARE, sessions)
    status = sessions["port"]["s"]._last_plan_cache
    assert status is not None and status[0] == "hit", status
    run_case(AFTER_HIT[:-2], sessions)
    assert sessions["port"]["s"]._last_plan_cache[0] == "hit"  # the second EXECUTE of p
    run_case(AFTER_HIT[-2:], sessions)


def _stats_and_hint(pkg, sessions):
    """The catalog's stats of `ld` and the planner's small-groups hint of a
    GROUP BY over its analyzed columns."""
    s = sessions["s"]
    meta = s.catalog.table("ld")
    st = s.catalog.stats[meta.table_id]
    plan = pkg.sql.plan_select(pkg.parse_one("SELECT g, count(*) FROM ld GROUP BY g"), s.catalog)
    return ([(c, st.columns[c].ndv, st.columns[c].null_count, st.columns[c].total) for c in sorted(st.columns)],
            st.row_count, meta.row_count, plan.small_groups)


def test_load_data_analyze_and_load_stats(tmp_path):
    csv = tmp_path / "rows.csv"
    csv.write_text("".join(f"{i},{i % 4},{i * 1.5}\n" for i in range(50)))
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps({"table_name": "ld", "count": 5000, "columns": {
        "g": {"null_count": 0, "histogram": {"ndv": 9}}, "v": {"null_count": 2, "histogram": {"ndv": 4000}}}}))
    run_case([
        "CREATE TABLE ld (id BIGINT PRIMARY KEY, g INT, v DOUBLE)",
        f"LOAD DATA INFILE '{csv}' INTO TABLE ld FIELDS TERMINATED BY ','",
        "SELECT g, count(*), sum(v) FROM ld GROUP BY g ORDER BY g",
        Sql(f"LOAD DATA INFILE '{csv}' INTO TABLE ld FIELDS TERMINATED BY ','", err=True),
        "ANALYZE TABLE ld",
        Call(_stats_and_hint),
        f"LOAD STATS '{stats}'",
        Call(_stats_and_hint),
        "SELECT g, count(*), sum(v) FROM ld GROUP BY g ORDER BY g",
    ])


@pytest.mark.parametrize("tier", ["pool", "batch", "single", "mesh"])
def test_statement_tiers(tier):
    """Q1-, Q6- and join-shaped SQL over a split table in each tier of the
    dispatch loop, and with the mesh on (eight CPU shards in the port: the
    mesh select for the GROUP BYs, the store's mesh tier for the rest)."""
    sets = {"pool": [], "batch": ["SET tidb_allow_batch_cop = 1"], "single": ["SET tidb_distsql_scan_concurrency = 1"],
            "mesh": [
                # without ORDER BY (a Sort keeps a plan off the mesh select):
                # the rows come back in the exchange's order
                "SELECT l_returnflag, l_linestatus, sum(l_quantity), avg(l_discount), count(*) FROM li"
                " WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus",
                "SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) FROM li JOIN od"
                " ON l_orderkey = o_orderkey WHERE o_orderdate < '1997-03-15' GROUP BY l_orderkey",
            ]}
    steps = [
        "CREATE TABLE li (l_orderkey BIGINT, l_quantity DECIMAL(15,2), l_extendedprice DECIMAL(15,2),"
        " l_discount DECIMAL(15,2), l_returnflag CHAR(1), l_linestatus CHAR(1), l_shipdate DATE)",
        "INSERT INTO li VALUES " + ", ".join(
            f"({i % 37}, {i % 50 + 1}.00, {1000 + i * 7 % 900}.{i % 100:02d}, 0.0{i % 10},"
            f" '{'ARN'[i % 3]}', '{'FO'[i % 2]}', '199{4 + i % 5}-0{1 + i % 9}-1{i % 10}')" for i in range(300)),
        "CREATE TABLE od (o_orderkey BIGINT PRIMARY KEY, o_orderdate DATE, o_shippriority INT)",
        "INSERT INTO od VALUES " + ", ".join(f"({k}, '199{5 + k % 3}-03-1{k % 10}', {k % 2})" for k in range(37)),
        split_at("li", 100, 200),
        split_at("od", 12, 25),
        *sets[tier],
        "SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),"
        " sum(l_extendedprice * (1 - l_discount)), avg(l_quantity), avg(l_discount), count(*)"
        " FROM li WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus"
        " ORDER BY l_returnflag, l_linestatus",
        "SELECT sum(l_extendedprice * l_discount) FROM li WHERE l_shipdate >= '1994-01-01'"
        " AND l_shipdate < '1995-01-01' AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24",
        "SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue FROM li JOIN od"
        " ON l_orderkey = o_orderkey WHERE o_orderdate < '1997-03-15' AND l_shipdate > '1995-03-15'"
        " GROUP BY l_orderkey ORDER BY revenue DESC, l_orderkey LIMIT 10",
        "SELECT l_orderkey, l_extendedprice FROM li ORDER BY l_extendedprice DESC, l_orderkey LIMIT 5",
    ]
    sessions = session_pair(mesh=tier == "mesh")
    from tidb_tpu_torch.util import metrics

    m0 = metrics.MESH_SELECTS.value
    run_case(steps, sessions)
    st = sessions["port"]["s"].store.stats()
    assert st["oracle_fallbacks"] == 0 and st["other_errors"] == 0 and st["batch_fallbacks"] == 0
    if tier == "batch":
        assert st["batch_batches"] >= 1
    if tier == "mesh":
        # the two unordered GROUP BYs through the mesh select, Q6 and the
        # TopN through the store's mesh tier
        assert metrics.MESH_SELECTS.value - m0 == 2
        assert st["mesh_batches"] >= 1 and st["mesh_fallbacks"] == 0


def test_range_estimate_over_an_analyzed_date_column():
    """The one repair in the copied SQL layer (sql/stats.py _as_float): a
    range predicate over an analyzed date column, in a join the planner
    orders by estimated rows, reaches the histogram estimate, where the
    reference calls MyTime.to_packed(), which does not exist. The port
    answers, with the rows the reference gives without the histogram."""
    make = [
        "CREATE TABLE dt (id BIGINT PRIMARY KEY, d DATE, v BIGINT)",
        "INSERT INTO dt VALUES " + ", ".join(f"({i}, '20{10 + i % 13}-0{1 + i % 9}-1{i % 10}', {i})" for i in range(600)),
        "CREATE TABLE dk (k BIGINT PRIMARY KEY, w BIGINT)",
        "INSERT INTO dk VALUES " + ", ".join(f"({i}, {i % 3})" for i in range(0, 600, 2)),
    ]
    query = "SELECT count(*), sum(v) FROM dt JOIN dk ON dt.id = dk.k WHERE dt.d > '2015-05-01'"
    sessions = session_pair()
    run_case(make, sessions)
    want = sessions["jax"]["s"].execute(query).values()
    for pkg in ("jax", "port"):
        sessions[pkg]["s"].execute("ANALYZE TABLE dt")
    with pytest.raises(AttributeError, match="to_packed"):
        sessions["jax"]["s"].execute(query)
    got = sessions["port"]["s"].execute(query).values()
    assert [[got[0][0], int(str(got[0][1]))]] == [[want[0][0], int(str(want[0][1]))]]
    rows = [i for i in range(0, 600, 2) if (10 + i % 13, 1 + i % 9, 10 + i % 10) > (15, 5, 1)]
    assert want[0][0] == len(rows) and int(str(want[0][1])) == sum(rows)


def test_group_by_a_select_alias_of_an_expression():
    """The repair of a planner fault both packages had (sql/planner.py
    group_key): GROUP BY naming a select alias of an expression grouped by
    the expression lowered over the wrong column. The JAX package still
    raises; the port groups by the alias's expression, and its answer
    equals a numpy group count (and the answer of naming the expression)."""
    import numpy as np

    rng = np.random.default_rng(16)
    phones = [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-{rng.integers(1000, 9999)}" for _ in range(300)]
    bal = rng.integers(-500, 5000, 300)
    make = ["CREATE TABLE c (id BIGINT PRIMARY KEY, phone CHAR(15) NOT NULL, bal BIGINT NOT NULL)",
            "INSERT INTO c VALUES " + ", ".join(f"({i}, '{p}', {b})" for i, (p, b) in enumerate(zip(phones, bal)))]
    alias = "SELECT SUBSTRING(phone, 1, 2) AS cc, COUNT(*), SUM(bal) FROM c GROUP BY cc"
    named = "SELECT SUBSTRING(phone, 1, 2) AS cc, COUNT(*), SUM(bal) FROM c GROUP BY SUBSTRING(phone, 1, 2)"
    sessions = session_pair()
    run_case(make, sessions)
    with pytest.raises(IndexError, match="[Tt]oo many indices"):
        sessions["jax"]["s"].execute(alias)
    port = sessions["port"]["s"]
    got = {r[0]: (r[1], int(str(r[2]))) for r in port.execute(alias).values()}
    cc = np.array([int(p[:2]) for p in phones])
    want = {f"{k}": (int((cc == k).sum()), int(bal[cc == k].sum())) for k in np.unique(cc)}
    assert got == want
    assert {r[0]: (r[1], int(str(r[2]))) for r in port.execute(named).values()} == want
    assert {r[0]: (r[1], int(str(r[2]))) for r in sessions["jax"]["s"].execute(named).values()} == want
