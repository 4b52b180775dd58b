"""Prepared statements and privileges through both packages (the port's
counterpart of the eight non-extension tests of
tests/test_priv_prepared_ext.py; its three extension tests are in
tests/test_torch_subquery.py).

Each package's sessions share one store and one catalog
(`session_pair(shared=True)`), as the reference's `env` fixture does; each
statement runs on the JAX session and on the port's of the same name
(tests/torch_sql_parity.py `Both`), the outcomes must agree, and the
reference's hand-computed answers hold for the port's values.
"""

import pytest

from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import Both, session_pair


@pytest.fixture()
def env():
    pair = session_pair(shared=True, names=("s", "alice", "carol", "dave"))
    for name in ("alice", "carol", "dave"):
        for side in ("jax", "port"):
            pair[side][name].user = name
    root = Both(pair)
    root.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
    root.execute("INSERT INTO t VALUES (1,10),(2,20)")
    return root


# ------------------------------------------------------------- prepared


def test_prepare_execute_deallocate(env):
    s = env
    s.execute("PREPARE q FROM 'SELECT v FROM t WHERE id = ?'")
    s.execute("SET @a = 2")
    assert s.execute("EXECUTE q USING @a").values() == [[20]]
    s.execute("SET @a = 1")
    assert s.execute("EXECUTE q USING @a").values() == [[10]]
    s.execute("DEALLOCATE PREPARE q")
    with pytest.raises(SQLError):
        s.execute("EXECUTE q USING @a")


def test_prepare_param_count_mismatch(env):
    s = env
    s.execute("PREPARE q FROM 'SELECT v FROM t WHERE id = ? AND v > ?'")
    s.execute("SET @a = 1")
    with pytest.raises(SQLError, match="parameters"):
        s.execute("EXECUTE q USING @a")


def test_prepare_dml(env):
    s = env
    s.execute("PREPARE ins FROM 'INSERT INTO t VALUES (?, ?)'")
    s.execute("SET @i = 5")
    s.execute("SET @v = 50")
    s.execute("EXECUTE ins USING @i, @v")
    assert s.execute("SELECT v FROM t WHERE id = 5").values() == [[50]]


def test_prepare_template_reusable(env):
    s = env
    s.execute("PREPARE q FROM 'SELECT count(*) FROM t WHERE v >= ?'")
    for val, want in ((10, 2), (15, 1), (99, 0)):
        s.execute(f"SET @x = {val}")
        assert s.execute("EXECUTE q USING @x").values() == [[want]]


# ------------------------------------------------------------- privileges


def test_user_lifecycle_and_grants(env):
    root, alice = env, env.session("alice")
    root.execute("CREATE USER 'alice' IDENTIFIED BY 'pw'")
    root.execute("GRANT SELECT ON t TO 'alice'")
    assert alice.execute("SELECT count(*) FROM t").values() == [[2]]
    with pytest.raises(SQLError, match="INSERT"):
        alice.execute("INSERT INTO t VALUES (9,90)")
    root.execute("GRANT INSERT ON t TO 'alice'")
    alice.execute("INSERT INTO t VALUES (9,90)")
    root.execute("REVOKE SELECT ON t FROM 'alice'")
    with pytest.raises(SQLError, match="SELECT"):
        alice.execute("SELECT 1 FROM t")
    with pytest.raises(SQLError, match="SUPER"):
        alice.execute("CREATE USER 'bob'")
    root.execute("DROP USER 'alice'")
    with pytest.raises(SQLError):
        root.execute("DROP USER 'alice'")
    root.execute("DROP USER IF EXISTS 'alice'")


def test_user_name_with_backslash_mirrors_cleanly(env):
    """The CREATE / DROP USER mirror into mysql.user escapes backslashes:
    a name ending in a lone backslash keeps its row."""
    root = env
    name = "back\\slash\\"  # an embedded and a trailing backslash
    root.execute("CREATE USER 'back\\\\slash\\\\' IDENTIFIED BY 'pw'")
    rows = root.execute("SELECT User, Host FROM `mysql.user`").values()
    assert [name, "%"] in rows, rows
    # IF NOT EXISTS again: delete-then-insert keeps one row
    root.execute("CREATE USER IF NOT EXISTS 'back\\\\slash\\\\'")
    assert root.execute("SELECT User FROM `mysql.user`").values().count([name]) == 1
    root.execute("DROP USER 'back\\\\slash\\\\'")
    assert [name] not in root.execute("SELECT User FROM `mysql.user`").values()


def test_global_and_db_grants(env):
    root, carol = env, env.session("carol")
    root.execute("CREATE USER 'carol'")
    root.execute("GRANT SELECT ON *.* TO 'carol'")
    assert carol.execute("SELECT count(*) FROM t").values() == [[2]]
    with pytest.raises(SQLError):
        carol.execute("DROP TABLE t")


def test_select_without_from_needs_no_priv(env):
    root, dave = env, env.session("dave")
    root.execute("CREATE USER 'dave'")
    assert dave.execute("SELECT 1 + 1").values() == [[2]]
