"""information_schema memtables through both packages (the port's
counterpart of tests/test_infoschema.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values.
"""

import pytest

from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import Both


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT, s VARCHAR(8))")
    b.execute("CREATE TABLE u (id INT PRIMARY KEY)")
    b.execute("CREATE UNIQUE INDEX uv ON t (v)")
    b.execute("INSERT INTO t VALUES (1,1,'a'),(2,2,'b')")
    return b


def test_tables(sess):
    got = sess.execute("SELECT table_name, table_rows FROM information_schema.tables "
                       "WHERE table_schema = 'test' ORDER BY table_name").values()
    assert got == [["t", 2], ["u", 0]]
    # the mysql bootstrap schema is listed too
    assert sess.execute("SELECT count(*) FROM information_schema.tables WHERE table_schema = 'mysql'").values()[0][0] >= 5


def test_columns(sess):
    got = sess.execute("SELECT column_name, column_type, column_key FROM information_schema.columns "
                       "WHERE table_name = 't' ORDER BY ordinal_position").values()
    # declared spellings are kept (INT stays "int")
    assert got == [["id", "int", "PRI"], ["v", "int", ""], ["s", "varchar(8)", ""]]


def test_statistics(sess):
    got = sess.execute("SELECT index_name, non_unique, column_name FROM information_schema.statistics").values()
    assert got == [["uv", 0, "v"]]


def test_join_memtables(sess):
    got = sess.execute("SELECT count(*) FROM information_schema.columns c "
                       "JOIN information_schema.tables tt ON c.table_name = tt.table_name "
                       "WHERE tt.table_schema = 'test'").values()
    assert got == [[4]]


def test_unknown_memtable(sess):
    with pytest.raises(SQLError, match="not supported"):
        sess.execute("SELECT * FROM information_schema.engines")


def test_memtable_does_not_shadow_user_table(sess):
    sess.execute("CREATE TABLE tables (id INT PRIMARY KEY)")
    sess.execute("INSERT INTO tables VALUES (7)")
    assert sess.execute("SELECT id FROM tables").values() == [[7]]
    assert sess.execute("SELECT count(*) FROM information_schema.tables WHERE table_schema = 'test'").values() == [[3]]
