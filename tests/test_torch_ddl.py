"""ALTER TABLE and the DDL job framework through both packages (the
port's counterpart of tests/test_ddl.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. Catalog state (columns, DDL jobs) is
read from each package's own catalog.
"""

import pytest

from tidb_tpu_torch.sql import SQLError
from torch_sql_parity import Both


@pytest.fixture()
def sess():
    b = Both()
    b.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
    b.execute("INSERT INTO t VALUES (1,10),(2,20)")
    return b


def columns(b: Both, table: str = "t") -> list:
    return b.call(lambda s, _: [c.name for c in s.catalog.table(table).columns])


def last_job(b: Both) -> dict:
    return b.call(lambda s, _: {k: getattr(s.catalog.ddl_jobs.jobs[-1], k) for k in ("state", "error", "states_seen")})


def test_add_column_origin_default(sess):
    sess.execute("ALTER TABLE t ADD COLUMN w INT DEFAULT 7")
    assert sess.execute("SELECT * FROM t ORDER BY id").values() == [[1, 10, 7], [2, 20, 7]]
    sess.execute("INSERT INTO t VALUES (3, 30, 99)")
    # the origin default fills only the rows from before the ADD; filters see it
    assert sess.execute("SELECT id FROM t WHERE w = 7 ORDER BY id").values() == [[1], [2]]
    # and so does the point get
    assert sess.execute("SELECT w FROM t WHERE id = 1").values() == [[7]]


@pytest.mark.parametrize("ddl, want", [("ALTER TABLE t ADD COLUMN z VARCHAR(5)", [[None]]),
                                       ("ALTER TABLE t ADD COLUMN n INT NOT NULL", [[0]])],
                         ids=["nullable", "not_null_implicit_default"])
def test_add_column(sess, ddl, want):
    sess.execute(ddl)
    assert sess.execute(f"SELECT {ddl.split()[5]} FROM t WHERE id = 1").values() == want


def test_add_column_positions(sess):
    sess.execute("ALTER TABLE t ADD COLUMN a INT FIRST")
    sess.execute("ALTER TABLE t ADD COLUMN b INT AFTER id")
    assert columns(sess) == ["a", "id", "b", "v"]


def test_drop_column(sess):
    sess.execute("ALTER TABLE t ADD COLUMN w INT DEFAULT 1")
    sess.execute("ALTER TABLE t DROP COLUMN w")
    assert columns(sess) == ["id", "v"]
    with pytest.raises(SQLError):
        sess.execute("ALTER TABLE t DROP COLUMN id")  # the handle column


def test_drop_indexed_column_rejected(sess):
    sess.execute("CREATE INDEX iv ON t (v)")
    with pytest.raises(SQLError, match="indexed"):
        sess.execute("ALTER TABLE t DROP COLUMN v")


def test_change_column_rename_keeps_values(sess):
    sess.execute("ALTER TABLE t CHANGE COLUMN v volume BIGINT")
    assert sess.execute("SELECT volume FROM t WHERE id = 2").values() == [[20]]


def test_modify_incompatible_rejected(sess):
    with pytest.raises(SQLError, match="reinterpret"):
        sess.execute("ALTER TABLE t MODIFY COLUMN v VARCHAR(10)")


def test_alter_add_drop_index(sess):
    sess.execute("ALTER TABLE t ADD UNIQUE INDEX uv (v)")
    with pytest.raises(SQLError, match="duplicate"):
        sess.execute("INSERT INTO t VALUES (9, 10)")
    sess.execute("ALTER TABLE t DROP INDEX uv")
    sess.execute("INSERT INTO t VALUES (9, 10)")


def test_rename_table(sess):
    sess.execute("RENAME TABLE t TO t2")
    assert sess.execute("SELECT count(*) FROM t2").values() == [[2]]
    with pytest.raises(Exception):
        sess.execute("SELECT * FROM t")


def test_ddl_jobs_recorded(sess):
    sess.execute("ALTER TABLE t ADD COLUMN w INT")
    sess.execute("CREATE INDEX iv ON t (v)")
    rows = sess.execute("ADMIN SHOW DDL JOBS").values()
    assert rows[0][1] == "add index" and rows[0][4] == "synced"
    assert rows[1][1] == "add column"
    # the index job stepped through the online states
    assert last_job(sess)["states_seen"] == ["delete_only", "write_only", "write_reorg", "public"]


def test_failed_job_recorded_cancelled(sess):
    with pytest.raises(SQLError):
        sess.execute("ALTER TABLE t MODIFY COLUMN v VARCHAR(5)")
    job = last_job(sess)
    assert job["state"] == "cancelled" and "reinterpret" in job["error"]


def test_admin_check_table(sess):
    sess.execute("CREATE INDEX iv ON t (v)")
    sess.execute("ADMIN CHECK TABLE t")  # consistent: no raise

    def corrupt(s, pkg):
        # drop one index entry behind the session's back
        meta = s.catalog.table("t")
        D = pkg.types.Datum
        key = pkg.tablecodec.encode_index_key(meta.table_id, meta.indices[0].index_id, [D.i64(10), D.i64(1)])
        s.store.put_index(key, None, s.store.next_ts())

    sess.call(corrupt)
    with pytest.raises(SQLError, match="missing"):
        sess.execute("ADMIN CHECK TABLE t")


def test_alter_in_txn_implicitly_commits(sess):
    sess.execute("BEGIN")
    sess.execute("UPDATE t SET v = 1 WHERE id = 1")
    sess.execute("ALTER TABLE t ADD COLUMN w INT")
    assert sess.call(lambda s, _: s.txn is None)
    assert sess.execute("SELECT v FROM t WHERE id = 1").values() == [[1]]
