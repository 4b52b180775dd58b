"""Partitioned tables through both packages (the port's counterpart of
tests/test_partition.py): RANGE and HASH partitions in their own key
spaces, pruning in EXPLAIN, row movement on an UPDATE of the partition
column, and the partition rules.

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. Key placement is read from each
package's own store.
"""

import importlib

import pytest

from torch_sql_parity import JAX, PORT, Both

RANGE_DDL = ("create table r (amt bigint primary key, note varchar(16)) partition by range (amt) ("
             " partition p0 values less than (100), partition p1 values less than (200),"
             " partition p2 values less than maxvalue)")


def _range_session() -> Both:
    b = Both()
    b.execute(RANGE_DDL)
    b.execute("insert into r values " + ",".join(f"({v}, 'n{v}')" for v in (5, 50, 150, 199, 250, 1000)))
    return b


def placed(table: str, probes):
    """fn(session, pkg): for each (partition index, handle) whether the
    row key is in that partition's key space at a fresh timestamp."""

    def run(s, pkg):
        pids = s.catalog.table(table).physical_ids()
        ts = s.store.next_ts()
        return [s.store.kv.get(pkg.tablecodec.encode_row_key(pids[i], h), ts) is not None for i, h in probes]

    return run


def ints(res) -> list:
    return [int(x[0].val) for x in res.rows]


def explained(b: Both, sql: str) -> str:
    return "\n".join(str(d.val) for row in b.execute(sql).rows for d in row)


def _new_session(pkg, **kw):
    return pkg.sql.Session(**({"device": "cpu"} if pkg is PORT else {}), **kw)


class TestRangePartition:
    def test_rows_land_in_partition_keyspaces(self):
        s = _range_session()
        pids = s.call(lambda sess, _: (len(sess.catalog.table("r").physical_ids()),
                                       sess.catalog.table("r").table_id in sess.catalog.table("r").physical_ids()))
        assert pids == (3, False)
        # amt=5 under p0, amt=150 under p1, amt=250 under p2
        assert s.call(placed("r", [(0, 5), (1, 150), (2, 250), (0, 150)])) == [True, True, True, False]

    def test_select_scans_all_partitions(self):
        s = _range_session()
        assert ints(s.execute("select amt from r order by amt")) == [5, 50, 150, 199, 250, 1000]
        assert ints(s.execute("select count(*) from r")) == [6]

    def test_pruning_visible_in_explain(self):
        s = _range_session()
        assert "partitions(p1,p2)" in explained(s, "explain select * from r where amt >= 150 and amt < 210")
        assert "partitions(p0)" in explained(s, "explain select * from r where amt = 50")
        assert "partitions(p0,p1,p2)" in explained(s, "explain select * from r")

    def test_pruned_select_results(self):
        s = _range_session()
        assert ints(s.execute("select amt from r where amt >= 150 and amt < 260 order by amt")) == [150, 199, 250]
        assert int(str(s.execute("select sum(amt) from r where amt < 100").rows[0][0].val)) == 55

    def test_update_moves_row_across_partitions(self):
        s = _range_session()
        s.execute("update r set amt = 120 where amt = 5")
        assert s.call(placed("r", [(0, 5), (1, 120)])) == [False, True]
        assert ints(s.execute("select amt from r where amt >= 100 and amt < 200 order by amt")) == [120, 150, 199]

    def test_delete_and_out_of_range_insert(self):
        s = _range_session()
        s.execute("delete from r where amt >= 200")
        assert ints(s.execute("select count(*) from r")) == [4]
        s2 = Both()
        s2.execute("create table b (v bigint) partition by range (v) (partition p0 values less than (10))")
        with pytest.raises(Exception, match="no partition"):
            s2.execute("insert into b values (99)")

    def test_partition_survives_restart(self):
        s = _range_session()
        s2 = Both({name: {"s": _new_session(pkg, store=s.pair[name]["s"].store)}
                   for name, pkg in (("jax", JAX), ("port", PORT))})
        parts = s2.call(lambda sess, _: sess.catalog.table("r").partition is not None
                        and len(sess.catalog.table("r").partition.parts))
        assert parts == 3
        assert ints(s2.execute("select count(*) from r where amt < 100")) == [2]
        s2.execute("insert into r values (60, 'new')")
        assert ints(s2.execute("select count(*) from r where amt < 100")) == [3]


class TestHashPartition:
    def test_hash_routing_and_point_prune(self):
        s = Both()
        s.execute("create table h (k bigint primary key, v bigint) partition by hash (k) partitions 4")
        s.execute("insert into h values " + ",".join(f"({i}, {i * 10})" for i in range(20)))
        assert s.call(lambda sess, _: len(sess.catalog.table("h").physical_ids())) == 4
        assert s.call(placed("h", [(7 % 4, 7)])) == [True]
        assert ints(s.execute("select v from h where k = 7")) == [70]
        assert "partitions(p3)" in explained(s, "explain select * from h where k = 7")
        assert ints(s.execute("select count(*) from h")) == [20]


class TestPartitionRestrictions:
    def test_pk_must_cover_partition_column(self):
        with pytest.raises(Exception, match="PRIMARY KEY must include"):
            Both().execute("create table bad (id bigint primary key, amt bigint) "
                           "partition by range (amt) (partition p0 values less than (10))")

    def test_no_secondary_indexes(self):
        s = Both()
        s.execute("create table p (amt bigint primary key, v bigint) "
                  "partition by range (amt) (partition p0 values less than maxvalue)")
        with pytest.raises(Exception, match="partitioned"):
            s.execute("create index iv on p (v)")

    def test_txn_rollback_and_partitioned_dml(self):
        s = Both()
        s.execute("create table p (amt bigint primary key) partition by range (amt) "
                  "(partition p0 values less than (100), partition p1 values less than maxvalue)")
        s.execute("insert into p values (1), (150)")
        s.execute("begin")
        s.execute("insert into p values (2), (160)")
        s.execute("update p set amt = 120 where amt = 1")
        assert ints(s.execute("select amt from p order by amt")) == [2, 120, 150, 160]
        s.execute("rollback")
        assert ints(s.execute("select amt from p order by amt")) == [1, 150]


class TestPartitionReviewRegressions:
    def test_inline_key_rejected(self):
        """An inline KEY does not get round the no-secondary-index rule."""
        with pytest.raises(Exception, match="partitioned"):
            Both().execute("create table bad (a bigint primary key, b bigint, key ib (b)) "
                           "partition by hash (a) partitions 2")

    def test_set_snapshot_in_txn_rejected(self):
        s = Both()
        s.execute("create table st (a bigint primary key)")
        s.execute("begin")
        with pytest.raises(Exception, match="tidb_snapshot"):
            s.execute("set tidb_snapshot = 123")
        s.execute("rollback")

    def test_load_data_routes_partitions(self, tmp_path):
        """LOAD DATA writes rows under the partitions' ids."""
        s = Both()
        s.execute("create table lp (amt bigint primary key) partition by range (amt) "
                  "(partition p0 values less than (100), partition p1 values less than maxvalue)")
        path = tmp_path / "lp.csv"
        path.write_text("5\n150\n250\n")
        s.execute(f"load data infile '{path}' into table lp fields terminated by ','")
        assert ints(s.execute("select amt from lp order by amt")) == [5, 150, 250]
        assert ints(s.execute("select count(*) from lp where amt >= 100")) == [2]
        assert s.call(placed("lp", [(0, 5), (1, 150), (1, 250)])) == [True, True, True]

    def test_backup_restore_partitioned(self, tmp_path):
        """BR round-trips the partition info."""
        s = Both()
        s.execute("create table bp (amt bigint primary key) partition by hash (amt) partitions 3")
        s.execute("insert into bp values (1),(2),(3),(4),(5)")

        def round_trip(sess, pkg):
            br = importlib.import_module(("tidb_tpu" if pkg is JAX else "tidb_tpu_torch") + ".tools.br")
            d = tmp_path / pkg.name
            br.backup(sess.store, sess.catalog, str(d))
            store2, cat2 = pkg.new_store(), pkg.catalog.Catalog()
            br.restore(store2, cat2, str(d))
            s2 = _new_session(pkg, store=store2, catalog=cat2)
            meta = cat2.table("bp")
            # the id allocator rebased above the partitions' ids
            return (int(s2.execute("select count(*) from bp").rows[0][0].val), len(meta.partition.parts),
                    cat2._next_id > max(p.pid for p in meta.partition.parts))

        assert s.call(round_trip) == (5, 3, True)

    def test_point_get_beyond_last_range_partition(self):
        """An out-of-range PK point read is an empty set, not an error."""
        s = Both()
        s.execute("create table pr (a bigint primary key) partition by range (a) (partition p0 values less than (10))")
        s.execute("insert into pr values (5)")
        assert s.execute("select * from pr where a = 50").rows == []
        assert ints(s.execute("select * from pr where a = 5")) == [5]


def test_partition_column_protected_from_alter():
    s = Both()
    s.execute("CREATE TABLE pguard (a INT, b INT) PARTITION BY HASH(a) PARTITIONS 3")
    s.execute("INSERT INTO pguard VALUES (1, 2)")
    with pytest.raises(Exception, match="partition"):
        s.execute("ALTER TABLE pguard DROP COLUMN a")
    # renaming the partition column is allowed and keeps routing intact
    s.execute("ALTER TABLE pguard CHANGE COLUMN a a2 INT")
    s.execute("INSERT INTO pguard VALUES (5, 6)")
    assert s.execute("SELECT count(*) FROM pguard").values() == [[2]]
    assert s.execute("SELECT a2 FROM pguard WHERE a2 = 5").values() == [[5]]
