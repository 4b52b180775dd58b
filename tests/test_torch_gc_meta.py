"""MVCC GC and the catalog's persistence in the m-prefix key space
through both packages (the port's counterpart of tests/test_gc_meta.py).

Each statement runs on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py
`Both`); the outcomes must agree, and the reference's hand-computed
answers hold for the port's values. A "restart" is a new session of each
package over that package's store; versions are read from each store.
"""

import time

import pytest

from torch_sql_parity import JAX, PORT, Both


def restart(b: Both, catalog: bool = False) -> Both:
    """A new session of each package over the same store (and, with
    catalog=True, the same catalog)."""
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        old = b.pair[name][b.on]
        kw = {"device": "cpu"} if pkg is PORT else {}
        s = pkg.sql.Session(store=old.store, catalog=old.catalog if catalog else None, **kw)
        s.execute("SET tidb_enable_tpu_mesh = 0")
        out[name] = {"s": s}
    return Both(out)


def versions(table: str, handle: int):
    """fn(session, pkg): the row key's version timestamps."""

    def run(s, pkg):
        key = pkg.tablecodec.encode_row_key(s.catalog.table(table).table_id, handle)
        return [ts for ts, _ in s.store.kv._data[key]]

    return run


def scalar(res):
    return int(res.rows[0][0].val)


class TestMVCCGC:
    def test_version_count_bounded_under_update_loop(self):
        s = Both()
        s.execute("create table g (id bigint primary key, v bigint)")
        s.execute("insert into g values (1, 0)")
        for i in range(50):
            s.execute(f"update g set v = {i} where id = 1")
        assert len(s.call(versions("g", 1))) == 51
        removed = s.call(lambda sess, _: sess.store.run_gc())
        assert removed >= 50
        assert len(s.call(versions("g", 1))) == 1
        assert scalar(s.execute("select v from g")) == 49  # reads after GC see the latest value

    def test_tombstones_fully_collected(self):
        s = Both()
        s.execute("create table g2 (id bigint primary key)")
        s.execute("insert into g2 values (1), (2), (3)")
        s.execute("delete from g2 where id >= 2")

        def collect(sess, _pkg):
            before = len(sess.store.kv)
            sess.store.run_gc()
            return before, len(sess.store.kv)

        before, after = s.call(collect)
        assert after < before  # deleted keys vanish entirely
        assert len(s.execute("select * from g2").rows) == 1

    def test_safepoint_clamped_below_active_txn(self):
        s = Both()
        s.execute("create table g3 (id bigint primary key, v bigint)")
        s.execute("insert into g3 values (1, 10)")
        s.execute("begin")
        s.execute("update g3 set v = 11 where id = 1")  # the lock is held

        def gc_under_txn(sess, pkg):
            start = sess.txn.start_ts
            sess.store.run_gc()  # must not collect under the open txn
            # the version from before the txn survives: the txn may still read it
            return any(ts <= start for ts in versions("g3", 1)(sess, pkg))

        assert s.call(gc_under_txn)
        s.execute("commit")

    def test_gc_worker_ticks(self):
        s = Both()
        s.execute("create table g4 (id bigint primary key, v bigint)")
        s.execute("insert into g4 values (1, 0)")
        for i in range(10):
            s.execute(f"update g4 set v = {i} where id = 1")

        def tick(sess, pkg):
            w = pkg.background.GCWorker(sess.store, interval=0.05).start()
            try:
                deadline = time.time() + 3
                while w.runs == 0 and time.time() < deadline:
                    time.sleep(0.05)
            finally:
                w.stop()
            return w.runs >= 1 and w.removed_total >= 10

        assert s.call(tick)


class TestCatalogPersistence:
    def test_restart_recovers_schema_and_data(self):
        s1 = Both()
        s1.execute("create table p (id bigint primary key, name varchar(20), key ik (name))")
        s1.execute("insert into p values (1, 'alpha'), (2, 'beta')")
        s2 = restart(s1)  # a new session over the same store, no catalog
        rows = sorted((int(r[0].val), str(r[1].val)) for r in s2.execute("select id, name from p").rows)
        assert rows == [(1, "alpha"), (2, "beta")]
        # the schema's details survive: indices, handles, DML
        s2.execute("insert into p values (3, 'gamma')")
        assert len(s2.execute("select * from p where name = 'beta'").rows) == 1

    def test_drop_and_alter_survive_restart(self):
        s1 = Both()
        s1.execute("create table p1 (id bigint primary key)")
        s1.execute("create table p2 (id bigint primary key)")
        s1.execute("drop table p1")
        s1.execute("alter table p2 add column extra bigint")
        s2 = restart(s1)
        assert s2.call(lambda sess, _: "p1" not in sess.catalog.tables())
        s2.execute("insert into p2 values (1, 42)")
        assert scalar(s2.execute("select extra from p2")) == 42

    def test_fresh_store_still_boots(self):
        s = Both({name: {"s": pkg.new_session(pkg.new_store())} for name, pkg in (("jax", JAX), ("port", PORT))})
        s.execute("create table q (a bigint)")
        s.execute("insert into q values (5)")
        assert scalar(s.execute("select a from q")) == 5


class TestReviewRegressions:
    def test_read_only_txn_snapshot_survives_gc(self):
        """A lock-free open txn pins its snapshot against GC."""
        s1 = Both()
        s1.execute("create table rr (id bigint primary key, v bigint)")
        s1.execute("insert into rr values (1, 10)")
        s2 = restart(s1, catalog=True)
        s2.execute("begin")
        assert scalar(s2.execute("select v from rr where id = 1")) == 10
        s1.execute("update rr set v = 99 where id = 1")
        s1.call(lambda sess, _: sess.store.run_gc())
        assert scalar(s2.execute("select v from rr where id = 1")) == 10  # repeatable read
        s2.execute("commit")
        s1.call(lambda sess, _: sess.store.run_gc())
        assert scalar(s2.execute("select v from rr where id = 1")) == 99

    def test_create_index_survives_restart(self):
        s1 = Both()
        s1.execute("create table ci (id bigint primary key, k bigint)")
        s1.execute("create unique index uk on ci (k)")
        s1.execute("insert into ci values (1, 7)")
        s2 = restart(s1)
        assert s2.call(lambda sess, _: any(i.name == "uk" for i in sess.catalog.table("ci").indices))
        with pytest.raises(Exception, match="duplicate"):
            s2.execute("insert into ci values (2, 7)")

    def test_handle_allocator_rebased_after_restart(self):
        s1 = Both()
        s1.execute("create table ha (a bigint)")  # hidden row id handles
        s1.execute("insert into ha values (10), (20), (30)")
        s2 = restart(s1)
        s2.execute("insert into ha values (40)")  # must not collide
        assert len(s2.execute("select * from ha").rows) == 4


class TestDefaultsPersist:
    def test_column_default_survives_restart(self):
        s1 = Both()
        s1.execute("create table dd (id bigint primary key, v bigint default 5, ts datetime default current_timestamp)")
        s2 = restart(s1)
        s2.execute("insert into dd (id) values (1)")
        assert scalar(s2.execute("select v from dd where id = 1")) == 5


class TestAutocommitReadPin:
    def test_autocommit_read_ts_pins_snapshot_against_gc(self):
        """A GC tick between an autocommit read's TSO draw and its reads
        must not collect the version visible at the read ts."""
        s = Both()
        s.execute("create table gp (id bigint primary key, v bigint)")
        s.execute("insert into gp values (1, 10)")

        def pinned(sess, pkg):
            ts = sess._pin_read_ts()  # the statement's ts draw
            sess.execute("update gp set v = 11 where id = 1")  # a newer version lands
            sess.store.run_gc()  # a GC tick mid-statement
            survived = any(vts <= ts for vts in versions("gp", 1)(sess, pkg))
            row = sess._read_row(sess.catalog.table("gp"), 1, ts)
            sess._unpin_read_ts(ts)
            sess.store.run_gc()  # unpinned: the old version may go
            return survived, int(row[1].val), len(versions("gp", 1)(sess, pkg))

        assert s.call(pinned) == (True, 10, 1)
