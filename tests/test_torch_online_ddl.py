"""Online ADD INDEX under concurrent DML through both packages (the
port's counterpart of tests/test_online_ddl.py): the index's state walk
decides what each state's DML writes; failpoints pause the builder between
states while writer threads run DML, and ADMIN CHECK TABLE checks the
index afterwards.

Each scenario runs once in each package, with that package's Session and
its own failpoint registry, and what it returns must agree
(tests/torch_sql_parity.py `both_pkgs`); the reference's hand-computed
answers hold for the port's values.
"""

import threading
import time

import pytest

from torch_sql_parity import PORT, both_pkgs


def _session(pkg, **kw):
    return pkg.sql.Session(**({"device": "cpu"} if pkg is PORT else {}), **kw)


def _mk(pkg, n: int = 60):
    s = _session(pkg)
    s.execute("SET tidb_enable_tpu_mesh = 0")
    s.execute("create table t (id bigint primary key, v bigint)")
    s.execute("insert into t values " + ",".join(f"({i}, {i * 3})" for i in range(n)))
    return s


def ints(res) -> list:
    return [int(x[0].val) for x in res.rows]


class TestOnlineAddIndex:
    def test_states_recorded_and_index_consistent(self):
        def run(pkg):
            s = _mk(pkg)
            s.execute("create index iv on t (v)")
            s.execute("admin check table t")
            return s.catalog.ddl_jobs.jobs[-1].states_seen, s.catalog.table("t").indices[0].state

        assert both_pkgs(run) == (["delete_only", "write_only", "write_reorg", "public"], "public")

    def test_dml_during_each_state_keeps_index_consistent(self):
        """Writer threads INSERT / UPDATE / DELETE while the builder is
        paused in delete_only, write_only and write_reorg; the index agrees
        with the rows afterwards."""
        state_dml = {
            # delete_only: inserts add no entries, deletes drop them
            "ddl_index_delete_only": ["insert into t values (1001, 999)", "delete from t where id = 5"],
            # write_only: DML double-writes entries the backfill will not see
            "ddl_index_write_only": ["insert into t values (1002, 998)", "update t set v = 777 where id = 10"],
            # write_reorg, before the backfill scan: more churn
            "ddl_index_write_reorg": ["insert into t values (1003, 997)", "delete from t where id = 20",
                                      "update t set v = 555 where id = 30"],
        }

        def run(pkg):
            s = _mk(pkg)
            errors: list = []

            def writer(sql):
                w = _session(pkg, store=s.store, catalog=s.catalog)
                for _ in range(40):
                    try:
                        w.execute(sql)
                        return
                    except Exception as exc:  # noqa: BLE001 — the schema-version retry
                        if "schema" in str(exc).lower() or "conflict" in str(exc).lower():
                            time.sleep(0.005)
                            continue
                        errors.append(repr(exc))
                        return
                errors.append(f"retries exhausted: {sql}")

            def run_writers(sqls):
                threads = [threading.Thread(target=writer, args=(q,)) for q in sqls]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()

            for name, sqls in state_dml.items():
                pkg.fp.enable(name, lambda sqls=sqls: run_writers(sqls))
            try:
                s.execute("create index iv on t (v)")
            finally:
                for name in state_dml:
                    pkg.fp.disable(name)
            s.execute("admin check table t")
            return (errors, s.catalog.table("t").indices[0].state, ints(s.execute("select id from t where v = 777")),
                    ints(s.execute("select count(*) from t where v = 999")), ints(s.execute("select count(*) from t")))

        assert both_pkgs(run) == ([], "public", [10], [1], [60 + 3 - 2])

    def test_delete_only_index_invisible_to_dml_writes(self):
        """In delete_only an INSERT adds no index entry (it would dangle
        after a failed build rolls the metadata back)."""

        def run(pkg):
            s = _mk(pkg, 8)
            meta = s.catalog.table("t")
            seen = []

            def probe():
                im = meta.indices[-1]
                _session(pkg, store=s.store, catalog=s.catalog).execute("insert into t values (500, 12345)")
                prefix = pkg.tablecodec.encode_index_key(meta.table_id, im.index_id, [])
                seen.append(sum(1 for _ in s.store.kv.scan(prefix, prefix + b"\xff", s.store.next_ts())))

            pkg.fp.enable("ddl_index_delete_only", probe)
            try:
                s.execute("create index iv on t (v)")
            finally:
                pkg.fp.disable("ddl_index_delete_only")
            s.execute("admin check table t")  # the backfill picked the row up
            return seen, ints(s.execute("select id from t where v = 12345"))

        assert both_pkgs(run) == ([0], [500])

    def test_failed_build_rolls_back_metadata(self):
        def run(pkg):
            s = _mk(pkg, 8)
            s.execute("insert into t values (100, 3)")  # v duplicates id 1's
            with pytest.raises(Exception, match="duplicate"):
                s.execute("create unique index uv on t (v)")
            job = s.catalog.ddl_jobs.jobs[-1]
            return s.catalog.table("t").indices, job.state, "duplicate" in job.error

        assert both_pkgs(run) == ([], "cancelled", True)
