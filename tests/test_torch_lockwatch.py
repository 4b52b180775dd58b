"""The port's runtime lock watcher (tidb_tpu_torch/analysis/lockwatch.py) on
the CPU: the five unit cases of tests/test_vet.py's TestLockwatch, then the
reference's lockwatch storms over the port's code, each under
`tidb_tpu_torch.analysis.lockwatch.watching()` (which guards the port's
`# guarded_by:` classes) with the reference's assertions —
tests/test_vet.py's chaos storm, replication catch-up and PD-vs-dispatch
storms, tests/test_replication.py's leader-transfer storm,
tests/test_topsql.py's, tests/test_cdc.py's, tests/test_columnar.py's,
tests/test_coalesce.py's and tests/test_front_door.py's storms.

A storm's interleaving is its threads', so each is held to invariants (no
lock-order cycle, no unguarded annotated access, no error, every scan's
rows), not to one schedule. The port's own lock nesting is read from the
edges whose two sites lie under tidb_tpu_torch/ (`edges_under`), so a lock
of another package can never stand in for it. The shared plan-cache storm
runs until its readers have hit the cache and a DDL and a sysvar flip have
run (or 30 s pass), where the reference sleeps a fixed 1.5 s.
Tolerance: exact.
"""

import threading
import time

from tidb_tpu_torch.analysis import lockwatch
from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.util import failpoint, metrics


def assert_clean(w):
    rep = w.report()
    assert rep["cycles"] == [], rep["cycles"]
    assert rep["violations"] == [], "\n".join(rep["violations"])
    return rep


# ------------------------------------------------- lockwatch: unit seeds

class _Shared:
    def __init__(self):
        self._mu = threading.Lock()
        self.val = 0


class TestLockwatch:
    def test_seeded_lock_order_cycle_is_reported(self):
        """An ABBA inversion of two locks made in a test frame is a reported cycle. Exact."""
        with lockwatch.watching(guard_tree=False) as w:
            a = threading.Lock()
            b = threading.Lock()
            assert isinstance(a, lockwatch.WatchedLock)  # repo frame: wrapped
            with a:
                with b:
                    pass
            with b:
                with a:  # the ABBA inversion
                    pass
        rep = w.report()
        assert rep["cycles"], rep["edges"]
        cyc = rep["cycles"][0]
        assert any("test_torch_lockwatch.py" in site for site in cyc)

    def test_consistent_order_reports_no_cycle(self):
        """The same nesting order three times reports no cycle. Exact."""
        with lockwatch.watching(guard_tree=False) as w:
            a = threading.Lock()
            b = threading.Lock()
            for _ in range(3):
                with a:
                    with b:
                        pass
        assert w.report()["cycles"] == []

    def test_seeded_unguarded_write_is_reported(self):
        """A second thread's write without the guard is a violation; a guarded one is not. Exact."""
        with lockwatch.watching(guard_tree=False) as w:
            obj = _Shared()
            w.guard_class(_Shared, {"val": "_mu"})
            obj.val = 1  # first (exclusive) thread: exempt

            def racy():
                obj.val = 2  # second thread, guard not held

            t = threading.Thread(target=racy)
            t.start()
            t.join()
            assert w.violations, "unguarded cross-thread write not reported"
            v = w.violations[0]
            assert v.attr == "val" and v.guard == "_mu" and v.mode == "write"

            n = len(w.violations)

            def disciplined():
                with obj._mu:
                    obj.val = 3

            t = threading.Thread(target=disciplined)
            t.start()
            t.join()
            assert len(w.violations) == n  # guarded access stays quiet

    def test_rlock_reentry_adds_no_edge(self):
        """Re-entering an RLock records no edge. Exact."""
        with lockwatch.watching(guard_tree=False) as w:
            r = threading.RLock()
            with r:
                with r:
                    pass
        assert w.report()["edges"] == []

    def test_stdlib_locks_stay_real(self):
        """Locks made by stdlib frames stay real locks. Exact."""
        with lockwatch.watching(guard_tree=False):
            import queue

            q = queue.Queue()  # stdlib frames create its internal locks
            q.put(1)
            assert q.get() == 1
            assert not isinstance(q.mutex, lockwatch.WatchedLock)


def test_guard_tree_guards_only_the_port():
    """`watching()` guards the port's annotated classes (TPUStore's
    `_cop_cache` here) and imports no module of another package. Exact."""
    import sys

    from tidb_tpu_torch.store.store import TPUStore

    before = {m for m in sys.modules if m.split(".")[0] in ("jax", "tidb_tpu")}
    with lockwatch.watching() as w:
        assert isinstance(TPUStore.__dict__["_cop_cache"], lockwatch._GuardedAttr)
        guarded = {cls.__module__.split(".")[0] for cls, *_ in w._patched}
    assert guarded == {"tidb_tpu_torch"}
    assert "_cop_cache" not in TPUStore.__dict__  # uninstalled on exit
    after = {m for m in sys.modules if m.split(".")[0] in ("jax", "tidb_tpu")}
    assert after == before


# ------------------------------------ lockwatch over the port's workloads

def test_chaos_storm_under_lockwatch():
    """The seeded chaos storm — store outage, busy storm, heartbeat
    blackout, not-leader flaps, operator timeouts — under the runtime
    detector: zero lock-order cycles and zero unguarded annotated accesses,
    while keeping its own invariants. Tolerance: invariants only."""
    from tidb_tpu_torch.tools.chaos import run_chaos

    with lockwatch.watching() as w:
        report = run_chaos(seed=11, statements=40, device="cpu")
    assert_clean(w)
    assert report["wrong_results"] == [] and report["untyped_errors"] == []
    # the detector actually observed the engine's locking (not a no-op run)
    assert w.edges_under(), "lockwatch saw no lock nesting of the port at all"


def test_replication_catchup_under_lockwatch():
    """The replication catch-up path under the runtime detector — leader
    transfers, the resolved-ts catch-up driver and a follower-read dispatch
    pool racing while writes land and the apply-lag failpoint wedges and
    unwedges followers. Zero cycles, zero unguarded annotated accesses,
    scans never lose rows, and once writers stop and the wedge lifts,
    catch-up drains every follower's safe_ts lag to zero. Invariants only."""
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.distsql.dispatch import KVRequest, full_table_ranges, select
    from tidb_tpu_torch.exec.dag import ColumnInfo, DAGRequest, TableScan
    from tidb_tpu_torch.store import TPUStore
    from tidb_tpu_torch.types import Datum, new_longlong

    TID, rows, regions = 37, 120, 6
    with lockwatch.watching() as w:
        store = TPUStore(device="cpu")
        for h in range(rows):
            store.put_row(TID, h, [1], [Datum.i64(h)], ts=10)
        for i in range(1, regions):
            store.cluster.split(tablecodec.encode_row_key(TID, i * rows // regions))
        store.cluster.set_stores(4)
        store.cluster.scatter()
        dag = DAGRequest((TableScan(TID, (ColumnInfo(1, new_longlong()),)),),
                         output_offsets=(0,))
        stop = threading.Event()
        errors: list = []
        counts: list = []

        def scanner():
            # snapshot at 50: the seed rows (ts=10) are visible, the
            # writer's versions (TSO >= 100) are not — every scan must
            # return exactly the seed rows, through transfers, wedged
            # followers and DataIsNotReady fallbacks
            while not stop.is_set():
                try:
                    res = select(store, KVRequest(
                        dag, full_table_ranges(TID), 50, replica_read="follower"))
                    counts.append(sum(c.num_rows() for c in res.chunks))
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def writer():
            h = rows
            while not stop.is_set():
                store.put_row(TID, h, [1], [Datum.i64(h)], ts=store.next_ts())
                h += 1

        def transferrer():
            k = 0
            while not stop.is_set():
                for r in store.cluster.regions():
                    folls = store.cluster.followers_of(r.region_id)
                    if folls:
                        store.cluster.transfer_leader(
                            r.region_id, folls[k % len(folls)])
                k += 1

        def catcher_up():
            while not stop.is_set():
                store.replication.catch_up()

        threads = [threading.Thread(target=t, daemon=True)
                   for t in (scanner, scanner, writer, transferrer, catcher_up)]
        for t in threads:
            t.start()
        # phase 1: wedge one follower's apply loop (lag accumulates)
        with failpoint.enabled("replica/apply-lag", {1}):
            time.sleep(0.6)
        # phase 2: wedge lifted — the catch-up thread drains the lag
        time.sleep(0.6)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        # quiesced: a few explicit catch-up rounds must zero every lag
        for _ in range(5):
            store.replication.catch_up()
        lags = store.replication.lag_view()
    assert_clean(w)
    assert not errors, errors
    assert counts and all(c == rows for c in counts)
    assert all(v == 0 for v in lags.values()), lags
    assert w.edges_under(), "lockwatch saw no lock nesting of the port at all"


def test_pd_concurrent_dispatch_under_lockwatch():
    """PD tick thread vs dispatch pool under the detector: splits, moves
    and failpoint storms while scans run — no cycles, no violations. Invariants only."""
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.distsql.dispatch import KVRequest, full_table_ranges, select
    from tidb_tpu_torch.exec.dag import ColumnInfo, DAGRequest, TableScan
    from tidb_tpu_torch.store import TPUStore
    from tidb_tpu_torch.types import Datum, new_longlong

    TID, rows = 31, 160
    with lockwatch.watching() as w:
        store = TPUStore(device="cpu")
        for h in range(rows):
            store.put_row(TID, h, [1], [Datum.i64(h)], ts=10)
        for i in range(1, 8):
            store.cluster.split(tablecodec.encode_row_key(TID, i * rows // 8))
        store.cluster.set_stores(4)
        store.cluster.scatter()
        dag = DAGRequest((TableScan(TID, (ColumnInfo(1, new_longlong()),)),),
                         output_offsets=(0,))
        stop = threading.Event()
        errors: list = []
        counts: list = []

        def scanner():
            while not stop.is_set():
                try:
                    res = select(store, KVRequest(dag, full_table_ranges(TID), 100))
                    counts.append(sum(c.num_rows() for c in res.chunks))
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=scanner, daemon=True) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            with failpoint.enabled("pd/heartbeat-lost"), \
                 failpoint.enabled("pd/operator-timeout"):
                for _ in range(4):
                    store.pd.tick()
            for _ in range(6):
                store.pd.tick()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
    assert errors == []
    assert counts and all(c == rows for c in counts)
    assert_clean(w)
    assert w.edges_under()


def test_leader_transfer_storm_under_lockwatch():
    """Leader transfers racing follower-read dispatch AND the PD tick under
    the runtime lockset detector — zero lock-order cycles, zero unguarded
    annotated accesses, and every scan returns the full row count (a
    transfer mid-scan costs at most a NotLeader hint retry, never rows). Invariants only."""
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.distsql.dispatch import KVRequest, full_table_ranges, select
    from tidb_tpu_torch.exec.dag import ColumnInfo, DAGRequest, TableScan
    from tidb_tpu_torch.store import TPUStore
    from tidb_tpu_torch.types import Datum, new_longlong

    TID, rows, regions = 23, 160, 8
    with lockwatch.watching() as w:
        store = TPUStore(device="cpu")
        for h in range(rows):
            store.put_row(TID, h, [1], [Datum.i64(h)], ts=10)
        for i in range(1, regions):
            store.cluster.split(tablecodec.encode_row_key(TID, i * rows // regions))
        store.cluster.set_stores(4)
        store.cluster.scatter()
        dag = DAGRequest((TableScan(TID, (ColumnInfo(1, new_longlong()),)),),
                         output_offsets=(0,))
        stop = threading.Event()
        errors: list = []
        counts: list = []

        def scanner(mode):
            while not stop.is_set():
                try:
                    res = select(store, KVRequest(
                        dag, full_table_ranges(TID), 100, replica_read=mode))
                    counts.append(sum(c.num_rows() for c in res.chunks))
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def transferrer():
            k = 0
            while not stop.is_set():
                for r in store.cluster.regions():
                    folls = store.cluster.followers_of(r.region_id)
                    if folls:
                        store.cluster.transfer_leader(
                            r.region_id, folls[k % len(folls)])
                k += 1
                store.pd.tick()

        threads = [threading.Thread(target=scanner, args=(m,), daemon=True)
                   for m in ("follower", "closest-replica", "leader")]
        threads.append(threading.Thread(target=transferrer, daemon=True))
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert_clean(w)
    assert not errors, errors
    assert counts and all(c == rows for c in counts)
    assert w.edges_under(), "lockwatch saw no lock nesting of the port at all"


def test_topsql_lockwatch_storm():
    """Window rotation + 8 recording sessions + the PD tick's reporter
    phase, all racing under the runtime lockset detector: zero lock-order
    cycles, zero unguarded annotated accesses — the collector and tag
    locks really are leaves. Invariants only."""
    from tidb_tpu_torch.topsql import COLLECTOR

    COLLECTOR.reset()
    with lockwatch.watching() as w:
        src = Session(device="cpu")
        src.execute("create table t (a bigint primary key, b bigint)")
        src.execute("insert into t values " + ",".join(
            f"({i},{i * 10})" for i in range(32)))
        gate = src.store.admission
        gate.configure(max_inflight=6, cost_classed=True)
        stop = threading.Event()
        errors: list = []

        def runner(seed):
            sess = Session(store=src.store, catalog=src.catalog)
            i = seed
            while not stop.is_set():
                try:
                    sess.execute(f"select b from t where a = {i % 32}")
                    sess.execute(f"select sum(b) from t where a > {i % 8}")
                    i += 1
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def rotator():
            while not stop.is_set():
                try:
                    COLLECTOR.rotate(force=True)
                    COLLECTOR.windows_view()
                    time.sleep(0.005)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def ticker():
            pd = getattr(src.store, "pd", None)
            while not stop.is_set():
                try:
                    if pd is not None:
                        pd.tick()
                    time.sleep(0.01)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=runner, args=(i * 5,), daemon=True)
                   for i in range(8)]
        threads.append(threading.Thread(target=rotator, daemon=True))
        threads.append(threading.Thread(target=ticker, daemon=True))
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        gate.configure(max_inflight=0, cost_classed=False)
    assert_clean(w)
    assert not errors, errors
    assert metrics.TOPSQL_WINDOWS_SEALED.value > 0


def test_cdc_lockwatch_storm():
    """Changefeed ticks vs the PD tick vs a writer vs region splits under
    the runtime lockset detector: zero lock-order cycles, zero unguarded
    annotated accesses, and the sink's ordering oracle stays clean. Invariants only."""
    from tidb_tpu_torch.cdc import MemorySink
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.tools.chaos import CheckingSink

    with lockwatch.watching() as w:
        src = Session(device="cpu")
        src.execute("CREATE TABLE lw (id BIGINT PRIMARY KEY, v BIGINT)")
        src.execute("INSERT INTO lw VALUES " + ",".join(f"({i},{i})" for i in range(64)))
        src.store.cluster.set_stores(4)
        src.store.cluster.scatter()
        tid = src.catalog.table("lw").table_id
        sink = CheckingSink(MemorySink())
        src.store.cdc.create("lw", sink, src.catalog, start_ts=0)
        stop = threading.Event()
        errors: list = []

        def writer():
            w_sess = Session(store=src.store, catalog=src.catalog)
            k = 1000
            while not stop.is_set():
                try:
                    w_sess.execute(f"INSERT INTO lw VALUES ({k}, {k})")
                    w_sess.execute(f"UPDATE lw SET v = v + 1 WHERE id = {k - 1000}")
                    k += 1
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def ticker():
            while not stop.is_set():
                try:
                    src.store.pd.tick()  # includes the pd.cdc phase
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def splitter():
            i = 0
            while not stop.is_set():
                try:
                    src.store.cluster.split(
                        tablecodec.encode_row_key(tid, (i * 7) % 64))
                    regions = src.store.cluster.regions()
                    if len(regions) > 6:
                        src.store.cluster.merge(regions[0].region_id)
                    i += 1
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (writer, ticker, splitter)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        for _ in range(4):
            src.store.cdc.tick()  # drain after the storm
    assert_clean(w)
    assert not errors, errors
    assert sink.violations == [], sink.violations
    assert sink.events > 0
    assert w.edges_under(), "lockwatch saw no lock nesting of the port at all"


def test_columnar_lockwatch_storm():
    """Compaction (pd tick) vs the apply path (writers) vs engine-routed
    scanners vs region splits under the runtime lockset detector: zero
    lock-order cycles, zero unguarded annotated accesses. Invariants only."""
    from tidb_tpu_torch.codec import tablecodec

    with lockwatch.watching() as w:
        src = Session(device="cpu")
        src.execute("CREATE TABLE lw (id BIGINT PRIMARY KEY, v BIGINT, g BIGINT)")
        src.execute("INSERT INTO lw VALUES " + ",".join(
            f"({i},{i},{i % 4})" for i in range(64)))
        src.store.cluster.set_stores(4)
        src.store.cluster.scatter()
        src.execute("ALTER TABLE lw SET COLUMNAR REPLICA 1")
        src.store.pd.tick()
        tid = src.catalog.table("lw").table_id
        stop = threading.Event()
        errors: list = []

        def writer():
            w_sess = Session(store=src.store, catalog=src.catalog)
            k = 1000
            while not stop.is_set():
                try:
                    w_sess.execute(f"INSERT INTO lw VALUES ({k}, {k}, {k % 4})")
                    w_sess.execute(f"UPDATE lw SET v = v + 1 WHERE id = {k - 1000}")
                    k += 1
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def ticker():
            while not stop.is_set():
                try:
                    src.store.pd.tick()  # pd.cdc + pd.columnar phases
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def scanner():
            r_sess = Session(store=src.store, catalog=src.catalog)
            while not stop.is_set():
                try:
                    r_sess.execute("SELECT g, count(*), sum(v) FROM lw GROUP BY g")
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def splitter():
            i = 0
            while not stop.is_set():
                try:
                    src.store.cluster.split(
                        tablecodec.encode_row_key(tid, (i * 7) % 64))
                    regions = src.store.cluster.regions()
                    if len(regions) > 6:
                        src.store.cluster.merge(regions[0].region_id)
                    i += 1
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (writer, ticker, scanner, scanner, splitter)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        for _ in range(4):
            src.store.pd.tick()  # drain
    assert_clean(w)
    assert not errors, errors
    assert w.edges_under(), "lockwatch saw no lock nesting of the port at all"


def test_coalesce_lockwatch_storm():
    """Coalesced readers + group-committing writers + the PD tick under
    the runtime lockset detector: the coalescer mutex is a leaf, so zero
    lock-order cycles and zero guarded-access violations. Invariants only."""
    with lockwatch.watching() as w:
        s = Session(device="cpu")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, k VARCHAR(20))")
        s.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{i * 10},'x{i}')" for i in range(32)))
        s.execute("SELECT v FROM t WHERE id = 1")  # pointget entry
        stop = threading.Event()
        errors = []

        def clone():
            x = Session(store=s.store, catalog=s.catalog)
            x.execute("SET tidb_tpu_enable_coalesce = ON")
            x.execute("SET tidb_tpu_coalesce_wait_us = 2000")
            return x

        def reader(i):
            sess = clone()
            j = 0
            while not stop.is_set():
                try:
                    sess.execute(f"SELECT v FROM t WHERE id = {(i + j) % 32}")
                    j += 1
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def writer(i):
            sess = clone()
            j = 0
            while not stop.is_set():
                try:
                    sess.execute(
                        f"UPDATE t SET v = v + 1 WHERE id = {(i + j) % 32}")
                    j += 1
                except SQLError:
                    pass  # cross-window write conflicts are the race's
                except Exception as exc:  # noqa: BLE001 — typed surface
                    errors.append(exc)
                    return

        def ticker():
            while not stop.is_set():
                try:
                    s.store.pd.tick()
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(3)]
        threads += [threading.Thread(target=writer, args=(i,), daemon=True)
                    for i in range(2)]
        threads.append(threading.Thread(target=ticker, daemon=True))
        for t in threads:
            t.start()
        time.sleep(1.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert_clean(w)
    assert not errors, errors


PLAN_CACHE_STORM_DEADLINE = 30.0  # seconds the plan-cache storm may run


def test_shared_plan_cache_lockwatch_storm():
    """Concurrent sessions of ONE catalog hammering one shared plan cache
    (hits, installs, invalidating DDL, sysvar flips) under the runtime
    lockset detector: zero lock-order cycles, zero unguarded annotated
    accesses, and the cache actually serves hits. The threads run until the
    readers have hit the cache and a DDL and a sysvar flip have run, or
    PLAN_CACHE_STORM_DEADLINE seconds pass. Invariants only."""
    def hits():
        return metrics.PLAN_CACHE_HITS.value

    with lockwatch.watching() as w:
        src = Session(device="cpu")
        src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, "
                    "k VARCHAR(20), KEY iv (v))")
        src.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{i * 10},'x{i}')" for i in range(32)))
        stop = threading.Event()
        errors: list = []
        done = {"ddl": 0, "flip": 0}
        h0 = hits()

        def reader(seed):
            sess = Session(store=src.store, catalog=src.catalog)
            i = seed
            while not stop.is_set():
                try:
                    sess.execute(f"select v from t where id = {i % 32}")
                    sess.execute(f"select k from t where v = {(i % 32) * 10}")
                    i += 1
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def ddler():
            sess = Session(store=src.store, catalog=src.catalog)
            n = 0
            while not stop.is_set():
                try:
                    sess.execute(f"alter table t add column w{n} bigint")
                    n += 1
                    done["ddl"] += 1
                    time.sleep(0.02)
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        def sysvar_flipper():
            sess = Session(store=src.store, catalog=src.catalog)
            while not stop.is_set():
                try:
                    sess.execute("set global tidb_plan_cache_size = 64")
                    sess.execute("set global tidb_plan_cache_size = 512")
                    done["flip"] += 1
                    time.sleep(0.01)
                except SQLError:
                    pass
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=reader, args=(i * 7,), daemon=True)
                   for i in range(3)]
        threads.append(threading.Thread(target=ddler, daemon=True))
        threads.append(threading.Thread(target=sysvar_flipper, daemon=True))
        for t in threads:
            t.start()
        deadline = time.monotonic() + PLAN_CACHE_STORM_DEADLINE
        while time.monotonic() < deadline and not errors:
            if hits() > h0 and done["ddl"] and done["flip"]:
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert_clean(w)
    assert not errors, errors
    assert hits() > h0, "storm never hit the shared cache"
