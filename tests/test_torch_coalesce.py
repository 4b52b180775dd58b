"""The port's cross-session coalescer (tidb_tpu_torch/server/coalesce.py,
built by every port TPUStore) on the CPU: the cases of
tests/test_coalesce.py over port `Session(device="cpu")`s but
test_coalesce_lockwatch_storm, which runs under the port's
tidb_tpu_torch/analysis/lockwatch.py in tests/test_torch_lockwatch.py —
concurrent plan-cache-hit point gets batched into
one `batch_coprocessor` call (one region-batched launch), autocommit
writes folded into group commits, the DML point-write plan-cache tier and
the shared cross-catalog tier. Every coalesced result must equal its
uncoalesced oracle; every fault falls out to the single path as a typed,
counted fallback. The interleaving is the threads', so the concurrent
cases hold invariants (each lane's answer, launches saved, nothing lost),
not one schedule. Then parity: coalesced reads on the port give the rows
the JAX package's uncoalesced session gives over the same data.
Tolerance: exact.
"""

import sys
import threading
import time

import pytest

from tidb_tpu_torch.sql.session import Session, SQLError
from tidb_tpu_torch.store.txn import TxnError
from tidb_tpu_torch.util import failpoint, metrics


def make_store(rows=16):
    s = Session(device="cpu")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, k VARCHAR(20))")
    if rows:
        s.execute("INSERT INTO t VALUES " + ",".join(
            f"({i},{i * 10},'x{i}')" for i in range(rows)))
    return s


def clone(s, wait_us=20000):
    """A concurrent session over the same store/catalog, coalescing ON
    with a window wide enough that barrier-released lanes reliably meet."""
    x = Session(store=s.store, catalog=s.catalog)
    x.execute("SET tidb_tpu_enable_coalesce = ON")
    x.execute(f"SET tidb_tpu_coalesce_wait_us = {wait_us}")
    return x


def same_rows(a, b):
    assert len(a) == len(b), (a, b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for da, db in zip(ra, rb):
            assert da.kind == db.kind and da.val == db.val, (da, db)


def fallbacks(reason):
    return metrics.COALESCE_FALLBACKS.labels(reason).value


# ------------------------------------------------- coalesced reads

def test_coalesced_reads_match_uncoalesced_oracle():
    """N sessions × mixed point statements, concurrent with coalescing
    ON, byte-equal to a cold parse+plan oracle session."""
    s = make_store(rows=32)
    s.execute("CREATE TABLE u (id BIGINT PRIMARY KEY, w BIGINT)")
    s.execute("INSERT INTO u VALUES " + ",".join(
        f"({i},{i * 7})" for i in range(32)))
    oracle = Session(store=s.store, catalog=s.catalog)
    oracle.execute("SET tidb_enable_plan_cache = OFF")

    def stmts(i):
        return [
            f"SELECT v FROM t WHERE id = {i}",
            f"SELECT id, v FROM t WHERE id IN ({i}, {i + 8}, {i + 16})",
            f"SELECT k FROM t WHERE id = {i} AND v > 1",
            f"SELECT w FROM u WHERE id = {i}",
            f"SELECT v FROM t WHERE id = {1000 + i}",  # no such row
        ]

    # warm the digests so the concurrent wave rides the pointget tier
    for sql in stmts(1):
        s.execute(sql)

    n, rounds = 6, 3
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    got = [[] for _ in range(n)]
    errors = []

    def run(i):
        try:
            for _r in range(rounds):
                barrier.wait()
                for sql in stmts(i):
                    got[i].append((sql, sessions[i].execute(sql).rows))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    b0 = metrics.COALESCE_BATCHES.value
    l0 = metrics.COALESCE_LANES.labels("read").value
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for i in range(n):
        assert len(got[i]) == rounds * 5
        for sql, rows in got[i]:
            same_rows(rows, oracle.execute(sql).rows)
    assert metrics.COALESCE_BATCHES.value > b0
    # nearly every statement parked in some window (a handful may ride
    # the single path if its session's window raced shut)
    assert metrics.COALESCE_LANES.labels("read").value - l0 >= n * rounds


def test_coalesced_reads_save_launches():
    """Same-table lanes in one window share a DAG fingerprint, so the
    batch stacks them into one vmapped launch — launches-saved counts."""
    s = make_store(rows=32)
    s.execute("SELECT v FROM t WHERE id = 1")  # install pointget entry
    n = 8
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    sv0 = metrics.COALESCE_LAUNCHES_SAVED.value

    def run(i):
        barrier.wait()
        assert sessions[i].execute(
            f"SELECT v FROM t WHERE id = {i}").rows[0][0].val == i * 10

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert metrics.COALESCE_LAUNCHES_SAVED.value > sv0


def test_fault_lane_falls_out_mid_batch():
    """A region fault on one lane's cop request mid-batch: that lane
    falls out (typed, counted) and its session answers through the
    single path — rows still byte-correct, other lanes unaffected."""
    s = make_store(rows=16)
    s.execute("SELECT v FROM t WHERE id = 1")
    n = 4
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    out = [None] * n
    f0 = fallbacks("fault_lane")

    def run(i):
        barrier.wait()
        out[i] = sessions[i].execute(f"SELECT v FROM t WHERE id = {i}").rows

    with failpoint.enabled("cop-region-error", 1):
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    for i in range(n):
        assert out[i][0][0].val == i * 10
    assert fallbacks("fault_lane") > f0


def test_window_stall_follower_withdraws():
    """coalesce/window-stall wedges the leader past the follower's
    patience: the follower withdraws its unclaimed lane (typed
    window_stall fall-out → single path), the leader still answers its
    own lane after the hold."""
    s = make_store()
    meta = s.catalog.table("t")
    co = s.store.coalescer
    results = {}
    f0 = fallbacks("window_stall")

    def call(name, delay):
        if delay:
            time.sleep(delay)
        results[name] = co.point_get(meta, [1], wait_us=100_000, max_lanes=8)

    with failpoint.enabled("coalesce/window-stall", 0.8):
        t1 = threading.Thread(target=call, args=("leader", 0))
        t2 = threading.Thread(target=call, args=("follower", 0.02))
        t1.start()
        t2.start()
        t1.join(timeout=30)
        t2.join(timeout=30)
    vals = list(results.values())
    assert sum(v is None for v in vals) == 1  # the stalled-out lane
    served = next(v for v in vals if v is not None)
    assert served[1][1].val == 10  # row for handle 1: [id, v, k]
    assert fallbacks("window_stall") > f0


def test_flush_lost_read_lanes_fall_back():
    """coalesce/flush-lost loses a window's flush before any lane is
    answered: every lane falls out (counted) and re-runs its single
    path — no statement lost, rows byte-correct."""
    s = make_store(rows=16)
    s.execute("SELECT v FROM t WHERE id = 1")
    n = 4
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    out = [None] * n
    f0 = fallbacks("flush_lost")

    def run(i):
        barrier.wait()
        out[i] = sessions[i].execute(f"SELECT v FROM t WHERE id = {i}").rows

    with failpoint.enabled("coalesce/flush-lost", 1):
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    for i in range(n):
        assert out[i][0][0].val == i * 10
    assert fallbacks("flush_lost") > f0


# ------------------------------------------------- group commit

def test_group_commit_concurrent_writes_apply():
    """Concurrent autocommit single-row writes coalesce into group
    commits: every write lands, distinct sessions' lanes share windows
    (group commits counted), final state equals the serial outcome."""
    s = make_store(rows=8)
    n, rounds = 6, 4
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    errors = []

    def run(i):
        try:
            for _r in range(rounds):
                barrier.wait()
                sessions[i].execute(f"UPDATE t SET v = v + 1 WHERE id = {i}")
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    g0 = metrics.COALESCE_GROUP_COMMITS.value
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for i in range(n):
        got = s.execute(f"SELECT v FROM t WHERE id = {i}").rows[0][0].val
        assert got == i * 10 + rounds
    assert metrics.COALESCE_GROUP_COMMITS.value > g0


def test_group_commit_saves_proposals():
    """A multi-lane write window folds into one quorum proposal per
    (region, window): proposals-saved counts the fold."""
    s = make_store(rows=8)
    n = 6
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        sessions[i].execute(f"UPDATE t SET v = {i + 100} WHERE id = {i}")

    p0 = metrics.COALESCE_GROUP_PROPOSALS_SAVED.value
    for _attempt in range(5):  # barrier makes a shared window near-certain
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if metrics.COALESCE_GROUP_PROPOSALS_SAVED.value > p0:
            break
    assert metrics.COALESCE_GROUP_PROPOSALS_SAVED.value > p0


def test_commit_group_engine_semantics():
    """TxnEngine.commit_group: one result per lane — ascending commit ts
    for committed lanes, a TxnError instance for an intra-window key
    conflict (its locks released, the window standing), None for an
    empty lane."""
    from tidb_tpu_torch.codec import tablecodec

    s = make_store(rows=4)
    st = s.store
    tid = s.catalog.table("t").table_id
    k1 = tablecodec.encode_row_key(tid, 101)
    k2 = tablecodec.encode_row_key(tid, 102)
    ts1, ts2, ts3 = st.next_ts(), st.next_ts(), st.next_ts()
    res = st.txn.commit_group(
        [({k1: b"a"}, ts1), ({k1: b"b"}, ts2), ({k2: b"c"}, ts3)],
        st.next_ts,
    )
    assert isinstance(res[0], int) and isinstance(res[2], int)
    assert res[2] > res[0]
    assert isinstance(res[1], TxnError)
    now = st.next_ts()
    assert st.kv.get(k1, now) == b"a"
    assert st.kv.get(k2, now) == b"c"
    # the refused lane released its locks: a follow-up commit succeeds
    res2 = st.txn.commit_group([({k1: b"b2"}, st.next_ts())], st.next_ts)
    assert isinstance(res2[0], int)
    assert st.kv.get(k1, st.next_ts()) == b"b2"
    # empty lane: nothing staged, nothing reported
    assert st.txn.commit_group([({}, st.next_ts())], st.next_ts) == [None]


def test_group_commit_lane_error_raises_typed():
    """A lane the engine refuses with a typed non-conflict error (quorum
    lost) raises in that lane's session — falling back would fail
    identically, so the coalescer must not retry it."""
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.store import QuorumLostError

    s = make_store(rows=4)
    st = s.store
    tid = s.catalog.table("t").table_id
    k = tablecodec.encode_row_key(tid, 300)
    orig = st.txn._pre_apply

    def refuse(keys):
        raise QuorumLostError(1, 1, 2)

    st.txn._pre_apply = refuse
    try:
        with pytest.raises(QuorumLostError):
            st.coalescer.group_commit({k: b"z"}, st.next_ts(),
                                      wait_us=1000, max_lanes=4)
    finally:
        st.txn._pre_apply = orig


def test_flush_lost_write_lanes_fall_back():
    """coalesce/flush-lost on a write window: lanes fall out and commit
    through the single path — the write still lands exactly once."""
    s = make_store(rows=8)
    n = 4
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    errors = []
    f0 = fallbacks("flush_lost")

    def run(i):
        try:
            barrier.wait()
            sessions[i].execute(f"UPDATE t SET v = {i + 500} WHERE id = {i}")
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    with failpoint.enabled("coalesce/flush-lost", 1):
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    for i in range(n):
        assert s.execute(
            f"SELECT v FROM t WHERE id = {i}").rows[0][0].val == i + 500
    assert fallbacks("flush_lost") > f0


def test_group_commit_cdc_per_key_order():
    """Group-committed windows must replicate in commit-ts order: the
    changefeed's ordering oracle (per-key strictly increasing commit ts,
    monotone resolved marks) stays clean under concurrent coalesced
    writers."""
    from tidb_tpu_torch.cdc import MemorySink
    from tidb_tpu_torch.tools.chaos import CheckingSink

    s = Session(device="cpu")
    s.execute("CREATE TABLE gc (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO gc VALUES " + ",".join(
        f"({i},{i * 10})" for i in range(8)))
    sink = CheckingSink(MemorySink())
    s.store.cdc.create("gc", sink, s.catalog, start_ts=0)
    n, rounds = 6, 6
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    errors = []

    def run(i):
        try:
            for _r in range(rounds):
                barrier.wait()
                # distinct key per session per window; the same key
                # round after round exercises per-key commit order
                sessions[i].execute(f"UPDATE gc SET v = v + 1 WHERE id = {i}")
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    for _ in range(4):
        s.store.cdc.tick()
    assert sink.violations == [], sink.violations
    for i in range(n):
        assert s.execute(
            f"SELECT v FROM gc WHERE id = {i}").rows[0][0].val == i * 10 + rounds


# ------------------------------------------------- DML point-write tier

def test_pointwrite_tier_update_hits():
    s = make_store()
    s.execute("UPDATE t SET v = 777 WHERE id = 3")
    assert s._last_plan_cache[0] == "miss"
    h0 = metrics.PLAN_CACHE_HITS.value
    res = s.execute("UPDATE t SET v = 888 WHERE id = 4")  # same digest
    assert res.affected == 1
    assert s._last_plan_cache == ("hit", "", "pointwrite")
    assert metrics.PLAN_CACHE_HITS.value == h0 + 1
    assert s.execute("SELECT v FROM t WHERE id = 3").rows[0][0].val == 777
    assert s.execute("SELECT v FROM t WHERE id = 4").rows[0][0].val == 888
    assert s.catalog.plan_cache.stats()["tiers"]["pointwrite"] >= 1


def test_pointwrite_tier_delete_and_in_list():
    s = make_store()
    s.execute("DELETE FROM t WHERE id = 1")
    res = s.execute("DELETE FROM t WHERE id = 2")  # hit
    assert res.affected == 1
    assert s._last_plan_cache == ("hit", "", "pointwrite")
    assert s.execute("SELECT v FROM t WHERE id IN (1, 2)").rows == []
    s.execute("UPDATE t SET v = 0 WHERE id IN (5, 6)")
    res = s.execute("UPDATE t SET v = 1 WHERE id IN (7, 8)")  # hit
    assert res.affected == 2
    assert s._last_plan_cache == ("hit", "", "pointwrite")
    assert [r[0].val for r in s.execute(
        "SELECT v FROM t WHERE id IN (5, 6, 7, 8) ORDER BY id").rows] == [0, 0, 1, 1]


def test_pointwrite_tier_declines_typed():
    s = make_store()
    d0 = metrics.PLAN_CACHE_DECLINES.labels("dml_shape").value
    s.execute("UPDATE t SET v = 1 WHERE v = 10")  # not a pk point write
    assert metrics.PLAN_CACHE_DECLINES.labels("dml_shape").value == d0 + 1
    assert s._last_plan_cache == ("decline", "dml_shape", "")
    i0 = metrics.PLAN_CACHE_DECLINES.labels("in_txn").value
    s.execute("BEGIN")
    s.execute("UPDATE t SET v = 2 WHERE id = 5")
    s.execute("COMMIT")
    assert metrics.PLAN_CACHE_DECLINES.labels("in_txn").value == i0 + 1
    assert s.execute("SELECT v FROM t WHERE id = 5").rows[0][0].val == 2


def test_pointwrite_hit_serves_through_coalescer():
    """A pointwrite-tier hit reaches the group-commit window: the serve
    path is parse-free AND its write coalesces."""
    s = make_store(rows=8)
    s.execute("SET tidb_tpu_enable_coalesce = ON")
    s.execute("UPDATE t SET v = 1 WHERE id = 1")  # install
    g0 = metrics.COALESCE_LANES.labels("write").value
    s.execute("UPDATE t SET v = 2 WHERE id = 2")  # pointwrite hit
    assert s._last_plan_cache == ("hit", "", "pointwrite")
    # single-lane window still flushes through the coalescer
    assert metrics.COALESCE_LANES.labels("write").value > g0
    assert s.execute("SELECT v FROM t WHERE id = 2").rows[0][0].val == 2


# ------------------------------------------------- shared cross-catalog tier

def test_shared_tier_adopts_across_catalogs():
    from tidb_tpu_torch.sql import plancache as pc

    pc.SHARED_CACHE.clear()
    a = Session(device="cpu")
    a.execute("SET tidb_tpu_plan_cache_shared = ON")
    a.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    a.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    a.execute("SELECT v FROM t WHERE id = 1")  # install + publish
    b = Session(device="cpu")  # fresh store + catalog: identical bootstrap → same ids
    b.execute("SET tidb_tpu_plan_cache_shared = ON")
    b.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    b.execute("INSERT INTO t VALUES (1, 11), (2, 22)")
    h0 = metrics.PLAN_CACHE_SHARED_HITS.value
    r = b.execute("SELECT v FROM t WHERE id = 2")
    assert r.rows[0][0].val == 22  # bound against B's data, not A's
    assert metrics.PLAN_CACHE_SHARED_HITS.value == h0 + 1
    assert b._last_plan_cache == ("hit", "", "pointget")
    # promoted: the next statement hits B's local cache, not the shared tier
    b.execute("SELECT v FROM t WHERE id = 1")
    assert metrics.PLAN_CACHE_SHARED_HITS.value == h0 + 1


def test_shared_tier_rejects_schema_drift():
    from tidb_tpu_torch.sql import plancache as pc

    pc.SHARED_CACHE.clear()
    a = Session(device="cpu")
    a.execute("SET tidb_tpu_plan_cache_shared = ON")
    a.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    a.execute("INSERT INTO t VALUES (1, 10)")
    a.execute("SELECT v FROM t WHERE id = 1")
    c = Session(device="cpu")
    c.execute("SET tidb_tpu_plan_cache_shared = ON")
    c.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v VARCHAR(8))")
    c.execute("INSERT INTO t VALUES (1, 'a')")
    h0 = metrics.PLAN_CACHE_SHARED_HITS.value
    r = c.execute("SELECT v FROM t WHERE id = 1")  # fingerprint mismatch
    assert r.rows[0][0].val == "a"
    assert metrics.PLAN_CACHE_SHARED_HITS.value == h0
    # the home catalog's entry survives the rejected adoption
    a2 = Session(store=a.store, catalog=a.catalog)
    a2.execute("SET tidb_tpu_plan_cache_shared = ON")
    assert a2.execute("SELECT v FROM t WHERE id = 1").rows[0][0].val == 10
    assert a2._last_plan_cache[0] == "hit"


def test_shared_tier_off_by_default():
    from tidb_tpu_torch.sql import plancache as pc

    pc.SHARED_CACHE.clear()
    a = Session(device="cpu")
    a.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    a.execute("INSERT INTO t VALUES (1, 10)")
    a.execute("SELECT v FROM t WHERE id = 1")
    assert len(pc.SHARED_CACHE) == 0  # no publish without the sysvar


# ------------------------------------------------- one call per window, parity

def test_window_is_one_batch_coprocessor_call(monkeypatch):
    """Concurrent plan-cache-hit point gets with coalescing ON reach the
    store through ONE batch_coprocessor call per window, and the lanes of
    one table share a bucket: launches saved > 0."""
    s = make_store(rows=32)
    s.execute("SELECT v FROM t WHERE id = 1")  # install the pointget entry
    n = 8
    sessions = [clone(s) for _ in range(n)]
    calls = []
    orig = s.store.batch_coprocessor

    def counted(reqs, *a, **kw):
        calls.append(len(reqs))
        return orig(reqs, *a, **kw)

    monkeypatch.setattr(s.store, "batch_coprocessor", counted)
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = sessions[i].execute(f"SELECT v FROM t WHERE id = {i}").rows

    b0 = metrics.COALESCE_BATCHES.value
    l0 = metrics.COALESCE_LANES.labels("read").value
    sv0 = metrics.COALESCE_LAUNCHES_SAVED.value
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [r[0][0].val for r in out] == [i * 10 for i in range(n)]
    windows = metrics.COALESCE_BATCHES.value - b0
    assert len(calls) == windows >= 1  # one call a window, no other call
    assert sum(calls) == metrics.COALESCE_LANES.labels("read").value - l0
    assert metrics.COALESCE_LAUNCHES_SAVED.value > sv0


def test_coalesced_rows_equal_the_jax_package():
    """The same table through a JAX session (coalescing off, plan cache
    off) and port sessions that coalesce concurrently: every statement's
    rows are equal, Datum by kind and value."""
    import tidb_tpu.sql as j_sql

    stmts = [f"SELECT * FROM t WHERE id = {i}" for i in range(24)]
    stmts += [f"SELECT id, k FROM t WHERE id IN ({i}, {i + 5}, {i + 100})" for i in range(8)]
    ddl = ["CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, k VARCHAR(20), d DECIMAL(9,3))",
           "INSERT INTO t VALUES " + ",".join(
               f"({i},{i * 10 - 50},{'NULL' if i % 5 == 0 else repr('x' + str(i))},{i}.125)"
               for i in range(20))]
    def plain(rows):
        # decimals by their text: each package has its own MyDecimal class
        return [[(d.kind.name, d.val if isinstance(d.val, (int, float, str, bytes, type(None)))
                  else str(d.val)) for d in r] for r in rows]

    j = j_sql.Session()
    j.execute("SET tidb_enable_plan_cache = OFF")
    s = Session(device="cpu")
    for q in ddl:
        j.execute(q)
        s.execute(q)
    want = {q: plain(j.execute(q).rows) for q in stmts}
    s.execute(stmts[0])
    s.execute(stmts[-1])  # install both digests
    n = 8
    sessions = [clone(s) for _ in range(n)]
    barrier = threading.Barrier(n)
    got = {}
    errors = []
    l0 = metrics.COALESCE_LANES.labels("read").value

    def run(i):
        try:
            barrier.wait()
            for q in stmts[i::n]:
                got[q] = plain(sessions[i].execute(q).rows)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert got == want
    assert metrics.COALESCE_LANES.labels("read").value > l0


def test_mixed_storm_loses_no_update():
    """More sessions than cores, the interpreter switching threads every
    10 µs: coalesced autocommit increments (each session its own row, as
    concurrent autocommit writes of one row conflict in both packages)
    interleave with coalesced point gets of a neighbour's row; every
    increment lands once, every read sees a value some commit wrote, and
    no lane falls out."""
    n, rounds = 16, 12
    s = make_store(rows=n)
    s.execute("SELECT v FROM t WHERE id = 1")
    s.execute("UPDATE t SET v = v + 1 WHERE id = 7")
    s.execute("UPDATE t SET v = v - 1 WHERE id = 7")
    sessions = [clone(s, wait_us=2000) for _ in range(n)]
    barrier = threading.Barrier(n)
    errors = []
    seen = [[] for _ in range(n)]
    f0 = sum(fallbacks(r) for r in ("window_stall", "flush_lost", "fault_lane"))
    old = sys.getswitchinterval()

    def run(i):
        try:
            barrier.wait(timeout=30)
            for r in range(rounds):
                if (i + r) % 2:
                    sessions[i].execute(f"UPDATE t SET v = v + 1 WHERE id = {i}")
                else:
                    k = (i + 1) % n
                    seen[i].append((k, sessions[i].execute(f"SELECT v FROM t WHERE id = {k}").rows[0][0].val))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    writes = [sum(1 for r in range(rounds) if (i + r) % 2) for i in range(n)]
    for i in range(n):
        assert s.execute(f"SELECT v FROM t WHERE id = {i}").rows[0][0].val == i * 10 + writes[i]
        assert all(k * 10 <= v <= k * 10 + writes[k] for k, v in seen[i])
    assert sum(fallbacks(r) for r in ("window_stall", "flush_lost", "fault_lane")) == f0
