"""The session's memory-quota chain through both packages: the store's
cache eviction, the degrade to the low-memory fold and the quota error.

The port's `TPUStore.evict_caches` returned None, so the query tracker's
first action (`tr.consume(-min(freed, 0))`) raised TypeError on any
breach; it returns the bytes it freed, as the reference's does
(`tidb_tpu/store/store.py evict_caches`). Each case runs the same
statements on a `tidb_tpu.sql.Session` and a
`tidb_tpu_torch.sql.Session(device="cpu")` (tests/torch_sql_parity.py),
and the outcomes and the chain's counters must agree.
"""

import pytest

import tidb_tpu.util as j_util
import tidb_tpu.util.memory as j_memory
import tidb_tpu_torch.util.memory as p_memory
from torch_sql_parity import JAX, PORT, Both, Call, Sql, _result, outcome, run_case, same, session_pair

T_ROWS = "INSERT INTO t (id, g, v) VALUES " + ", ".join(f"({i}, {i % 5}, {i}.25)" for i in range(100))
SP_ROWS = "insert into sp values " + ",".join(f"({i}, {i % 500}, {i})" for i in range(3000))
GROUP_BY = "select g, sum(v) from sp group by g"


def _t_pair():
    s = session_pair()
    run_case(["CREATE TABLE t (id BIGINT PRIMARY KEY, g INT, v DECIMAL(8,2))", T_ROWS], s)
    return s


def _split_sp(pkg, sessions):
    s = sessions["s"]
    tid = s.catalog.table("sp").table_id
    for h in range(500, 3000, 500):
        s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))


def _sp_pair():
    """tests/test_subsystems.py's six-region GROUP BY table, mesh off."""
    s = session_pair()
    run_case(["create table sp (id bigint primary key, g bigint, v bigint)", SP_ROWS, Call(_split_sp)], s)
    return s


def chain(pair, sql):
    """The statement's outcome (a Result or the exception's class, code
    and message) and the chain's counter deltas, equal in both packages;
    the port's."""

    def run(s, pkg):
        m = pkg.metrics
        before = (m.MEM_EVICTIONS.value, m.MEM_DEGRADED_QUERIES.value)
        out = outcome(lambda: s.execute(sql))
        return out, (m.MEM_EVICTIONS.value - before[0], m.MEM_DEGRADED_QUERIES.value - before[1])

    return Both(pair).call(run)


def test_util_exports_the_reference_names():
    from tidb_tpu_torch.util import REGISTRY, MemTracker, QuotaExceeded, failpoint
    import tidb_tpu_torch.util as p_util
    import tidb_tpu_torch.util.failpoint as p_failpoint
    import tidb_tpu_torch.util.metrics as p_metrics

    assert p_util.__all__ == j_util.__all__ == ["failpoint", "MemTracker", "QuotaExceeded", "REGISTRY"]
    assert (MemTracker, QuotaExceeded, REGISTRY, failpoint) == (
        p_memory.MemTracker, p_memory.QuotaExceeded, p_metrics.REGISTRY, p_failpoint)


@pytest.mark.parametrize("sql", ["SELECT * FROM t", "SELECT g, count(*) FROM t GROUP BY g"])
def test_evict_caches_returns_the_bytes_freed(sql):
    """After one statement both stores hold one decoded chunk and one
    response a region, and free the same bytes; a second call frees 0."""
    pair = _t_pair()
    run_case([sql], pair)
    freed = {name: pair[name]["s"].store.evict_caches() for name in ("jax", "port")}
    assert type(freed["port"]) is int and freed["port"] > 0
    assert freed["port"] == freed["jax"]
    again = {name: pair[name]["s"].store.evict_caches() for name in ("jax", "port")}
    assert again == {"jax": 0, "port": 0}


def test_evict_caches_counts_one_decode_a_data_version():
    """Over two statements the reference decodes each region again (its
    chunk cache is keyed by start_ts) and frees both decodes; the port
    keeps one decode a data version (ROADMAP §3 "Divergences by design")
    and frees it once."""
    pair = _t_pair()
    run_case(["SELECT * FROM t"], pair)
    # one statement: one decode and one response a region
    one = {name: pair[name]["s"].store.evict_caches() for name in ("jax", "port")}
    run_case(["SELECT * FROM t", "SELECT g, count(*) FROM t GROUP BY g"], pair)
    freed = {name: pair[name]["s"].store.evict_caches() for name in ("jax", "port")}
    assert one["jax"] == one["port"]
    assert 0 < freed["port"] < freed["jax"] and freed["jax"] - freed["port"] <= one["port"]


def test_evict_caches_of_an_empty_store_is_zero():
    assert PORT.new_store().evict_caches() == 0 == JAX.new_store().evict_caches()


def test_the_query_quota_error_matches():
    pair = _t_pair()
    run_case(["SET tidb_mem_quota_query = 1", Sql("SELECT * FROM t", err=True)], pair)
    with pytest.raises(PORT.sql.SQLError, match=r"^memory quota exceeded: tracker 'query'") as ei:
        pair["port"]["s"].execute("SELECT * FROM t")
    assert ei.value.code == 1105
    run_case([f"SET tidb_mem_quota_query = {1 << 30}", "SELECT count(*) FROM t"], pair)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_a_degraded_group_by_equals_the_jax_package(warm):
    pair = _sp_pair()
    if warm:
        run_case([GROUP_BY], pair)  # the store's caches hold the regions
    run_case(["set tidb_mem_quota_query = 30000"], pair)
    out, deltas = chain(pair, GROUP_BY)
    assert out[0] == "ok" and deltas == (1, 1)  # evicted once, then degraded once
    want = {}
    for i in range(3000):
        want[i % 500] = want.get(i % 500, 0) + i
    got = {int(r[0].val): int(str(r[1].val)) for r in pair["port"]["s"].execute(GROUP_BY).rows}
    assert got == want


def test_the_fold_keeps_the_quota_or_raises():
    """A query quota below the fold's peak: evicted, degraded, and the
    fold's breach raises the quota error (the action runs once)."""
    pair = _sp_pair()
    run_case(["set tidb_mem_quota_query = 5000"], pair)
    out, deltas = chain(pair, GROUP_BY)
    assert out[:3] == ("err", "SQLError", 1105) and deltas == (1, 1)


@pytest.mark.parametrize("quota, degrades", [(30000, True), (20000, True), (10000, False), (1, False)])
def test_a_session_quota_breach_evicts(quota, degrades):
    """tidb_mem_quota_session: the session tracker's spill action evicts
    on each breach; the pool tier's breach degrades the statement, and a
    quota below the fold's peak breaches again and raises the session's
    quota error."""
    pair = _sp_pair()
    run_case([GROUP_BY, f"set tidb_mem_quota_session = {quota}"], pair)
    out, deltas = chain(pair, GROUP_BY)
    if degrades:
        assert out[0] == "ok" and deltas == (1, 1)
    else:
        assert out[:3] == ("err", "SQLError", 1105) and "tracker 'session'" in out[3]
        assert deltas == (2, 1)
    run_case(["set tidb_mem_quota_session = 0", GROUP_BY], pair)


def test_the_degraded_fold_equals_the_pool_tier_and_the_tracker_drift():
    """The low-memory fold's rows equal the pool tier's, and both
    packages share the session tracker's drift after a query-quota
    degrade: the query tracker keeps the refused bytes and releases them
    to its parent, which never had them (ROADMAP §3 "Shared defects")."""
    pair = _sp_pair()
    pool = {name: _result(pair[name]["s"].execute(GROUP_BY)) for name in ("jax", "port")}
    run_case(["set tidb_mem_quota_query = 30000"], pair)
    fold = {name: _result(pair[name]["s"].execute(GROUP_BY)) for name in ("jax", "port")}
    assert same(pool["jax"], pool["port"]) and same(fold["jax"], fold["port"])
    assert sorted(map(str, fold["port"]["rows"])) == sorted(map(str, pool["port"]["rows"]))
    drift = {name: pair[name]["s"]._mem_tracker.consumed for name in ("jax", "port")}
    assert drift["port"] == drift["jax"] < 0


@pytest.mark.parametrize("mem", [j_memory, p_memory], ids=["jax", "port"])
def test_memtracker_consume_and_release_all(mem):
    """MemTracker.consume / release_all on the same inputs in both
    packages: the action runs once per breach, a breach still over quota
    raises with the reference's message, release_all returns the child's
    bytes to its parent."""
    log = []
    parent = mem.MemTracker("session", quota=100, action=lambda tr, n: log.append(("parent", n)))
    child = mem.MemTracker("query", quota=60, parent=parent, action=lambda tr, n: log.append(("child", n)))
    child.consume(50)
    with pytest.raises(mem.QuotaExceeded, match=r"tracker 'query' at 70 \+ 20 > 60"):
        child.consume(20)
    child.release_all()
    assert (child.consumed, parent.consumed, child.peak, parent.peak) == (0, -20, 70, 50)
    other = mem.MemTracker("q2", parent=parent)
    with pytest.raises(mem.QuotaExceeded, match=r"tracker 'session' at 110 \+ 130 > 100"):
        other.consume(130)
    assert log == [("child", 20), ("parent", 130)]
