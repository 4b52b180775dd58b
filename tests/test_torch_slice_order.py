"""The port's order-dependent executors end to end on the CPU: TopN (bench.py's
topn config, BASELINE config 4), Sort and Window through tidb_tpu_torch's
drive_program_info against the JAX package's drive_program_info (JAX on the
CPU) and its row-at-a-time oracle. Decoded Chunks must be equal row for
row, in order, and so must the per-executor row counts. Also: the TopN
overflow flag reaches drive_program_info, which rebuilds the program with
topn_full=True (two compiles in both packages, the same answer); a
Selection under a TopN; a TopN after a join; k above FAST_K_LIMIT; and a
Sort feeding a stream aggregation, which routes to the stream kernel with
the JAX package's flags at a group capacity that fits and one that
overflows."""

import jax.numpy as jnp
import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.chunk.device import DeviceBatch as JBatch
from tidb_tpu.chunk.device import DeviceColumn as JColumn
from tidb_tpu.exec.builder import ProgramCache as JCache
from tidb_tpu.exec.builder import build_program as j_build
from tidb_tpu.exec.executor import drive_program_info as j_drive

import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.ops.aggregate as TAG
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
from tidb_tpu_torch.exec.builder import build_program as t_build
from tidb_tpu_torch.exec.executor import drive_program_info as t_drive
from tidb_tpu_torch.interop import device_batch_from_numpy


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def _jax_batch(cols, fts):
    n = len(cols[0][0])
    out = [JColumn(jnp.asarray(d), jnp.asarray(nl), jnp.asarray(ln) if ln is not None else None, ft)
           for (d, nl, ln), ft in zip(cols, fts)]
    return JBatch(out, jnp.ones(n, bool), jnp.int32(n))


def _torch_batch(cols, fts):
    n = len(cols[0][0])
    return device_batch_from_numpy(cols, np.ones(n, bool), n, fts, device="cpu")


def _run_both(build, cols_list, group_capacity=64, ordered_oracle=True):
    """Both packages' drive_program_info (and the oracle) over one DAG maker and per-scan
    numpy columns; returns (port rows, JAX cache, port cache)."""
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    jcache, tcache = JCache(), TCache()
    jchunk, jcounts, _ = j_drive(jcache, jdag, [_jax_batch(c, f) for c, f in zip(cols_list, jfts)], group_capacity)
    tchunk, tcounts, _ = t_drive(tcache, tdag, [_torch_batch(c, f) for c, f in zip(cols_list, tfts)], group_capacity)
    got, want = canon(tchunk.rows()), canon(jchunk.rows())
    assert got == want
    assert tcounts == jcounts
    oracle = canon(JE.run_dag_reference(jdag, [W.make_chunk(JC, f, c) for c, f in zip(cols_list, jfts)]))
    assert (got == oracle) if ordered_oracle else (sorted(got) == sorted(oracle))
    return got, jcache, tcache


def _single(build):
    """A single-scan DAG maker returning (dag, fts) as the multi-scan form."""
    def b(E, X, T):
        dag, fts = build(E, X, T)
        return dag, [fts]
    return b


@pytest.mark.parametrize("n", [3000, 4096, 1 << 14])
def test_topn_dag_matches_jax_and_oracle(n):
    got, jcache, tcache = _run_both(_single(W.topn_dag), [W.topn_columns(W.make_tables(n, seed=n))])
    assert len(got) == 100
    assert tcache.stats()["compiles"] == jcache.stats()["compiles"] == 1  # no retry: the fast path held


@pytest.mark.parametrize("n", [3000, 4096])
def test_sort_dag_matches_jax_and_oracle(n):
    got, _, _ = _run_both(_single(W.sort_dag), [W.topn_columns(W.make_tables(n, seed=n))])
    assert len(got) == n


@pytest.mark.parametrize("n", [2048, 3000])
def test_window_dag_matches_jax_and_oracle(n):
    got, _, _ = _run_both(_single(W.window_dag), [W.q3_columns(n, seed=n)[0]], ordered_oracle=False)
    assert len(got) == n and len(got[0]) == 12


def _tie_heavy_columns(n):
    """Every price equal: the fast path's candidate count passes its cap."""
    t = W.make_tables(n, seed=3)
    t["price"] = np.full(n, 123456, np.int64)
    return W.topn_columns(t)


def test_tie_heavy_topn_retries_on_the_full_sort():
    """The sampled threshold misses: with a constant topn flag, or a retry loop
    without the topn_full knob, the port would answer from the sampled
    program's wrong rows or run out of retries. Both packages rebuild with
    the full sort (two compiles) and answer the same rows."""
    n = 1 << 14
    got, jcache, tcache = _run_both(_single(W.topn_dag), [_tie_heavy_columns(n)])
    assert len(got) == 100
    assert jcache.stats()["compiles"] == 2
    assert tcache.stats()["compiles"] == 2


def test_program_returns_the_topn_overflow_flag():
    n = 1 << 14
    cols = _tie_heavy_columns(n)
    jdag, jfts = W.topn_dag(JE, JX, JT)
    tdag, tfts = W.topn_dag(TE, TX, TT)
    for full in (False, True):
        jovf = j_build(jdag, (n,), 64, None, full).fn(_jax_batch(cols, jfts))[3]
        tovf = t_build(tdag, (n,), 64, None, full).fn(_torch_batch(cols, tfts))[3]
        assert bool(jovf[2]) == bool(tovf[2]) == (not full)


def test_retry_asks_for_topn_full_and_the_cache_key_holds_it(monkeypatch):
    """drive_program_info asks the cache for topn_full=False, then True; the key
    holds the knob, so the two are two programs."""
    n = 1 << 14
    tdag, tfts = W.topn_dag(TE, TX, TT)
    cache = TCache()
    asked = []
    real = cache.get_info

    def spy(dag, caps, gc, jc, topn_full, *a, **k):
        asked.append(topn_full)
        return real(dag, caps, gc, jc, topn_full, *a, **k)

    monkeypatch.setattr(cache, "get_info", spy)
    t_drive(cache, tdag, _torch_batch(_tie_heavy_columns(n), tfts), 64)
    assert asked == [False, True]
    assert {key[4] for key in cache._cache} == {False, True}
    assert cache.get(tdag, (n,), 64, None, True, device="cpu") is not cache.get(tdag, (n,), 64, None, False, device="cpu")


def _sel_topn_dag(E, X, T):
    """WHERE shipdate < 1995-01-01 ORDER BY price DESC, shipdate LIMIT 37."""
    dag, fts = W.topn_dag(E, X, T, limit=37)
    scan, tn = dag.executors
    sel = E.Selection((X.func("lt", T.new_longlong(notnull=True), X.col(1, fts[1]),
                              X.lit("1995-01-01", T.new_datetime())),))
    return E.DAGRequest((scan, sel, tn), output_offsets=(0, 1)), [fts]


def test_selection_then_topn_matches_jax():
    got, _, _ = _run_both(_sel_topn_dag, [W.topn_columns(W.make_tables(1 << 14, seed=5))])
    assert len(got) == 37


def _join_topn_dag(E, X, T):
    """lineitem(okey, v) JOIN orders(okey, payload) ORDER BY v DESC,
    payload, okey LIMIT 50: a TopN over the radix join's output."""
    LL = T.new_longlong(notnull=True)
    ls = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    os_ = E.TableScan(2, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    join = E.Join(build=(os_,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),),
                  join_type="inner", build_unique=True)
    tn = E.TopN(order_by=((X.col(1, LL), True), (X.col(3, LL), False), (X.col(0, LL), False)), limit=50)
    return E.DAGRequest((ls, join, tn), output_offsets=(0, 1, 2, 3)), [[LL, LL], [LL, LL]]


def test_topn_after_a_join_matches_jax():
    got, _, _ = _run_both(_join_topn_dag, W.join_bench_columns(4096, 32, False, 64), 128)
    assert len(got) == 50


def test_k_above_fast_limit_matches_jax():
    def build(E, X, T):
        dag, fts = W.topn_dag(E, X, T, limit=4096)
        return dag, [fts]

    got, jcache, tcache = _run_both(build, [W.topn_columns(W.make_tables(8192, seed=9))])
    assert len(got) == 4096
    assert tcache.stats()["compiles"] == jcache.stats()["compiles"] == 1


def _sort_stream_dag(E, X, T):
    """ORDER BY g, then GROUP BY g as a stream aggregation (the planner
    proves the input sorted below a Sort): sum(v), count(*), g."""
    LL = T.new_longlong()
    scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    g, v = X.col(0, LL), X.col(1, LL)
    agg = E.Aggregation(group_by=(g,), aggs=(X.AggDesc("sum", (v,)), X.AggDesc("count", ())), stream=True)
    return E.DAGRequest((scan, E.Sort(order_by=((g, False),)), agg), output_offsets=(0, 1, 2)), [LL, LL]


def _stream_columns(n, groups):
    rng = np.random.default_rng(groups)
    g = rng.integers(0, groups, n).astype(np.int64)
    return [(g, rng.random(n) < 0.05, None), (rng.integers(-1000, 1000, n).astype(np.int64), rng.random(n) < 0.1, None)]


@pytest.mark.parametrize("gcap", [256, 64], ids=["fits", "overflows"])
def test_sort_then_stream_aggregation_matches_jax(gcap, monkeypatch):
    n, groups = 4096, 150
    cols = _stream_columns(n, groups)
    calls = []
    real = TAG._group_aggregate_stream

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TAG, "_group_aggregate_stream", spy)
    jdag, jfts = _sort_stream_dag(JE, JX, JT)
    tdag, tfts = _sort_stream_dag(TE, TX, TT)
    # the program's flags at this group capacity
    jres = j_build(jdag, (n,), gcap).fn(_jax_batch(cols, jfts))
    tres = t_build(tdag, (n,), gcap).fn(_torch_batch(cols, tfts))
    for i in range(6):
        assert int(jres[3][i]) == int(tres[3][i]), f"flag {i}"
    assert bool(tres[3][0]) == (gcap < groups + 1)  # NULL keys form one more group
    assert calls
    # through drive_program_info, with the ladder retry when it overflows
    got, _, _ = _run_both(lambda E, X, T: (lambda d, f: (d, [f]))(*_sort_stream_dag(E, X, T)), [cols], gcap,
                          ordered_oracle=False)
    assert len(got) == groups + 1
