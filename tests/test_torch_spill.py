"""The port's run_dag_on_chunks (tidb_tpu_torch exec/executor.py) against
the JAX package's on the CPU: the spill analog and the oracle fallback.

  * tests/test_spill.py's four cases through both packages: a Complete
    aggregation past its capacity spills by a host hash of the group keys,
    a Partial1 aggregation by row halving, a join's fan-out by probe
    halving, and a host-only aggregate raises with oracle_fallback=False;
    the rows and the SPILL_PARTITIONS deltas are the same in both;
  * a group_concat DAG and a replace() DAG: the device refuses them and
    both packages answer the oracle's rows; with oracle_fallback=False the
    port raises where the JAX package raises;
  * a DAG with no safe spill decomposition falls back to the oracle (or
    raises without it); the spill stops at depth 4.
Tolerance: exact (integer data).
"""

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.exec.executor import OverflowRetryError as JOverflow
from tidb_tpu.exec.executor import run_dag_on_chunks as j_run
from tidb_tpu.exec.executor import run_dag_reference as j_oracle
from tidb_tpu.util import metrics as JM

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.exec.executor import OverflowRetryError as TOverflow
from tidb_tpu_torch.exec.executor import run_dag_on_chunks as t_run
from tidb_tpu_torch.util import metrics as TM


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


PKGS = {"jax": (JT, JC, JE, JX), "port": (TT, TC, TE, TX)}


def _chunk(pkg, vals, n_cols):
    T, C, _E, _X = PKGS[pkg]
    LL = T.new_longlong()
    return C.Chunk.from_rows([LL] * n_cols, [[T.Datum.i64(int(v)) for v in r] for r in vals])


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def both(build, chunks_of, **kw):
    """(port rows, JAX rows, port SPILL_PARTITIONS delta, JAX delta)."""
    out = {}
    for pkg, run, m in (("port", lambda *a, **k: t_run(*a, device="cpu", **k), TM), ("jax", j_run, JM)):
        dag = build(*PKGS[pkg])
        before = m.SPILL_PARTITIONS.value
        res = run(dag, chunks_of(pkg), **kw)
        out[pkg] = (canon(res.rows()), m.SPILL_PARTITIONS.value - before)
    return out["port"][0], out["jax"][0], out["port"][1], out["jax"][1]


# ---------------------------------------------------------------------------
# tests/test_spill.py through both packages
# ---------------------------------------------------------------------------

def _group_dag(T, C, E, X):
    LL = T.new_longlong()
    scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("count", ()), X.AggDesc("sum", (X.col(1, LL),))))
    return E.DAGRequest((scan, agg), output_offsets=(0, 1, 2))


def test_group_overflow_partitions_by_key_hash():
    """500 groups at group capacity 4 with no retry: the key-hash partition
    (4 parts a level, the parts spilling again) gives the exact rows."""
    rng = np.random.default_rng(5)
    g, v = rng.integers(0, 500, 2000), rng.integers(0, 1000, 2000)
    got, want, dt, dj = both(_group_dag, lambda p: [_chunk(p, zip(g, v), 2)], group_capacity=4, max_retries=0,
                             oracle_fallback=False)
    assert got == want  # same parts, same order: the host hash is the same
    assert dt == dj > 0
    ref = canon(j_oracle(_group_dag(JT, JC, JE, JX), [_chunk("jax", zip(g, v), 2)]))
    assert sorted(got) == sorted(ref)


def test_group_overflow_one_level():
    """Capacity 256 and 500 groups: one level of four parts of ~125 groups
    each, SPILL_PARTITIONS exactly +1 in both."""
    rng = np.random.default_rng(15)
    g, v = rng.integers(0, 500, 3000), rng.integers(0, 1000, 3000)
    got, want, dt, dj = both(_group_dag, lambda p: [_chunk(p, zip(g, v), 2)], group_capacity=256, max_retries=0,
                             oracle_fallback=False)
    assert got == want
    assert dt == dj == 1
    assert len(got) == len(set(g))


def test_partial_agg_row_split():
    def build(T, C, E, X):
        LL = T.new_longlong()
        scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
        agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("count", ()),), partial=True)
        return E.DAGRequest((scan, agg), output_offsets=(0, 1))

    rng = np.random.default_rng(6)
    vals = list(zip(rng.integers(0, 400, 1500), rng.integers(0, 9, 1500)))
    # max_retries=0 pins the spill (the ladder's need hint would resolve it)
    got, want, dt, dj = both(build, lambda p: [_chunk(p, vals, 2)], group_capacity=256, max_retries=0,
                             oracle_fallback=False)
    assert got == want
    assert dt == dj > 0
    totals: dict = {}
    for c, k in got:
        totals[k] = totals.get(k, 0) + int(c)
    ref: dict = {}
    for r in canon(j_oracle(build(JT, JC, JE, JX), [_chunk("jax", vals, 2)])):
        ref[r[1]] = ref.get(r[1], 0) + int(r[0])
    assert totals == ref


def test_join_fanout_overflow_halves_probe():
    def build(T, C, E, X):
        LL = T.new_longlong()
        ps = E.TableScan(1, (E.ColumnInfo(1, LL),))
        bs = E.TableScan(2, (E.ColumnInfo(1, LL),))
        join = E.Join(build=(bs,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),))
        return E.DAGRequest((ps, join), output_offsets=(0, 1))

    def chunks(p):
        build_vals = [[k] for k in range(64) for _ in range(16)]  # 16x fan-out
        probe_vals = [[k % 64] for k in range(256)]
        return [_chunk(p, probe_vals, 1), _chunk(p, build_vals, 1)]

    got, want, dt, dj = both(build, chunks, group_capacity=16, max_retries=0, oracle_fallback=False)
    assert got == want
    assert dt == dj > 0
    assert len(got) == 256 * 16


# ---------------------------------------------------------------------------
# the oracle fallback
# ---------------------------------------------------------------------------

def _group_concat_dag(T, C, E, X):
    LL = T.new_longlong()
    scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("group_concat", (X.col(1, LL),)),))
    return E.DAGRequest((scan, agg), output_offsets=(0, 1))


def _replace_dag(T, C, E, X):
    V = T.new_varchar(16)
    scan = E.TableScan(1, (E.ColumnInfo(1, V),))
    proj = E.Projection((X.func("replace", V, X.col(0, V), X.lit("a", V), X.lit("xy", V)),))
    return E.DAGRequest((scan, proj), output_offsets=(0,))


def _replace_chunk(pkg):
    T, C, _E, _X = PKGS[pkg]
    words = ["banana", "", "abc", "zzz", "aaaa"]
    return C.Chunk.from_rows([T.new_varchar(16)], [[T.Datum.NULL if w == "zzz" else T.Datum.string(w)]
                                                   for w in words])


FALLBACK_CASES = {
    "group_concat": (_group_concat_dag, lambda p: [_chunk(p, [[i % 3, i] for i in range(12)], 2)]),
    "replace": (_replace_dag, lambda p: [_replace_chunk(p)]),
}


@pytest.mark.parametrize("case", sorted(FALLBACK_CASES))
def test_host_only_dag_answers_the_oracle_rows(case):
    build, chunks_of = FALLBACK_CASES[case]
    got, want, dt, dj = both(build, chunks_of)
    assert got == want == canon(j_oracle(build(*PKGS["jax"]), chunks_of("jax")))
    assert dt == dj == 0


@pytest.mark.parametrize("case", sorted(FALLBACK_CASES))
def test_host_only_dag_raises_without_the_oracle(case):
    build, chunks_of = FALLBACK_CASES[case]
    with pytest.raises(NotImplementedError):
        t_run(build(*PKGS["port"]), chunks_of("port"), oracle_fallback=False, device="cpu")
    with pytest.raises(NotImplementedError):
        j_run(build(*PKGS["jax"]), chunks_of("jax"), oracle_fallback=False)


def _topn_over_agg_dag(T, C, E, X):
    """An aggregation under a TopN: no safe spill decomposition."""
    LL = T.new_longlong()
    scan = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("count", ()),))
    return E.DAGRequest((scan, agg, E.TopN(order_by=((X.col(1, LL), False),), limit=5)), output_offsets=(0, 1))


def test_no_spill_decomposition_falls_back_to_the_oracle():
    rng = np.random.default_rng(7)
    vals = list(zip(rng.integers(0, 300, 900), rng.integers(0, 9, 900)))
    got, want, dt, dj = both(_topn_over_agg_dag, lambda p: [_chunk(p, vals, 2)], group_capacity=64, max_retries=0)
    assert got == want == canon(j_oracle(_topn_over_agg_dag(*PKGS["jax"]), [_chunk("jax", vals, 2)]))
    assert dt == dj == 0
    with pytest.raises(TOverflow):
        t_run(_topn_over_agg_dag(*PKGS["port"]), [_chunk("port", vals, 2)], group_capacity=64, max_retries=0,
              oracle_fallback=False, device="cpu")
    with pytest.raises(JOverflow):
        j_run(_topn_over_agg_dag(*PKGS["jax"]), [_chunk("jax", vals, 2)], group_capacity=64, max_retries=0,
              oracle_fallback=False)


def test_spill_depth_is_bounded():
    """At depth 4 neither package partitions again."""
    from tidb_tpu.exec.executor import _spill_partitioned as j_spill
    from tidb_tpu_torch.exec.executor import _spill_partitioned as t_spill

    vals = [[i, i] for i in range(50)]
    with pytest.raises(TOverflow, match="depth"):
        t_spill(_group_dag(*PKGS["port"]), [_chunk("port", vals, 2)], TE.ProgramCache(), 4, None, 4, "cpu")
    with pytest.raises(JOverflow, match="depth"):
        j_spill(_group_dag(*PKGS["jax"]), [_chunk("jax", vals, 2)], JE.ProgramCache(), 4, None, 4)
