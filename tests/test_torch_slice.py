"""The port's coprocessor program (tidb_tpu_torch) against the JAX package
on the CPU: Q6, the scalar aggregate and Q1 (small-G hint 16, through the
one-pass kernel's plain version) decode to the same rows, byte for byte,
as JAX-CPU drive_program_info and the row-at-a-time oracle."""

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
from tidb_tpu.exec.executor import drive_program_info as j_drive

import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
from tidb_tpu_torch.exec.executor import drive_program_info as t_drive
from tidb_tpu_torch.interop import device_batch_from_numpy
from tidb_tpu_torch.ops import dense_agg as K1

N = 3000


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def _jax_batch(cols, fts, n):
    out = []
    for (data, null, length), ft in zip(cols, fts):
        out.append(JColumn(jnp.asarray(data), jnp.asarray(null),
                           jnp.asarray(length) if length is not None else None, ft))
    return JBatch(out, jnp.ones(n, bool), jnp.int32(n))


def _run_both(build, columns, small_groups=None, seed=1, n=N, group_capacity=64):
    t = W.make_tables(n, seed)
    cols = columns(t)
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    jchunk, jcounts, _ = j_drive(JCache(), jdag, _jax_batch(cols, jfts, n), group_capacity,
                                 small_groups=small_groups)
    tb = device_batch_from_numpy(cols, np.ones(n, bool), n, tfts, device="cpu")
    tchunk, tcounts, _ = t_drive(TCache(), tdag, tb, group_capacity, small_groups=small_groups)
    oracle = JE.run_dag_reference(jdag, W.make_chunk(JC, jfts, cols))
    return canon(tchunk.rows()), canon(jchunk.rows()), canon(oracle), tcounts, jcounts


def test_q6_matches_jax_and_oracle():
    got, jax_rows, oracle, tc, jc = _run_both(W.q6_dag, W.q6_columns)
    assert got == jax_rows == oracle
    assert tc == jc
    assert int(got[0][1]) > 0  # the filter keeps some rows


@pytest.mark.parametrize("threshold", ["120.00", "25.00"])
def test_scalar_agg_matches_jax_and_oracle(threshold):
    def build(e, x, t):
        return W.scalar_agg_dag(e, x, t, threshold=threshold)

    got, jax_rows, oracle, tc, jc = _run_both(build, W.scalar_agg_columns)
    assert got == jax_rows == oracle
    assert tc == jc


def test_q1_small_groups_through_k1_matches_jax_and_oracle():
    before = K1.dense_agg.launches
    got, jax_rows, oracle, tc, jc = _run_both(W.q1_dag, W.q1_columns, small_groups=16)
    assert got == jax_rows == oracle
    assert tc == jc
    assert len(got) == 6
    assert K1.dense_agg.launches == before  # CPU tensors: plain version, no launch


def test_q1_hint_too_small_overflows_and_retries_on_sort_path(monkeypatch):
    calls = []
    real = K1.group_aggregate_dense

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append(bool(res.overflow))
        return res

    monkeypatch.setattr(K1, "group_aggregate_dense", spy)
    got, jax_rows, oracle, _, _ = _run_both(W.q1_dag, W.q1_columns, small_groups=4, seed=2)
    assert calls == [True]  # one K1 run, overflowed; the retry sorted
    assert sorted(got) == sorted(oracle)
    assert got == jax_rows


def test_q1_without_hint_takes_sort_path():
    got, jax_rows, oracle, _, _ = _run_both(W.q1_dag, W.q1_columns, seed=3, n=1500)
    assert got == jax_rows == oracle


def _mixed_dag(X_exec, X_expr, X_types, group=True):
    """GROUP BY an int key (or none) over the sort path's other states:
    min/max (decimal and string), first_row, stddev/var, avg over DOUBLE."""
    T = X_types
    LL, D15, DBL, V8 = T.new_longlong(), T.new_decimal(15, 2), T.new_double(), T.new_varchar(8)
    fts = [LL, D15, DBL, V8]
    C = lambda i: X_expr.col(i, fts[i])  # noqa: E731
    A = X_expr.AggDesc
    scan = X_exec.TableScan(1, tuple(X_exec.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    aggs = (A("min", (C(1),)), A("max", (C(1),)), A("min", (C(3),)), A("max", (C(3),)),
            A("first_row", (C(1),)), A("var_pop", (C(1),)), A("stddev_samp", (C(2),)),
            A("avg", (C(2),)), A("sum", (C(2),)), A("count", (C(3),)))
    agg = X_exec.Aggregation(group_by=(C(0),) if group else (), aggs=aggs)
    n_out = len(aggs) + (1 if group else 0)
    return X_exec.DAGRequest((scan, agg), output_offsets=tuple(range(n_out))), fts


def _mixed_columns(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array([b"", b"a", b"ab", b"abc", b"zz", b"Ab"], dtype=object)
    codes = rng.integers(0, len(words), n)
    data = np.zeros((n, 3), np.uint8)
    lens = np.array([len(words[c]) for c in codes], np.int32)
    for i, c in enumerate(codes):
        data[i, : lens[i]] = np.frombuffer(words[c], np.uint8)
    null = lambda p: rng.random(n) < p  # noqa: E731
    return [
        (rng.integers(0, 7, n).astype(np.int64), null(0.05), None),
        (rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64), null(0.1), None),
        (np.round(rng.normal(size=n) * 100, 2), null(0.1), None),
        (data, null(0.1), lens),
    ]


@pytest.mark.parametrize("group", [True, False], ids=["group_by", "scalar"])
def test_sort_path_states_match_jax_and_oracle(group):
    """min/max over decimals and strings (GatherState), first_row,
    var/stddev and DOUBLE avg/sum through the port's sort path. DOUBLE
    results are compared to 1e-9 relative: their sums are cumsum
    differences whose last bits follow each library's summation order."""
    n = 700
    cols = _mixed_columns(n, 5)
    jdag, jfts = _mixed_dag(JE, JX, JT, group)
    tdag, tfts = _mixed_dag(TE, TX, TT, group)
    jchunk, _, _ = j_drive(JCache(), jdag, _jax_batch(cols, jfts, n), 64)
    tb = device_batch_from_numpy(cols, np.ones(n, bool), n, tfts, device="cpu")
    tchunk, _, _ = t_drive(TCache(), tdag, tb, 64)
    oracle = JE.run_dag_reference(jdag, W.make_chunk(JC, jfts, cols))
    got, want, ref = canon(tchunk.rows()), canon(jchunk.rows()), canon(oracle)
    assert len(got) == len(want) == len(ref)

    def close(a, b):
        if a is None or b is None:
            return a == b
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            return a == b
        return a == b or abs(fa - fb) <= 1e-9 * max(abs(fa), abs(fb))

    for g, w, r in zip(got, want, ref):
        assert all(close(x, y) for x, y in zip(g, w)), (g, w)
        assert all(close(x, y) for x, y in zip(g, r)), (g, r)
