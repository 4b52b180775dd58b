"""The port's row-at-a-time oracle (exec/executor.py run_dag_reference, a
copy of the JAX package's) against the JAX package's, row for row.

Each DAG gets the same numpy-made chunks in both packages: Q6, Q1, Q3
(lineitem, orders, customer), the join bench (scalar and grouped), TopN,
Sort, the window DAG (its tie order included), a group_concat and an
`upper` projection. The rows must be equal in order, kind and value, and
Chunk.from_rows over them must give the same column dtypes. Tolerance:
exact everywhere.
"""

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.executor import run_dag_reference

N = 400


def _canon(rows):
    return [tuple(None if d.is_null() else (int(d.kind), str(d.val)) for d in r) for r in rows]


def _group_concat_dag(E, X, T):
    V1 = T.new_varchar(1)
    scan = E.TableScan(1, (E.ColumnInfo(1, V1), E.ColumnInfo(2, V1)))
    agg = E.Aggregation(group_by=(X.col(1, V1),), aggs=(X.AggDesc("group_concat", (X.col(0, V1),)), X.AggDesc("count", ())))
    return E.DAGRequest((scan, agg), output_offsets=(0, 1, 2)), [V1, V1]


def _upper_dag(E, X, T):
    V1 = T.new_varchar(1)
    scan = E.TableScan(1, (E.ColumnInfo(1, V1), E.ColumnInfo(2, V1)))
    proj = E.Projection((X.func("upper", T.new_varchar(4), X.func("lower", T.new_varchar(4), X.col(0, V1))), X.col(1, V1)))
    return E.DAGRequest((scan, proj), output_offsets=(0, 1)), [V1, V1]


def _ties(t):
    """TopN / Sort / window inputs with many equal prices (ties resolved
    by the later keys and then by input order)."""
    t = dict(t)
    t["price"] = t["price"] % 7 * 100
    return t


CASES = {
    "q6": (lambda E, X, T: W.q6_dag(E, X, T), lambda: [W.q6_columns(W.make_tables(N))]),
    "q1": (lambda E, X, T: W.q1_dag(E, X, T), lambda: [W.q1_columns(W.make_tables(N))]),
    "q3": (lambda E, X, T: W.q3_dag(E, X, T), lambda: W.q3_columns(N)),
    "join": (lambda E, X, T: W.join_bench_dag(E, X, T), lambda: W.join_bench_columns(N, 8, False)),
    "join_grouped": (lambda E, X, T: W.join_bench_dag(E, X, T, groups=5), lambda: W.join_bench_columns(N, 8, True, 5)),
    "topn": (lambda E, X, T: W.topn_dag(E, X, T, limit=37), lambda: [W.topn_columns(_ties(W.make_tables(N)))]),
    "sort": (lambda E, X, T: W.sort_dag(E, X, T), lambda: [W.topn_columns(_ties(W.make_tables(N)))]),
    "window": (lambda E, X, T: W.window_dag(E, X, T), lambda: [W.q3_columns(N)[0]]),
    "group_concat": (_group_concat_dag, lambda: [W.q1_columns(W.make_tables(N))[:2]]),
    "upper": (_upper_dag, lambda: [W.q1_columns(W.make_tables(N))[:2]]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_rows_match_the_jax_oracle(name):
    build, make_cols = CASES[name]
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    cols = make_cols()
    if len(cols) == 1:
        jfts, tfts = [jfts], [tfts]
    jrows = JE.run_dag_reference(jdag, [W.make_chunk(JC, f, c) for c, f in zip(cols, jfts)])
    trows = run_dag_reference(tdag, [W.make_chunk(TC, f, c) for c, f in zip(cols, tfts)])
    assert len(trows) > 0
    assert _canon(trows) == _canon(jrows)
    jch, tch = JC.Chunk.from_rows(jdag.output_fts(), jrows), TC.Chunk.from_rows(tdag.output_fts(), trows)
    for jc, tc in zip(jch.columns, tch.columns):
        assert tc.is_varlen() == jc.is_varlen()
        if tc.is_varlen():
            assert np.array_equal(tc.offsets, jc.offsets) and np.array_equal(tc.blob, jc.blob)
        else:
            assert tc.data.dtype == jc.data.dtype and np.array_equal(tc.data, jc.data)
        assert np.array_equal(tc.null, jc.null)


def test_an_extension_op_is_refused_by_name():
    """An extension op with no registered function is refused by name; a
    registered one (the host builtin md5) is evaluated."""
    from tidb_tpu_torch.expr import ir
    from tidb_tpu_torch.expr.eval_ref import RefEvaluator

    arg = (ir.Const(TT.Datum.string("a"), TT.new_varchar(1)),)
    ir.EXTENSION_OPS.add("x_unregistered")
    try:
        e = ir.ScalarFunc("x_unregistered", arg, TT.new_varchar(32))
        with pytest.raises(NotImplementedError, match="'x_unregistered'"):
            RefEvaluator().eval(e, [])
    finally:
        ir.EXTENSION_OPS.discard("x_unregistered")
    import tidb_tpu_torch.sql  # noqa: F401 — registers the host builtins

    md5 = ir.ScalarFunc("md5", arg, TT.new_varchar(32))
    assert RefEvaluator().eval(md5, []).val == "0cc175b9c0f1b6a831c399e269772661"
