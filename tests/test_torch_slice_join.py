"""The port's join path end to end on the CPU: drive_program_info of
tidb_tpu_torch against the JAX package's drive_program_info (JAX on the
CPU) and its row-at-a-time oracle, over TPC-H Q3 (the packed join+group
chain: K3 then K2), the join bench's lineitem x orders DAG at a shape the
radix probe kernel (K4) takes — uniform and skewed, scalar and grouped — a
duplicate build key that retries through the dropped join hints onto the
general kernel, and left_outer / semi / anti joins at the radix shape.
Decoded rows must be byte-equal to the JAX package's, and so must the
per-executor row counts; the kernels' wrappers must run where the TPU route
runs its kernels (on the CPU they run their plain versions)."""

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
import tidb_tpu_torch.ops.joinagg as TA
import tidb_tpu_torch.ops.radix_join as TR
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
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


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _run_both(build, cols_list, group_capacity):
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    jchunk, jcounts, _ = j_drive(JCache(), jdag, [_jax_batch(c, f) for c, f in zip(cols_list, jfts)], group_capacity)
    tb = [device_batch_from_numpy(c, np.ones(len(c[0][0]), bool), len(c[0][0]), f, device="cpu")
          for c, f in zip(cols_list, tfts)]
    tchunk, tcounts, tinfo = t_drive(TCache(), tdag, tb, group_capacity)
    oracle = JE.run_dag_reference(jdag, [W.make_chunk(JC, f, c) for c, f in zip(cols_list, jfts)])
    got, want, ref = canon(tchunk.rows()), canon(jchunk.rows()), canon(oracle)
    assert got == want
    assert sorted(got) == sorted(ref)
    assert tcounts == jcounts
    return got, tinfo


@pytest.mark.parametrize("n", [3000, 4096])
def test_q3_matches_jax_and_oracle(n, monkeypatch):
    k2 = _spy(monkeypatch, TA, "postsort_segscan")
    k3 = _spy(monkeypatch, TA, "membership_segscan")
    got, info = _run_both(W.q3_dag, W.q3_columns(n, seed=n), 1024)
    assert len(got) > 10
    assert k2 == [1] and k3 == [1]
    assert "radix" not in info


@pytest.mark.parametrize("groups", [None, 64], ids=["scalar", "groups64"])
@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
def test_join_bench_matches_jax_and_oracle(skewed, groups, monkeypatch):
    k4 = _spy(monkeypatch, TR, "probe_tables")

    def build(E, X, T):
        return W.join_bench_dag(E, X, T, groups=groups)

    got, info = _run_both(build, W.join_bench_columns(4096, 32, skewed, groups), 128)
    assert info["radix"]["strategy"] == "kernel" and info["radix"]["partitions"] == 4
    if skewed:
        # the hot key's partition escapes; the escape buffer overflows at the
        # first rung and the need hint jumps one ladder step
        assert k4 == [1, 1] and info["radix"]["escapes"] > 0 and info["radix"]["rung"] > 4096
    else:
        assert k4 == [1] and info["radix"]["escapes"] == 0
    assert len(got) == 1 if groups is None else len(got) > 1


def test_dup_build_key_retries_on_the_general_kernel(monkeypatch):
    """A duplicate build key violates the unique-build hint: the radix
    probe flags it, the driver drops the join hints, and the general kernel
    (ops/join.py hash_join) answers."""
    import tidb_tpu_torch.exec.builder as TB

    k4 = _spy(monkeypatch, TR, "probe_tables")
    hj = _spy(monkeypatch, TB, "hash_join")
    cols = W.join_bench_columns(4096, 32, False, 64)
    okey, _, _ = cols[1][0]
    okey = okey.copy()
    okey[5] = okey[6]  # orders key 6 appears twice
    cols[1][0] = (okey, cols[1][0][1], None)

    def build(E, X, T):
        return W.join_bench_dag(E, X, T, groups=64)

    _run_both(build, cols, 128)
    assert k4 == [1] and hj == [1]


def _typed_join_dag(E, X, T, join_type):
    """lineitem(okey, v) <join_type> orders(okey, payload): semi / anti keep
    the probe schema (sum(v), count(*)); left_outer groups by the build
    payload, NULL for unmatched probes."""
    LL = T.new_longlong(notnull=True)
    ls = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    os_ = E.TableScan(2, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    join = E.Join(build=(os_,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),),
                  join_type=join_type, build_unique=True)
    aggs = (X.AggDesc("sum", (X.col(1, LL),)), X.AggDesc("count", ()))
    if join_type == "left_outer":
        agg = E.Aggregation(group_by=(X.col(3, LL.clone_nullable()),), aggs=aggs)
        return E.DAGRequest((ls, join, agg), output_offsets=(0, 1, 2)), [[LL, LL], [LL, LL]]
    agg = E.Aggregation(group_by=(), aggs=aggs)
    return E.DAGRequest((ls, join, agg), output_offsets=(0, 1)), [[LL, LL], [LL, LL]]


@pytest.mark.parametrize("join_type", ["left_outer", "semi", "anti"])
def test_typed_joins_at_the_radix_shape(join_type, monkeypatch):
    k4 = _spy(monkeypatch, TR, "probe_tables")
    rng = np.random.default_rng(12)
    n, nb = 4096, 128
    okey = rng.integers(0, 2 * nb, n).astype(np.int64)  # half the probes miss
    v = rng.integers(0, 1000, n).astype(np.int64)
    cols = [[W.fixed_col(okey), W.fixed_col(v)],
            [W.fixed_col(np.arange(nb, dtype=np.int64)), W.fixed_col(rng.integers(0, 16, nb).astype(np.int64))]]

    def build(E, X, T):
        return _typed_join_dag(E, X, T, join_type)

    got, info = _run_both(build, cols, 128)
    assert k4 == [1] and info["radix"]["strategy"] == "kernel"
    assert len(got) >= 1


def _stream_agg_dag(E, X, T):
    """probe(k, v) JOIN build(k, w), unique build, GROUP BY probe k with
    max(v) and avg(v): max is outside the packed path's sum / count / avg,
    so the fused one-sort join + stream aggregation runs."""
    LL = T.new_longlong()
    ps = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    bs = E.TableScan(2, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    join = E.Join(build=(bs,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),),
                  join_type="inner", build_unique=True)
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("max", (X.col(1, LL),)),
                                                      X.AggDesc("avg", (X.col(1, LL),))))
    return E.DAGRequest((ps, join, agg), output_offsets=(0, 1, 2)), [[LL, LL], [LL, LL]]


def test_join_stream_agg_route_matches_jax(monkeypatch):
    calls = _spy(monkeypatch, TA, "join_stream_agg")
    rng = np.random.default_rng(13)
    n, nb = 900, 40
    pkey = rng.integers(-5, 50, n).astype(np.int64)
    cols = [[(pkey, rng.random(n) < 0.05, None), (rng.integers(-100, 100, n).astype(np.int64), rng.random(n) < 0.1, None)],
            [W.fixed_col(rng.permutation(nb).astype(np.int64)), W.fixed_col(np.zeros(nb, np.int64))]]
    got, _ = _run_both(_stream_agg_dag, cols, 256)
    assert calls == [1] and len(got) > 10
