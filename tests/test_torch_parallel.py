"""The port's mesh tier (tidb_tpu_torch/parallel, mpp/exchange_op.py)
against the JAX package's, on the CPU: the 24 cases of
tests/test_parallel.py, and a case for each trap of the port.

The JAX package runs on tests/conftest.py's eight virtual CPU devices, the
port on `["cpu"] * 8` (eight shards of the CPU); both get the same inputs,
made from a seed with numpy:
  * sharded scalar partial aggregation (sum / count / avg, min / max /
    first_row, unsigned min / max in the flipped domain, a first_row whose
    first region is filtered out, a NULL first value kept);
  * hash partitioning (int keys, DOUBLE keys through the f32 bitcast, keys
    with the top bit set, strings), the bucket scatter round trip, and the
    hash exchange under a group aggregation;
  * grouped aggregation over the exchange (merge-mode final, its overflow
    flag, DISTINCT through the raw-row exchange with int and string keys);
  * SQL: GROUP BY statements and shuffle joins (filters on both sides,
    string keys, skew, a three-table chain, DISTINCT over a join) through
    each package's Session with the mesh on, and the mesh-eligibility
    kinds;
  * the capacity ladder after an overflow (the rung salts the hash, so the
    order of the output groups shows that both packages retried alike).

Chunks are compared row by row in order, states value by value. Tolerance:
exact (integer and decimal data).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.parallel as JPar
import tidb_tpu.sql as JS
import tidb_tpu.types as JT
from tidb_tpu.codec import tablecodec as j_tablecodec
from tidb_tpu.expr.compile import CompVal as JCompVal
from tidb_tpu.mpp import dispatch as j_mppd
from tidb_tpu.parallel import exchange as j_ex
from tidb_tpu.util import metrics as j_metrics

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.parallel as TPar
import tidb_tpu_torch.sql as TS
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.codec import tablecodec as t_tablecodec
from tidb_tpu_torch.expr.compile import CompVal as TCompVal
from tidb_tpu_torch.mpp import dispatch as t_mppd
from tidb_tpu_torch.parallel import exchange as t_ex
from tidb_tpu_torch.util import metrics as t_metrics

CPU8 = ["cpu"] * 8

J = SimpleNamespace(
    name="jax", T=JT, C=JC, E=JE, X=JX, par=JPar, ex=j_ex, CompVal=JCompVal, mppd=j_mppd, metrics=j_metrics,
    tablecodec=j_tablecodec, mesh=lambda: JPar.region_mesh(), devs=lambda: jax.devices(),
    stack=lambda chunks, n_total: JPar.stack_region_batches(chunks, n_total=n_total),
    arr=jnp.asarray, session=lambda: JS.Session())
P = SimpleNamespace(
    name="torch", T=TT, C=TC, E=TE, X=TX, par=TPar, ex=t_ex, CompVal=TCompVal, mppd=t_mppd, metrics=t_metrics,
    tablecodec=t_tablecodec, mesh=lambda: TPar.region_mesh(CPU8), devs=lambda: CPU8,
    stack=lambda chunks, n_total: TPar.stack_region_batches(chunks, n_total=n_total, device="cpu"),
    arr=lambda a: torch.from_numpy(np.asarray(a)), session=lambda: TS.Session(device="cpu", mesh_devices=CPU8))


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def both(case):
    return case(J), case(P)


def npy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def states(st):
    """Merged partial states as plain values: [(value list, null list)]."""
    return [(npy(v).tolist(), npy(nl).tolist()) for v, nl in st]


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def region_chunks(pkg, n_regions=8, rows_per=37, seed=3):
    T = pkg.T
    fts = [T.new_longlong(), T.new_decimal(10, 2)]
    rng = np.random.default_rng(seed)
    chunks, all_rows = [], []
    for _ in range(n_regions):
        rows = []
        for _ in range(rows_per + int(rng.integers(0, 9))):
            rows.append([
                T.Datum.NULL if rng.random() < 0.05 else T.Datum.i64(int(rng.integers(0, 6))),
                T.Datum.NULL if rng.random() < 0.05
                else T.Datum.dec(T.MyDecimal(f"{int(rng.integers(-9999, 9999)) / 100:.2f}")),
            ])
        all_rows.extend(rows)
        chunks.append(pkg.C.Chunk.from_rows(fts, rows))
    return fts, chunks, all_rows


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = P.mesh()
    assert mesh.size == 8 and all(d.type == "cpu" for d in mesh.devices)


def test_sharded_scalar_partial_agg_psum():
    def case(pkg):
        E, X, T = pkg.E, pkg.X, pkg.T
        fts, chunks, all_rows = region_chunks(pkg)
        scan = E.TableScan(1, (E.ColumnInfo(1, fts[0]), E.ColumnInfo(2, fts[1])))
        pred = X.func("gt", T.new_longlong(notnull=True), X.col(0, fts[0]), X.lit(1, T.new_longlong()))
        agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("sum", (X.col(1, fts[1]),)), X.AggDesc("count", ()),
                                               X.AggDesc("avg", (X.col(1, fts[1]),))), partial=True)
        dag = E.DAGRequest((scan, E.Selection((pred,)), agg), output_offsets=(0, 1, 2, 3))
        st = states(pkg.par.run_sharded_partial_agg(dag, pkg.stack(chunks, 8), pkg.mesh()))
        want_nn = sum(1 for r in all_rows if not r[0].is_null() and r[0].val > 1 and not r[1].is_null())
        assert st[2][0] == [want_nn] and st[0][1] == [False]
        return st

    j, p = both(case)
    assert p == j


def test_hash_partition_stable_and_covering():
    def case(pkg):
        _fts, chunks, _ = region_chunks(pkg, 1, 64)
        db = pkg.C.to_device_batch(chunks[0], capacity=80) if pkg is J else \
            pkg.C.to_device_batch(chunks[0], capacity=80, device="cpu")
        from importlib import import_module

        norm = import_module(f"{pkg.CompVal.__module__}").normalize_device_column
        p = npy(pkg.ex.hash_partition_ids([norm(db.cols[0])], 8))
        assert ((p >= 0) & (p < 8)).all()
        vals, nulls = npy(db.cols[0].data), npy(db.cols[0].null)
        seen = {}
        for i in range(64):
            k = None if nulls[i] else int(vals[i])
            assert seen.setdefault(k, p[i]) == p[i]
        return p.tolist()

    j, p = both(case)
    assert p == j


def test_scatter_to_buckets_roundtrip():
    n, P_, cap = 50, 4, 32
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 100, n)
    valid = rng.random(n) < 0.9
    part = rng.integers(0, P_, n).astype(np.int32)

    def case(pkg):
        (bv,), bvalid, overflow = pkg.ex.scatter_to_buckets([pkg.arr(vals)], pkg.arr(valid), pkg.arr(part), P_, cap)
        assert not bool(overflow)
        bv, bvalid = npy(bv), npy(bvalid)
        got = sorted((p, int(bv[p, s])) for p in range(P_) for s in range(cap) if bvalid[p, s])
        assert got == sorted((int(part[i]), int(vals[i])) for i in range(n) if valid[i])
        return bv.tolist(), bvalid.tolist()

    j, p = both(case)
    assert p == j


def test_exchange_group_agg_all_to_all():
    """Each shard owns one hash partition after the all_to_all; per-key
    counts summed over the mesh match a host group-by, and each shard's
    owned counts match the JAX device's."""
    from jax.sharding import PartitionSpec as P_

    from tidb_tpu.parallel.compat import shard_map

    n_dev, rows_per = 8, 48
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 13, (n_dev, rows_per))
    valid = rng.random((n_dev, rows_per)) < 0.9
    kft_j, kft_t = JT.new_longlong(), TT.new_longlong()

    def device_fn(k, v):
        k, v = k[0], v[0]
        kv = JCompVal(k, jnp.zeros(k.shape, bool), kft_j)

        def agg_fn(cols, fvalid):
            onehot = (cols[0][:, None] == jnp.arange(13)[None, :]) & fvalid[:, None]
            return onehot.sum(axis=0)

        counts, overflow = j_ex.exchange_group_aggregate("region", [kv], agg_fn, [k], v, n_parts=n_dev,
                                                         bucket_cap=64)
        return counts[None], overflow[None]

    fn = shard_map(device_fn, mesh=J.mesh(), in_specs=(P_("region"), P_("region")),
                   out_specs=(P_("region"), P_("region")))
    j_counts, j_ovf = jax.jit(fn)(jnp.asarray(keys), jnp.asarray(valid))

    def agg_fn(cols, fvalid):
        onehot = (cols[0][:, None] == torch.arange(13)[None, :]) & fvalid[:, None]
        return onehot.sum(dim=0)

    kv = [[TCompVal(torch.from_numpy(keys[d]), torch.zeros(rows_per, dtype=torch.bool), kft_t)] for d in range(n_dev)]
    t_counts, t_ovf = t_ex.exchange_group_aggregate(
        [torch.device("cpu")] * n_dev, kv, agg_fn, [[torch.from_numpy(keys[d])] for d in range(n_dev)],
        [torch.from_numpy(valid[d]) for d in range(n_dev)], n_parts=n_dev, bucket_cap=64)
    assert not np.asarray(j_ovf).any() and not any(bool(o) for o in t_ovf)
    assert np.stack([c.numpy() for c in t_counts]).tolist() == np.asarray(j_counts).tolist()
    want = np.zeros(13, int)
    for d in range(n_dev):
        for i in range(rows_per):
            if valid[d, i]:
                want[keys[d, i]] += 1
    assert sum(c.numpy() for c in t_counts).tolist() == want.tolist()


@pytest.mark.parametrize("mode", ["broadcast", "passthrough"])
def test_broadcast_and_passthrough_exchange(mode):
    """Broadcast: every shard receives every shard's rows in shard order;
    passthrough: the same rows, valid on the target shard only."""
    from jax.sharding import PartitionSpec as P_

    from tidb_tpu.parallel.compat import shard_map

    n_dev, rows_per = 8, 5
    rng = np.random.default_rng(5)
    vals = rng.integers(-100, 100, (n_dev, rows_per))
    valid = rng.random((n_dev, rows_per)) < 0.7
    jfn = {"broadcast": lambda c, v: j_ex.broadcast_exchange("region", c, v),
           "passthrough": lambda c, v: j_ex.passthrough_exchange("region", c, v, target=2)}[mode]

    def device_fn(c, v):
        (out,), ov = jfn([c[0]], v[0])
        return out[None], ov[None]

    fn = shard_map(device_fn, mesh=J.mesh(), in_specs=(P_("region"), P_("region")),
                   out_specs=(P_("region"), P_("region")))
    j_cols, j_valid = (np.asarray(x) for x in jax.jit(fn)(jnp.asarray(vals), jnp.asarray(valid)))
    cpu = [torch.device("cpu")] * n_dev
    args = ([[torch.from_numpy(vals[d])] for d in range(n_dev)], [torch.from_numpy(valid[d]) for d in range(n_dev)])
    t_cols, t_valid = (t_ex.broadcast_exchange(cpu, *args) if mode == "broadcast"
                       else t_ex.passthrough_exchange(cpu, *args, target=2))
    assert np.stack([c[0].numpy() for c in t_cols]).tolist() == j_cols.tolist()
    assert np.stack([v.numpy() for v in t_valid]).tolist() == j_valid.tolist()
    assert j_cols[0].tolist() == vals.reshape(-1).tolist()


def test_sharded_min_max_first_merge():
    def case(pkg):
        E, X = pkg.E, pkg.X
        fts, chunks, all_rows = region_chunks(pkg, seed=7)
        scan = E.TableScan(1, (E.ColumnInfo(1, fts[0]), E.ColumnInfo(2, fts[1])))
        agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("min", (X.col(0, fts[0]),)),
                                               X.AggDesc("max", (X.col(1, fts[1]),)),
                                               X.AggDesc("first_row", (X.col(0, fts[0]),))), partial=True)
        dag = E.DAGRequest((scan, agg), output_offsets=(0, 1, 2))
        st = states(pkg.par.run_sharded_partial_agg(dag, pkg.stack(chunks, 8), pkg.mesh()))
        assert st[0][0] == [min(r[0].val for r in all_rows if not r[0].is_null())]
        assert st[2][0] == [1]
        return st

    j, p = both(case)
    assert p == j


@pytest.mark.parametrize("kind", ["double", "top_bit", "string"])
def test_hash_partition_keys(kind):
    """DOUBLE keys hash through the f32 bitcast (-0.0 == 0.0); BIGINT keys
    with the top bit set (signed and unsigned) and strings hash to the
    same partitions in both packages (one differing bit would move a row
    to another shard)."""
    if kind == "double":
        vals = np.array([1.5, -2.25, 0.0, -0.0, 1.5, 1e300, -3.0e-30, 7.0])
    elif kind == "top_bit":
        vals = np.array([-1, -(1 << 63), (1 << 63) - 1, -12345678901234, 1 << 62, 0, 5, -5], np.int64)
    else:
        vals = ["", "a", "ab", "abcdefgh", "abcdefghi", "x" * 32, "AB", "a"]
    nulls = np.zeros(len(vals), bool)
    nulls[-1] = True

    def case(pkg):
        T = pkg.T
        if kind == "double":
            cvs = [pkg.CompVal(pkg.arr(vals), pkg.arr(nulls), T.new_double())]
        elif kind == "top_bit":
            cvs = [pkg.CompVal(pkg.arr(vals), pkg.arr(nulls), T.new_longlong()),
                   pkg.CompVal(pkg.arr(vals), pkg.arr(nulls), T.new_longlong(unsigned=True))]
        else:
            ft = T.new_varchar(32)
            ch = pkg.C.Chunk.from_rows([ft], [[T.Datum.NULL if nulls[i] else T.Datum.string(v)]
                                              for i, v in enumerate(vals)])
            db = pkg.C.to_device_batch(ch, capacity=8) if pkg is J else \
                pkg.C.to_device_batch(ch, capacity=8, device="cpu")
            from importlib import import_module

            cvs = [import_module(pkg.CompVal.__module__).normalize_device_column(db.cols[0])]
        out = []
        for cv in cvs:
            pid = npy(pkg.ex.hash_partition_ids([cv], 8))
            assert ((0 <= pid) & (pid < 8)).all()
            out.append(pid.tolist())
        if kind == "double":
            assert out[0][0] == out[0][4] and out[0][2] == out[0][3]
        return out

    j, p = both(case)
    assert p == j


def test_sharded_unsigned_min_max_merge():
    big, small = (1 << 63) + 5, 10

    def case(pkg):
        E, X, T = pkg.E, pkg.X, pkg.T
        UFT = T.new_longlong(unsigned=True)
        chunks = [pkg.C.Chunk.from_rows([UFT], [[T.Datum.u64(big)]]),
                  pkg.C.Chunk.from_rows([UFT], [[T.Datum.u64(small)]])]
        scan = E.TableScan(1, (E.ColumnInfo(1, UFT),))
        agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("min", (X.col(0, UFT),)),
                                               X.AggDesc("max", (X.col(0, UFT),))), partial=True)
        dag = E.DAGRequest((scan, agg), output_offsets=(0, 1))
        st = states(pkg.par.run_sharded_partial_agg(dag, pkg.stack(chunks, 8), pkg.mesh()))
        assert st[0][0][0] & 0xFFFFFFFFFFFFFFFF == small and st[1][0][0] & 0xFFFFFFFFFFFFFFFF == big
        return st

    j, p = both(case)
    assert p == j


@pytest.mark.parametrize("which", ["skips_filtered_region", "keeps_null_value"])
def test_sharded_first_row(which):
    """A region whose rows all fail the filter contributes no first_row
    state; a legitimately NULL first value survives the merge."""
    def case(pkg):
        E, X, T = pkg.E, pkg.X, pkg.T
        FT = T.new_longlong()
        scan = E.TableScan(1, (E.ColumnInfo(1, FT),))
        agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("first_row", (X.col(0, FT),)),), partial=True)
        if which == "skips_filtered_region":
            chunks = [pkg.C.Chunk.from_rows([FT], [[T.Datum.i64(1)], [T.Datum.i64(2)]]),
                      pkg.C.Chunk.from_rows([FT], [[T.Datum.i64(500)], [T.Datum.i64(600)]])]
            pred = X.func("gt", T.new_longlong(notnull=True), X.col(0, FT), X.lit(100, T.new_longlong()))
            dag = E.DAGRequest((scan, E.Selection((pred,)), agg), output_offsets=(0,))
        else:
            chunks = [pkg.C.Chunk.from_rows([FT], [[T.Datum.NULL], [T.Datum.i64(2)]]),
                      pkg.C.Chunk.from_rows([FT], [[T.Datum.i64(500)]])]
            dag = E.DAGRequest((scan, agg), output_offsets=(0,))
        st = states(pkg.par.run_sharded_partial_agg(dag, pkg.stack(chunks, 8), pkg.mesh()))
        assert st[0][0] == [1]
        assert st[1] == (([500], [False]) if which == "skips_filtered_region" else (st[1][0], [True]))
        return st

    j, p = both(case)
    assert p == j


# ---------------------------------------------------------------------------
# grouped aggregation over the exchange
# ---------------------------------------------------------------------------

def grouped_setup(pkg, n_regions=8, seed=0, null_p=0.05):
    T = pkg.T
    fts = [T.new_longlong(), T.new_varchar(4), T.new_decimal(10, 2)]
    chunks, all_rows = [], []
    for i in range(n_regions):
        rng = np.random.default_rng(seed + i)
        rows = []
        for _ in range(30 + 3 * i):
            rows.append([
                T.Datum.i64(int(rng.integers(0, 7))) if rng.random() > null_p else T.Datum.NULL,
                T.Datum.string("AB"[int(rng.integers(2))] + "XY"[int(rng.integers(2))]),
                T.Datum.dec(T.MyDecimal(f"{int(rng.integers(-999, 999)) / 100:.2f}")),
            ])
        chunks.append(pkg.C.Chunk.from_rows(fts, rows))
        all_rows += rows
    return fts, chunks, all_rows


def grouped_dag(pkg, fts, shape):
    E, X, T = pkg.E, pkg.X, pkg.T
    C = lambda i: X.col(i, fts[i])  # noqa: E731
    scan = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    if shape == "five_aggs":
        sel = E.Selection((X.func("ge", T.new_longlong(notnull=True), C(2), X.lit("-5.00", T.new_decimal(3, 2))),))
        agg = E.Aggregation(group_by=(C(0), C(1)), aggs=(
            X.AggDesc("count", ()), X.AggDesc("sum", (C(2),)), X.AggDesc("avg", (C(2),)),
            X.AggDesc("min", (C(2),)), X.AggDesc("first_row", (C(0),))))
        return E.DAGRequest((scan, sel, agg), output_offsets=tuple(range(7)))
    if shape == "unique_decimals":
        agg = E.Aggregation(group_by=(C(2),), aggs=(X.AggDesc("count", ()),))
        return E.DAGRequest((scan, agg), output_offsets=(0, 1))
    if shape == "distinct":
        agg = E.Aggregation(group_by=(C(0),), aggs=(
            X.AggDesc("count", (C(2),), distinct=True), X.AggDesc("sum", (C(2),), distinct=True),
            X.AggDesc("count", ()), X.AggDesc("avg", (C(2),))))
        return E.DAGRequest((scan, agg), output_offsets=tuple(range(5)))
    agg = E.Aggregation(group_by=(C(1),), aggs=(X.AggDesc("count", (C(0),), distinct=True),))
    return E.DAGRequest((scan, agg), output_offsets=(0, 1))


@pytest.mark.parametrize("shape,gc,bcap", [("five_aggs", 64, None), ("distinct", 128, 512),
                                           ("distinct_string_key", 64, 512)])
def test_mesh_grouped_agg_matches_oracle(shape, gc, bcap):
    """Partial1 -> all_to_all state exchange -> Final merge (or the
    raw-row exchange for DISTINCT), against the oracle and the JAX
    package, row by row in order."""
    def case(pkg):
        fts, chunks, _ = grouped_setup(pkg)
        dag = grouped_dag(pkg, fts, shape)
        chunk, overflow = pkg.par.run_sharded_grouped_agg(dag, pkg.stack(chunks, 8), pkg.mesh(), group_capacity=gc,
                                                          bucket_cap=bcap)
        assert not overflow
        from importlib import import_module

        datum_group_key = import_module(pkg.E.__name__ + ".executor").datum_group_key
        ref = pkg.E.run_dag_reference(dag, pkg.C.Chunk.concat(chunks))
        key = (lambda rows: sorted(tuple(str(datum_group_key(d)) for d in r) for r in rows))
        assert key(chunk.rows()) == key(ref)
        return canon(chunk.rows())

    j, p = both(case)
    assert p == j


def test_mesh_grouped_agg_overflow_flag():
    def case(pkg):
        fts, chunks, _ = grouped_setup(pkg)
        _, overflow = pkg.par.run_sharded_grouped_agg(grouped_dag(pkg, fts, "unique_decimals"),
                                                      pkg.stack(chunks, 8), pkg.mesh(), group_capacity=8)
        return overflow

    assert both(case) == (True, True)


def test_ladder_bytes_after_an_overflow():
    """execute_exchange_plan at a group capacity the Partial1 tables
    overflow: the ladder retries (scale, then capacity, which salts the
    group hash) and both packages end on the same rung with the same rows
    in the same order; the repeat starts at the remembered rung."""
    def case(pkg):
        fts, chunks, _ = grouped_setup(pkg, seed=5)
        dag = grouped_dag(pkg, fts, "unique_decimals")
        m0 = pkg.metrics.MESH_SELECTS.value
        out = pkg.mppd.execute_exchange_plan(dag, chunks, None, "agg", pkg.devs(), group_capacity=16)
        assert out is not None and pkg.metrics.MESH_SELECTS.value == m0 + 1
        again = pkg.mppd.execute_exchange_plan(dag, chunks, None, "agg", pkg.devs(), group_capacity=16)
        assert canon(again.rows()) == canon(out.rows())
        from tidb_tpu.codec.wire import encode_dag as j_enc
        from tidb_tpu_torch.codec.wire import encode_dag as t_enc

        enc = j_enc if pkg is J else t_enc
        rung = pkg.mppd._LADDER_HINTS[(enc(dag), 8, 16)]
        assert rung != (16, 1)
        return rung, canon(out.rows())

    j, p = both(case)
    assert p == j


# ---------------------------------------------------------------------------
# SQL over the mesh: each package's Session, mesh on
# ---------------------------------------------------------------------------

def run_sql(setup, statements, min_mesh: int = 1):
    """Run `setup(session, pkg)` then each statement through both
    packages' sessions with the mesh on; rows must agree in order, and the
    port's mesh select must have served each statement (MESH_SELECTS)."""
    out = {}
    for pkg in (J, P):
        s = pkg.session()
        setup(s, pkg)
        got = []
        for q in statements:
            m0 = pkg.metrics.MESH_SELECTS.value
            got.append(canon(s.execute(q).rows))
            if pkg is P:
                assert pkg.metrics.MESH_SELECTS.value - m0 >= min_mesh, f"not on the mesh: {q}"
        s.execute("set tidb_enable_tpu_mesh = OFF")
        off = [sorted(canon(s.execute(q).rows), key=str) for q in statements]
        assert [sorted(g, key=str) for g in got] == off
        out[pkg.name] = got
    assert out["torch"] == out["jax"]
    return out["torch"]


def setup_m(s, pkg):
    s.execute("create table m (g varchar(4), k bigint, v decimal(10,2))")
    s.execute("insert into m values " + ",".join(f"('{'abcd'[i % 4]}', {i % 11}, {i}.25)" for i in range(400)))
    tid = s.catalog.table("m").table_id
    for h in (100, 200, 300):
        s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))


class TestMeshSQL:
    def test_group_by_runs_on_mesh(self):
        rows = run_sql(setup_m, ["select g, count(*), sum(v), min(k) from m group by g"])
        assert sorted(r[0] for r in rows[0]) == ["a", "b", "c", "d"]

    def test_mesh_matches_threadpool_path(self):
        run_sql(setup_m, ["select k, count(*), avg(v), max(v) from m where k > 2 group by k"])

    def test_string_first_row_over_exchange(self):
        rows = run_sql(setup_m, ["select g, min(g), max(g) from m group by g"])
        assert sorted(rows[0]) == [("a", "a", "a"), ("b", "b", "b"), ("c", "c", "c"), ("d", "d", "d")]


def setup_join(s, pkg, n_rows=400, n_orders=37):
    s.execute("create table ords (o_id bigint primary key, flag varchar(2), odate bigint)")
    s.execute("insert into ords values " + ",".join(
        f"({i}, '{'xy'[i % 2]}{chr(97 + i % 3)}', {1000 + i % 7})" for i in range(n_orders)))
    s.execute("create table items (i_id bigint primary key, oid bigint, v decimal(10,2))")
    s.execute("insert into items values " + ",".join(
        f"({i}, {(i * 7) % (n_orders + 5)}, {i}.50)" for i in range(n_rows)))
    tid = s.catalog.table("items").table_id
    for h in (100, 200, 300):
        s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))


def setup_skew(s, pkg):
    s.execute("create table ords (o_id bigint primary key, flag varchar(2))")
    s.execute("insert into ords values (1, 'x'), (2, 'y')")
    s.execute("create table items (i_id bigint primary key, oid bigint)")
    s.execute("insert into items values " + ",".join(f"({i}, 1)" for i in range(300)))
    tid = s.catalog.table("items").table_id
    for h in (100, 200):
        s.store.cluster.split(pkg.tablecodec.encode_row_key(tid, h))


class TestMeshShuffleJoin:
    def test_inner_join_group_by_over_mesh(self):
        run_sql(setup_join, ["select flag, count(*), sum(v), min(i_id) from items join ords on oid = o_id "
                             "group by flag"])

    def test_join_with_filters_both_sides(self):
        run_sql(setup_join, ["select odate, count(*), sum(v) from items join ords on oid = o_id "
                             "where v > 20 and odate < 1005 group by odate"])

    def test_join_group_by_build_side_string_key(self):
        run_sql(setup_join, ["select flag, count(*) from items join ords on oid = o_id group by flag, odate"])

    def test_skewed_keys_match(self):
        rows = run_sql(setup_skew, ["select flag, count(*) from items join ords on oid = o_id group by flag"])
        assert rows == [[("x", "300")]]

    def test_multidevice_mesh_eligibility_kinds(self):
        def kinds(pkg):
            from importlib import import_module

            s = pkg.session()
            setup_join(s, pkg)
            sql = import_module(pkg.par.__name__ + ".sql")
            planner = import_module(pkg.T.__name__.rsplit(".", 1)[0] + ".sql.planner")
            parse_one = import_module(pkg.T.__name__.rsplit(".", 1)[0] + ".parser").parse_one
            return [sql.mesh_eligible(planner.plan_select(parse_one(q), s.catalog).dag) for q in (
                "select flag, count(*) from items join ords on oid = o_id group by flag",
                "select oid, count(*) from items group by oid",
                "select flag, count(distinct v) from items join ords on oid = o_id group by flag",
                "select oid, group_concat(v) from items group by oid")]

        j, p = both(kinds)
        assert p == j == ["join", "agg", "join", None]


def setup_chain(s, pkg, nl=600, no=40, nc=12):
    s.execute("create table cust (c_id bigint primary key, seg varchar(2))")
    s.execute("insert into cust values " + ",".join(f"({i}, '{'AB'[i % 2]}')" for i in range(nc)))
    s.execute("create table ords (o_id bigint primary key, ckey bigint, odate bigint)")
    s.execute("insert into ords values " + ",".join(f"({i}, {i % nc}, {1000 + i % 9})" for i in range(no)))
    s.execute("create table items (i_id bigint primary key, oid bigint, v decimal(10,2))")
    s.execute("insert into items values " + ",".join(f"({i}, {(i * 3) % (no + 4)}, {i}.25)" for i in range(nl)))


class TestMeshJoinChain:
    def test_three_table_chain_on_mesh(self):
        run_sql(setup_chain, ["select oid, count(*), sum(v) from items join ords on oid = o_id "
                              "join cust on ckey = c_id where seg = 'B' and odate < 1007 group by oid"])

    def test_chain_distinct_on_mesh(self):
        run_sql(setup_chain, ["select ckey, count(distinct oid) from items join ords on oid = o_id group by ckey"])
