"""The sort-free small-G GROUP BY route (tidb_tpu_torch/ops/aggregate.py
_group_aggregate_dense, ops/seg.py DenseCtx / DenseSumBatch) against the
JAX package's XLA route (tidb_tpu/ops/aggregate.py _group_aggregate_dense)
on the CPU, over the same numpy-seeded inputs.

The JAX package takes that route for every hinted GROUP BY on the CPU
(its Pallas kernel is off there), so the reference here is its plain
hinted call; where the port's one-pass kernel (K1, hint <= 32 with an
eligible mix) takes the call instead, the reference is the JAX kernel in
Pallas interpret mode, which K1 replaces. Equality: overflow, n_groups,
group_rep[:ng] and every state bit for bit, except DOUBLE sums, which
each package adds in its own order: 1e-12 relative, as tests/test_ops.py
holds the JAX package's own two routes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.expr import AggDesc as JAgg
from tidb_tpu.expr import col as jcol
from tidb_tpu.expr.compile import CompVal as JCompVal
from tidb_tpu.ops.aggregate import group_aggregate as j_group_aggregate
from tidb_tpu.util import metrics as j_metrics

import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
from tidb_tpu_torch.exec.executor import drive_program_info as t_drive
from tidb_tpu_torch.expr import AggDesc as TAgg
from tidb_tpu_torch.expr.compile import CompVal as TCompVal
from tidb_tpu_torch.interop import device_batch_from_numpy
from tidb_tpu_torch.ops import aggregate as TA
from tidb_tpu_torch.ops import dense_agg as K1
from tidb_tpu_torch.ops import seg as TS
from tidb_tpu_torch.ops.aggregate import group_aggregate as t_group_aggregate
from tidb_tpu_torch.util import metrics as t_metrics

from test_ops import eval_vals, make_data
from test_torch_dense_agg import _jax_aggs, _port_aggs, _port_ft, _port_vals

I64_MAX = (1 << 63) - 1


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    """The JAX package's CPU default: no Pallas kernel, the XLA route."""
    monkeypatch.delenv("TIDB_TPU_PALLAS", raising=False)


class Routes:
    """The port's route counters across one call."""

    def __enter__(self):
        self.k1, self.dense = K1.dense_agg.launches, TA._group_aggregate_dense.launches
        return self

    def __exit__(self, *exc):
        self.k1 = K1.dense_agg.launches - self.k1
        self.dense = TA._group_aggregate_dense.launches - self.dense


def assert_same(ref, got, flag_only=False):
    """JAX result (ref) == port result (got): bit for bit over [:ng], DOUBLE
    states within 1e-12 relative."""
    assert bool(got.overflow) == bool(ref.overflow)
    ng = int(ref.n_groups)
    assert int(got.n_groups) == ng
    if flag_only:
        return
    assert np.array_equal(got.group_rep[:ng].numpy(), np.asarray(ref.group_rep[:ng]))
    assert np.array_equal(got.group_valid.numpy(), np.asarray(ref.group_valid))
    assert len(got.states) == len(ref.states)
    for rs, ps in zip(ref.states, got.states):
        if hasattr(rs, "idx"):
            assert np.array_equal(ps.idx[:ng].numpy(), np.asarray(rs.idx[:ng]))
            assert np.array_equal(ps.has[:ng].numpy(), np.asarray(rs.has[:ng]))
            continue
        assert len(rs) == len(ps)
        for (rv, rn), (pv, pn) in zip(rs, ps):
            rv, pv = np.asarray(rv[:ng]), pv[:ng].numpy()
            assert pv.dtype == rv.dtype
            if rv.dtype.kind == "f":
                assert np.allclose(pv, rv, rtol=1e-12, atol=0.0), (pv, rv)
            else:
                assert np.array_equal(pv, rv), (pv, rv)
            assert np.array_equal(pn[:ng].numpy(), np.asarray(rn[:ng]))


def run_data(jfts, jch, idxs, key_pos, spec, hint, valid_np=None, merge=False, cap=64):
    """Both packages' hinted group_aggregate over columns `idxs` of a JAX
    chunk; spec: [(agg name, arg column, position in idxs)]. Returns
    (ref, got, Routes)."""
    db, jvals = eval_vals(jfts, jch, [jcol(i, jfts[i]) for i in idxs])
    tfts, tdb, tvals = _port_vals(jfts, jch, idxs)
    jvalid, tvalid = db.row_valid, tdb.row_valid
    if valid_np is not None:
        jvalid = jvalid & jnp.asarray(valid_np)
        tvalid = tvalid & torch.from_numpy(valid_np)
    jaggs, taggs = _jax_aggs(spec, jfts, jvals), _port_aggs(spec, tfts, tvals)
    ref = j_group_aggregate([jvals[p] for p in key_pos], jaggs, jvalid, cap, merge=merge, small_groups=hint)
    with Routes() as routes:
        got = t_group_aggregate([tvals[p] for p in key_pos], taggs, tvalid, cap, merge=merge, small_groups=hint)
    return ref, got, routes


def both_vals(arrays):
    """[(numpy value, numpy null, JAX field type)] -> (JAX CompVals, port
    CompVals) over the same bytes."""
    j = [JCompVal(jnp.asarray(v), jnp.asarray(nl), ft) for v, nl, ft in arrays]
    t = [TCompVal(torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(np.ascontiguousarray(nl)), _port_ft(ft))
         for v, nl, ft in arrays]
    return j, t


def run_vals(keys, args, spec, valid, hint, merge=False, cap=64):
    """Both packages over explicit CompVals. keys / args: [(value, null,
    JAX ft)]; spec: [(agg name, [indices into args])]."""
    jk, tk = both_vals(keys)
    ja, ta = both_vals(args)
    jaggs = [(JAgg(name, tuple(jcol(i, a.ft) for i, a in ((i, ja[i]) for i in ix))), [ja[i] for i in ix])
             for name, ix in spec]
    taggs = [(TAgg(name, tuple(TX.col(i, a.ft) for i, a in ((i, ta[i]) for i in ix))), [ta[i] for i in ix])
             for name, ix in spec]
    ref = j_group_aggregate(jk, jaggs, jnp.asarray(valid), cap, merge=merge, small_groups=hint)
    with Routes() as routes:
        got = t_group_aggregate(tk, taggs, torch.from_numpy(valid), cap, merge=merge, small_groups=hint)
    return ref, got, routes


LL, DEC, DBL = JT.new_longlong(), JT.new_decimal(15, 2), JT.new_double()


# ---------------------------------------------------------------------------
# tests/test_ops.py TestDenseSmallG, the port beside the JAX package
# ---------------------------------------------------------------------------

FIVE_AGGS = [("count", None, None), ("sum", 1, 1), ("avg", 2, 2), ("min", 1, 1), ("first_row", 0, 0)]


@pytest.mark.parametrize("hint", [8, 64, 128, 512])
def test_filtered_rows_count_sum_avg_min_first_row(hint):
    fts, ch = make_data(n=200, k_card=5)
    valid = np.random.default_rng(3).random(200) < 0.8
    ref, got, routes = run_data(fts, ch, [0, 1, 2], [0], FIVE_AGGS, hint, valid)
    assert not bool(ref.overflow) and int(ref.n_groups) == 6
    assert_same(ref, got)
    assert (routes.dense, routes.k1) == (1, 0)


def _sample_missed(n=8192):
    """A group living only at index 1: with 8,192 rows the sample's stride
    is 2, so the distinct-hash table never sees it."""
    vals = np.zeros(n, np.int64)
    vals[1] = 77
    z = np.zeros(n, bool)
    return [(vals, z, LL)], [(np.arange(n, dtype=np.int64), z, LL)], np.ones(n, bool)


@pytest.mark.parametrize("hint, spec", [(8, [("count", []), ("min", [0])]), (64, [("count", [])]),
                                        (512, [("count", []), ("sum", [0])])])
def test_sample_missed_group_overflows(hint, spec):
    keys, args, valid = _sample_missed()
    ref, got, routes = run_vals(keys, args, spec, valid, hint)
    assert bool(ref.overflow) and bool(got.overflow)
    assert_same(ref, got)
    assert (routes.dense, routes.k1) == (1, 0)


def test_sample_missed_group_on_k1_matches_the_pallas_kernel(monkeypatch):
    """count(*) at hint 8 is K1's: it sees every row, as the JAX Pallas
    kernel it replaces does, so neither overflows."""
    monkeypatch.setenv("TIDB_TPU_PALLAS", "interpret")
    keys, args, valid = _sample_missed()
    ref, got, routes = run_vals(keys, args, [("count", [])], valid, 8)
    assert not bool(ref.overflow)
    assert_same(ref, got)
    assert routes.dense == 0


@pytest.mark.parametrize("hint", [8, 64])
def test_limb_sums_exact_at_scale(hint):
    """2^14 rows in +-2^45 over six groups: the limb product (hint 64) and
    K1 (hint 8) equal the JAX route and numpy."""
    n = 1 << 14
    rng = np.random.default_rng(9)
    g = rng.integers(0, 6, n).astype(np.int64)
    v = rng.integers(-(1 << 45), 1 << 45, n).astype(np.int64)
    z = np.zeros(n, bool)
    ref, got, routes = run_vals([(g, z, LL)], [(v, z, LL)], [("count", []), ("sum", [0])], np.ones(n, bool), hint)
    assert not bool(got.overflow)
    assert_same(ref, got)
    assert (routes.dense, routes.k1) == ((1, 0) if hint == 64 else (0, 0))
    rep = got.group_rep[: int(got.n_groups)].numpy()
    for i, r in enumerate(rep):
        m = g == g[r]
        assert int(got.states[0][0][0][i]) == int(m.sum())
        assert int(got.states[1][0][0][i]) == int(v[m].sum())


def test_wrong_hint_overflows():
    fts, ch = make_data(n=200, k_card=50)
    ref, got, routes = run_data(fts, ch, [0], [0], [("count", None, None)], 4)
    assert bool(ref.overflow)
    assert_same(ref, got, flag_only=True)
    assert routes.k1 == 0 and routes.dense == 0  # K1's plain version on the CPU


def test_fifty_groups_at_hint_four():
    """200 rows in 50 groups, hint 4, COUNT(*) and MIN: the JAX route
    overflows with n_groups 4; before the route was ported the port took
    the sort path and answered 50 groups with no overflow."""
    fts, ch = make_data(n=200, k_card=50)
    ref, got, routes = run_data(fts, ch, [0, 1], [0], [("count", None, None), ("min", 1, 1)], 4)
    assert bool(ref.overflow) and int(ref.n_groups) == 4
    assert_same(ref, got)
    assert routes.dense == 1


# ---------------------------------------------------------------------------
# hints, aggregate kinds and modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hint", [64, 128, 512])
@pytest.mark.parametrize("keys", ["int", "string", "int and string"])
def test_hints_and_keys(hint, keys):
    fts, ch = make_data(n=300, k_card=41, null_p=0.15)
    key_pos = {"int": [0], "string": [3], "int and string": [0, 3]}[keys]
    spec = [("count", None, None), ("sum", 1, 1), ("avg", 1, 1), ("max", 1, 1), ("min", 2, 2), ("count", 2, 2)]
    valid = np.random.default_rng(hint).random(300) < 0.9
    ref, got, routes = run_data(fts, ch, [0, 1, 2, 3], key_pos, spec, hint, valid)
    assert_same(ref, got)
    assert routes.dense == 1


@pytest.mark.parametrize("name", ["bit_and", "bit_or", "bit_xor"])
@pytest.mark.parametrize("unsigned", [False, True])
def test_bitwise(name, unsigned):
    n = 777
    rng = np.random.default_rng(len(name) + unsigned)
    g = rng.integers(0, 40, n).astype(np.int64)
    v = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    nl = rng.random(n) < 0.2
    ft = JT.new_longlong(unsigned=unsigned)
    valid = rng.random(n) < 0.9
    ref, got, routes = run_vals([(g, np.zeros(n, bool), LL)], [(v, nl, ft)], [(name, [0]), ("count", [0])], valid, 64)
    assert not bool(ref.overflow)
    assert_same(ref, got)
    assert routes.dense == 1


@pytest.mark.parametrize("name", ["var_pop", "var_samp", "stddev_pop", "stddev_samp"])
@pytest.mark.parametrize("arg", [1, 2])
def test_var_stddev(name, arg):
    fts, ch = make_data(n=300, k_card=41)
    ref, got, routes = run_data(fts, ch, [0, 1, 2], [0], [(name, arg, arg), ("sum", 2, 2)], 64)
    assert_same(ref, got)
    assert routes.dense == 1


@pytest.mark.parametrize("n", [300, 512])
def test_double_sum_avg(n):
    """300 rows in 41 groups at hint 64 (the masked sums) and 512 (a
    multiple of 256: integer states through the limb product)."""
    fts, ch = make_data(n=n, k_card=41)
    ref, got, routes = run_data(fts, ch, [0, 1, 2], [0], [("sum", 2, 2), ("avg", 2, 2), ("avg", 1, 1)], 64)
    assert not bool(ref.overflow)
    assert_same(ref, got)
    assert routes.dense == 1


def _merge_inputs(n, seed):
    rng = np.random.default_rng(seed)
    z = np.zeros(n, bool)
    keys = [(rng.integers(0, 12, n).astype(np.int64), rng.random(n) < 0.05, LL)]  # 13 groups
    cnt = rng.integers(0, 50, n).astype(np.int64)
    args = [
        (cnt, z, LL),                                                      # 0 count state
        (rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64), rng.random(n) < 0.2, DEC),  # 1 decimal sum
        (np.round(rng.normal(size=n), 4), rng.random(n) < 0.2, DBL),       # 2 real sum
        (np.abs(np.round(rng.normal(size=n), 4)) * 9, z, DBL),             # 3 real sum of squares
        (rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64), rng.random(n) < 0.2, LL),  # 4 int value
        ((cnt > 10).astype(np.int64), z, LL),                              # 5 first_row's has
    ]
    return keys, args, rng.random(n) < 0.9


MERGE_SPECS = {
    "count": [("count", [0])],
    "sum": [("sum", [1]), ("sum", [2])],
    "avg": [("avg", [0, 1]), ("avg", [0, 2])],
    "min max": [("min", [4]), ("max", [2])],
    "var": [("var_pop", [0, 2, 3]), ("stddev_samp", [0, 2, 3])],
    "bit": [("bit_and", [4]), ("bit_or", [4]), ("bit_xor", [4])],
    "first_row": [("first_row", [5, 4])],
}


@pytest.mark.parametrize("case", list(MERGE_SPECS))
@pytest.mark.parametrize("hint", [16, 64])
def test_merge_mode(case, hint):
    keys, args, valid = _merge_inputs(512, len(case) + hint)
    ref, got, routes = run_vals(keys, args, MERGE_SPECS[case], valid, hint, merge=True)
    assert not bool(ref.overflow)
    assert_same(ref, got)
    assert (routes.dense, routes.k1) == (1, 0)


# ---------------------------------------------------------------------------
# what stays on the sort path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [[("count", 1, 1)], [("min", 3, 3)], [("sum", 1, 1), ("max", 3, 3)]],
                         ids=["distinct count", "string min", "string max"])
def test_distinct_and_string_min_max_stay_on_the_sort_path(spec):
    fts, ch = make_data(n=300, k_card=6)
    db, jvals = eval_vals(fts, ch, [jcol(i, fts[i]) for i in range(4)])
    tfts, tdb, tvals = _port_vals(fts, ch, range(4))
    distinct = spec[0][0] == "count"
    jaggs = [(JAgg(n, (jcol(c, fts[c]),), distinct=distinct), [jvals[v]]) for n, c, v in spec]
    taggs = [(TAgg(n, (TX.col(c, tfts[c]),), distinct=distinct), [tvals[v]]) for n, c, v in spec]
    assert not TA._dense_eligible(taggs, merge=False)
    ref = j_group_aggregate([jvals[0]], jaggs, db.row_valid, 64, small_groups=64)
    with Routes() as routes:
        got = t_group_aggregate([tvals[0]], taggs, tdb.row_valid, 64, small_groups=64)
    assert_same(ref, got)
    assert routes.dense == 0


def test_group_concat_is_refused_by_both():
    fts, ch = make_data(n=50, k_card=4)
    db, jvals = eval_vals(fts, ch, [jcol(0, fts[0]), jcol(3, fts[3])])
    tfts, tdb, tvals = _port_vals(fts, ch, [0, 3])
    with pytest.raises(NotImplementedError):
        j_group_aggregate([jvals[0]], [(JAgg("group_concat", (jcol(3, fts[3]),)), [jvals[1]])], db.row_valid, 64,
                          small_groups=64)
    with Routes() as routes, pytest.raises(NotImplementedError):
        t_group_aggregate([tvals[0]], [(TAgg("group_concat", (TX.col(3, tfts[3]),)), [tvals[1]])], tdb.row_valid, 64,
                          small_groups=64)
    assert routes.dense == 0


# ---------------------------------------------------------------------------
# the route's own machinery
# ---------------------------------------------------------------------------

def _serial_table(hp, g_cap):
    """The JAX package's extraction, in numpy: g_cap serial minima of the
    strided sample."""
    cur = hp[:: max(len(hp) // 4096, 1)].copy()
    tbl = []
    for _ in range(g_cap):
        m = cur.min()
        tbl.append(m)
        cur[cur == m] = I64_MAX
    return np.array(tbl, np.int64), cur.min() != I64_MAX


@pytest.mark.parametrize("n, k, g_cap", [(100, 7, 16), (5000, 40, 64), (8192, 600, 512), (9000, 70, 64),
                                         (3, 1, 16), (4096, 512, 512)])
def test_table_equals_the_serial_extraction(n, k, g_cap):
    rng = np.random.default_rng(n + k)
    salt = rng.integers(0, 1 << 61, k) * 2
    hp = np.where(rng.random(n) < 0.1, I64_MAX, salt[rng.integers(0, k, n)]).astype(np.int64)
    want_tbl, want_ovf = _serial_table(hp, g_cap)
    tbl, n_groups, overflow = TA._dense_table(torch.from_numpy(hp), g_cap)
    assert np.array_equal(tbl.numpy(), want_tbl)
    assert int(n_groups) == int((want_tbl != I64_MAX).sum())
    assert bool(overflow) == bool(want_ovf)


def _q1_like(n, seed=4):
    fts, ch = make_data(n=n, k_card=300, seed=seed)
    return fts, ch, [("count", None, None), ("sum", 1, 1), ("avg", 2, 2), ("min", 1, 1), ("bit_xor", 0, 0),
                     ("first_row", 1, 1)]


def _port_call(fts, ch, spec, hint):
    tfts, tdb, tvals = _port_vals(fts, ch, range(3))
    return t_group_aggregate([tvals[0]], _port_aggs(spec, tfts, tvals), tdb.row_valid, 64, small_groups=hint)


def _flat(res):
    out = [res.group_rep, res.group_valid, res.n_groups, res.overflow]
    for st in res.states:
        out += [st.idx, st.has] if hasattr(st, "idx") else [x for pair in st for x in pair]
    return out


def test_blocks_change_nothing_and_keep_their_budget(monkeypatch):
    """A budget small enough for many blocks gives the same bytes (DOUBLE
    sums, added block by block, within 1e-12 relative); every [rows, G]
    intermediate the route makes stays inside the budget."""
    from tidb_tpu_torch.analysis.progaudit import record

    fts, ch, spec = _q1_like(4096)
    whole = _port_call(fts, ch, spec, 512)
    budget = 513 * 8 * 512  # 512 rows a block at nseg 513
    monkeypatch.setattr(TS, "DENSE_BLOCK_BYTES", budget)
    assert TS.dense_block_rows(513) == 512
    blocked, recs = record(lambda: _port_call(fts, ch, spec, 512), ())
    for a, b in zip(_flat(whole), _flat(blocked)):
        if a.is_floating_point():
            assert torch.allclose(a, b, rtol=1e-12, atol=0.0)
        else:
            assert torch.equal(a, b)
    wide = [(r.name, shape) for r in recs for _dt, shape, _dev in r.outs if len(shape) == 2 and shape[-1] == 513]
    assert wide
    assert all(shape[0] * shape[1] * 8 <= budget for _name, shape in wide), wide
    with TS.dense_lanes(4):
        assert TS.dense_block_rows(513) == 256  # four lanes share it; 256 rows at least


def test_no_host_sync():
    """No scalar read and no data-sized output inside the route."""
    from tidb_tpu_torch.analysis.progaudit import _is_sync, record

    fts, ch, spec = _q1_like(1024)
    _res, recs = record(lambda: _port_call(fts, ch, spec, 64), ())
    assert [r.name for r in recs if _is_sync(r)] == []


def test_three_lanes_under_vmap_equal_three_single_calls():
    n, lanes = 1024, 3
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 50, (lanes, n)).astype(np.int64)
    keys[2] = rng.integers(0, 70, n)  # lane 2: more keys than the hint, its flag alone fires
    vals = rng.integers(-(1 << 50), 1 << 50, (lanes, n)).astype(np.int64)
    nulls = rng.random((lanes, n)) < 0.1
    valid = rng.random((lanes, n)) < 0.9
    dbl = np.round(rng.normal(size=(lanes, n)), 4)
    ft_ll, ft_dbl = _port_ft(LL), _port_ft(DBL)
    specs = [("count", 0), ("sum", 1), ("avg", 2), ("min", 1), ("bit_or", 1), ("first_row", 1)]

    def one(k, v, nl, d, va):
        key = TCompVal(k, torch.zeros_like(nl), ft_ll)
        a = TCompVal(v, nl, ft_ll)
        r = TCompVal(d, nl, ft_dbl)
        args = {0: [], 1: [a], 2: [r]}
        aggs = [(TAgg(name, tuple(TX.col(0, x.ft) for x in args[ix])), args[ix]) for name, ix in specs]
        return tuple(_flat(t_group_aggregate([key], aggs, va, 128, small_groups=64)))

    T = torch.from_numpy
    with Routes() as routes:
        batched = torch.func.vmap(one)(T(keys), T(vals), T(nulls), T(dbl), T(valid))
    assert routes.dense == 1
    assert batched[3].tolist() == [False, False, True]
    for b in range(lanes):
        single = one(T(keys[b]), T(vals[b]), T(nulls[b]), T(dbl[b]), T(valid[b]))
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y)


# ---------------------------------------------------------------------------
# the program driver: a hint that is too small costs a retry in both
# ---------------------------------------------------------------------------

def _grouped_dag(exec_mod, expr_mod, types_mod, with_min: bool):
    """GROUP BY qty, rflag (50 x 3 groups) over make_tables' columns:
    count(*), sum(price) and, with_min, min(price)."""
    T = types_mod
    D15, V1 = T.new_decimal(15, 2), T.new_varchar(1)
    fts = [V1, V1, D15, D15, D15, T.new_datetime()]
    scan = exec_mod.TableScan(2, tuple(exec_mod.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    C = [expr_mod.col(i, ft) for i, ft in enumerate(fts)]
    aggs = (expr_mod.AggDesc("count", ()), expr_mod.AggDesc("sum", (C[3],)))
    if with_min:
        aggs += (expr_mod.AggDesc("min", (C[3],)),)
    agg = exec_mod.Aggregation(group_by=(C[2], C[0]), aggs=aggs)
    return exec_mod.DAGRequest((scan, agg), output_offsets=tuple(range(len(aggs) + 2))), fts


def _canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


@pytest.mark.parametrize("case", ["hint 64 over 150 groups", "hint 16 with MIN over 150 groups",
                                  "Q1, hint 64", "Q1, hint 512"])
def test_driver_launches_and_rows_equal_the_jax_package(case):
    from tidb_tpu.chunk.device import DeviceBatch as JBatch
    from tidb_tpu.chunk.device import DeviceColumn as JColumn
    from tidb_tpu.exec.builder import ProgramCache as JCache
    from tidb_tpu.exec.executor import drive_program_info as j_drive

    n = 3000
    t = W.make_tables(n, seed=2)
    if case.startswith("Q1"):
        build, cols, hint = W.q1_dag, W.q1_columns(t), int(case.split()[-1])
        retries = 0
    else:
        with_min = "MIN" in case

        def build(e, x, tt):
            return _grouped_dag(e, x, tt, with_min)

        cols, hint, retries = W.q1_columns(t), (16 if with_min else 64), 1
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    jb = JBatch([JColumn(jnp.asarray(d), jnp.asarray(nl), jnp.asarray(ln) if ln is not None else None, ft)
                 for (d, nl, ln), ft in zip(cols, jfts)], jnp.ones(n, bool), jnp.int32(n))
    tb = device_batch_from_numpy(cols, np.ones(n, bool), n, tfts, device="cpu")
    j0 = j_metrics.PROGRAM_LAUNCHES.value
    jchunk, jcounts, _ = j_drive(JCache(), jdag, jb, 256, small_groups=hint)
    j_launches = j_metrics.PROGRAM_LAUNCHES.value - j0
    t0 = t_metrics.PROGRAM_LAUNCHES.value
    with Routes() as routes:
        tchunk, tcounts, _ = t_drive(TCache(), tdag, tb, 256, small_groups=hint)
    t_launches = t_metrics.PROGRAM_LAUNCHES.value - t0
    assert t_launches == j_launches == 1 + retries
    assert routes.dense == 1 and routes.k1 == 0
    got = _canon(tchunk.rows())
    assert got == _canon(jchunk.rows())
    assert got == _canon(JE.run_dag_reference(jdag, W.make_chunk(JC, jfts, cols)))
    assert tcounts == jcounts


# ---------------------------------------------------------------------------
# compile_exprs
# ---------------------------------------------------------------------------

def test_compile_exprs_matches_the_jax_package():
    from tidb_tpu.expr import compile_exprs as j_compile

    fts, ch = make_data(n=100, k_card=9)
    db, _ = eval_vals(fts, ch, [])
    tfts, tdb, _ = _port_vals(fts, ch, [])

    def exprs(X, T, f):
        return [X.func("plus", T.new_decimal(11, 2), X.col(1, f[1]), X.col(0, f[0])),
                X.func("mul", T.new_double(), X.col(2, f[2]), X.col(2, f[2])),
                X.func("gt", T.new_longlong(), X.col(0, f[0]), X.lit(3, T.new_longlong()))]

    jc = j_compile(fts, exprs(JX, JT, fts))
    tc = TX.compile_exprs(tfts, exprs(TX, TT, tfts), device="cpu")
    assert [str(f) for f in tc.out_fts] == [str(f) for f in jc.out_fts]
    for (jv, jn), (tv, tn) in zip(jc.fn(db.cols), tc.fn(tdb.cols)):
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        assert np.array_equal(np.where(tn.numpy(), 0, tv.numpy()), np.where(np.asarray(jn), 0, np.asarray(jv)))


def test_compile_exprs_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TX.compile_exprs([_port_ft(LL)], [TX.col(0, _port_ft(LL))])
