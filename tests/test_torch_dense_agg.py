"""The one-pass small-G GROUP BY (tidb_tpu_torch.ops.dense_agg, the port of
the Pallas kernel in tidb_tpu/ops/dense_pallas.py) on the CPU, where the
wrapper runs its plain torch version, against the JAX package's kernel in
Pallas interpret mode over the case matrix of tests/test_dense_pallas.py.
Equality is bit-exact on n_groups, group_rep[:ng] and every state.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the same plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.expr import AggDesc as JAgg
from tidb_tpu.expr import col as jcol
from tidb_tpu.ops.aggregate import group_aggregate as j_group_aggregate
from tidb_tpu.ops.dense_pallas import dense_pallas_eligible, pallas_mode
import tidb_tpu.types as JT

import tidb_tpu_torch.chunk as TC
from tidb_tpu_torch.chunk.device import to_device_batch as t_to_device_batch
from tidb_tpu_torch.expr import AggDesc as TAgg
from tidb_tpu_torch.expr import ExprCompiler as TCompiler
from tidb_tpu_torch.expr import col as tcol
from tidb_tpu_torch.ops import dense_agg as K1
from tidb_tpu_torch.ops.aggregate import group_aggregate as t_group_aggregate
import tidb_tpu_torch.types as TT

from test_ops import eval_vals, make_data


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "interpret")


def _port_ft(ft):
    return TT.FieldType(TT.TypeCode(int(ft.tp)), TT.Flag(int(ft.flag)), ft.flen, ft.decimal,
                        ft.charset, TT.Collation(int(ft.collate)), tuple(ft.elems))


def _port_vals(jfts, jchunk, idxs):
    """The port's CompVals of columns `idxs` over the same host rows."""
    tfts = [_port_ft(ft) for ft in jfts]
    tchunk = TC.Chunk([TC.Column(tfts[i], c.data, c.null, c.offsets, c.blob)
                       for i, c in enumerate(jchunk.columns)])
    db = t_to_device_batch(tchunk, capacity=jchunk.num_rows(), device="cpu")
    vals = TCompiler(tfts, device="cpu").run([tcol(i, tfts[i]) for i in idxs], db.cols)
    return tfts, db, vals


def _port_aggs(spec, tfts, tvals):
    """spec: [(name, arg column index or None)] -> port aggs over tvals
    (tvals indexed like the spec's columns)."""
    out = []
    for name, ci, vi in spec:
        if ci is None:
            out.append((TAgg(name, ()), []))
        else:
            out.append((TAgg(name, (tcol(ci, tfts[ci]),)), [tvals[vi]]))
    return out


def _jax_aggs(spec, jfts, jvals):
    out = []
    for name, ci, vi in spec:
        if ci is None:
            out.append((JAgg(name, ()), []))
        else:
            out.append((JAgg(name, (jcol(ci, jfts[ci]),)), [jvals[vi]]))
    return out


def _assert_same(ref, got, float_rtol=0.0):
    """JAX result (ref) == port result (got), bit for bit over [:ng].
    float_rtol: DOUBLE sums on the sort path are cumsum differences, whose
    last bits follow each library's summation order (1e-12 relative)."""
    assert bool(got.overflow) == bool(ref.overflow)
    ng = int(ref.n_groups)
    assert int(got.n_groups) == ng
    assert np.array_equal(got.group_rep[:ng].numpy(), np.asarray(ref.group_rep[:ng]))
    assert len(got.states) == len(ref.states)
    for rs, ps in zip(ref.states, got.states):
        assert len(rs) == len(ps)
        for (rv, rn), (pv, pn) in zip(rs, ps):
            rv, rn = np.asarray(rv[:ng]), np.asarray(rn[:ng])
            assert pv.numpy().dtype == rv.dtype
            if rv.dtype.kind == "f" and float_rtol:
                assert np.allclose(pv[:ng].numpy(), rv, rtol=float_rtol, atol=0.0), (pv[:ng], rv)
            else:
                assert np.array_equal(pv[:ng].numpy(), rv), (pv[:ng], rv)
            assert np.array_equal(pn[:ng].numpy(), rn)


def _run(jfts, jch, idxs, key_pos, spec, G, valid_np=None, sort_path=False):
    db, jvals = eval_vals(jfts, jch, [jcol(i, jfts[i]) for i in idxs])
    tfts, tdb, tvals = _port_vals(jfts, jch, idxs)
    jkeys = [jvals[p] for p in key_pos]
    tkeys = [tvals[p] for p in key_pos]
    jaggs, taggs = _jax_aggs(spec, jfts, jvals), _port_aggs(spec, tfts, tvals)
    jvalid, tvalid = db.row_valid, tdb.row_valid
    if valid_np is not None:
        jvalid = jvalid & jnp.asarray(valid_np)
        tvalid = tvalid & torch.from_numpy(valid_np)
    engaged = pallas_mode() == "interpret" and dense_pallas_eligible(jkeys, jaggs, merge=False)
    assert engaged == K1.dense_agg_eligible(tkeys, taggs, merge=False)
    ref = j_group_aggregate(jkeys, jaggs, jvalid, 64, small_groups=G)
    got = t_group_aggregate(tkeys, taggs, tvalid, 64, small_groups=G)
    sort_ref = j_group_aggregate(jkeys, jaggs, jvalid, 64) if sort_path else None
    return engaged, ref, got, sort_ref


def test_int_key_count_sum_avg():
    fts, ch = make_data(n=300, k_card=5)
    spec = [("count", None, None), ("count", 1, 1), ("sum", 1, 1), ("avg", 1, 1)]
    valid = np.random.default_rng(3).random(300) < 0.8
    engaged, ref, got, _ = _run(fts, ch, [0, 1], [0], spec, 8, valid)
    assert engaged
    assert not bool(ref.overflow)
    _assert_same(ref, got)


def test_string_key_with_nulls():
    fts, ch = make_data(n=257, k_card=4, null_p=0.25)
    spec = [("count", None, None), ("sum", 1, 1)]
    engaged, ref, got, _ = _run(fts, ch, [3, 1], [0], spec, 8)
    assert engaged
    assert not bool(ref.overflow)
    _assert_same(ref, got)


def test_two_keys():
    fts, ch = make_data(n=300, k_card=3)
    spec = [("sum", 1, 2), ("count", None, None)]
    engaged, ref, got, _ = _run(fts, ch, [0, 3, 1], [0, 1], spec, 32)
    assert engaged
    assert not bool(ref.overflow)
    _assert_same(ref, got)


def test_overflow_when_hint_wrong():
    fts, ch = make_data(n=200, k_card=30, null_p=0.0)
    engaged, ref, got, _ = _run(fts, ch, [0], [0], [("count", None, None)], 8)
    assert engaged
    assert bool(ref.overflow) and bool(got.overflow)


def test_value_range_gate_is_gone():
    """|v| >= 2^46 overflows the TPU kernel's limb range gate only; the
    port accumulates exact int64 and equals JAX's sort path."""
    ft = JT.new_longlong()
    big = 1 << 50
    rows = [[JT.Datum.i64(1), JT.Datum.i64(big)], [JT.Datum.i64(1), JT.Datum.i64(3)],
            [JT.Datum.i64(2), JT.Datum.i64(-big)]]
    ch = JChunk.from_rows([ft, ft], rows)
    engaged, ref, got, sort_ref = _run([ft, ft], ch, [0, 1], [0], [("sum", 1, 1)], 8, sort_path=True)
    assert engaged
    assert bool(ref.overflow) and not bool(sort_ref.overflow)
    assert not bool(got.overflow)
    _assert_same(sort_ref, got)


def test_negative_values_exact():
    ft = JT.new_longlong()
    rng = np.random.default_rng(0)
    rows = [[JT.Datum.i64(int(rng.integers(0, 6))), JT.Datum.i64(int(rng.integers(-(2 ** 45), 2 ** 45)))]
            for _ in range(1500)]
    ch = JChunk.from_rows([ft, ft], rows)
    engaged, ref, got, _ = _run([ft, ft], ch, [0, 1], [0], [("sum", 1, 1), ("avg", 1, 1)], 8)
    assert engaged
    assert not bool(ref.overflow)
    _assert_same(ref, got)


def test_ineligible_takes_the_sort_path():
    """min/max and DOUBLE args are not the kernel's: the port's hinted call
    takes the sort-free small-G route, as JAX's hinted call does, and
    equals it (DOUBLE sums within 1e-12 relative). The name is the one the
    test had while the port sent these calls to its sort path."""
    from tidb_tpu_torch.ops import aggregate as TA

    fts, ch = make_data(n=120, k_card=4)
    spec = [("min", 1, 1), ("avg", 2, 2)]
    before, dense_before = K1.dense_agg.launches, TA._group_aggregate_dense.launches
    engaged, ref, got, _ = _run(fts, ch, [0, 1, 2], [0], spec, 8)
    assert not engaged
    assert not bool(ref.overflow)
    _assert_same(ref, got, float_rtol=1e-12)
    assert K1.dense_agg.launches == before
    assert TA._group_aggregate_dense.launches == dense_before + 1


def test_plain_version_contract_on_a_forced_collision():
    """Equal primary hashes with different verify hashes: overflow, and
    every sum still lands in the (single) group."""
    n = 64
    hp = torch.full((n,), 1234, dtype=torch.int64)
    hv = torch.arange(n, dtype=torch.int64)
    valid = torch.ones(n, dtype=torch.bool)
    v = torch.arange(n, dtype=torch.int64) - 10
    nl = torch.arange(n) % 5 == 0
    rep, ng, ovf, counts, sums, nns = K1.dense_agg(hp, hv, valid, [v], [nl], 4)
    assert bool(ovf) and int(ng) == 1 and int(rep[0]) == 0
    assert int(counts[0]) == n
    assert int(sums[0, 0]) == int(v[~nl].sum()) and int(nns[0, 0]) == int((~nl).sum())


def test_cuda_tensors_launch_or_raise():
    """A CPU tensor takes the plain version; a tensor on another device is
    refused (no quiet fallback)."""
    hp = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        K1.dense_agg(hp, hp, hp.bool(), [], [], 4)


# ---------------------------------------------------------------------------
# the one-pass kernel's edge shapes: the plain version (what the card's
# kernel is held to, bit for bit, in chip_smoke.py) against the Pallas kernel
# in interpret mode where that kernel takes the case, else a numpy oracle
# ---------------------------------------------------------------------------

# name -> (rows, key cardinality, G, value columns, share of valid rows)
EDGE_SHAPES = {
    "n=127": (127, 5, 8, 2, 0.9),
    "n=129": (129, 5, 8, 2, 0.9),
    "n=1000": (1000, 6, 16, 4, 0.8),
    "n=2049": (2049, 6, 16, 2, 0.8),
    "no valid row": (300, 5, 8, 2, 0.0),
    "G=1": (200, 1, 1, 2, 0.9),
    "G=32": (600, 31, 32, 2, 0.9),
    "NC=0": (300, 5, 8, 0, 0.9),
    "NC=6": (300, 5, 8, 6, 0.9),
}


def _edge_chunk(n, k, nc, seed):
    """An int64 key column (10 % NULL, k values) and nc int64 value columns
    (15 % NULL, |v| < 2^40: inside the Pallas kernel's range gate)."""
    rng = np.random.default_rng(seed)
    ft = JT.new_longlong()
    rows = []
    for _ in range(n):
        key = JT.Datum.NULL if k > 1 and rng.random() < 0.1 else JT.Datum.i64(int(rng.integers(0, k)))
        vals = [JT.Datum.NULL if rng.random() < 0.15 else JT.Datum.i64(int(rng.integers(-(1 << 40), 1 << 40)))
                for _ in range(nc)]
        rows.append([key] + vals)
    return [ft] * (1 + nc), JChunk.from_rows([ft] * (1 + nc), rows)


@pytest.mark.parametrize("case", list(EDGE_SHAPES))
def test_edge_shapes_against_pallas(case):
    n, k, G, nc, share = EDGE_SHAPES[case]
    fts, ch = _edge_chunk(n, k, nc, seed=len(case))
    valid = np.random.default_rng(7).random(n) < share
    spec = [("count", None, None)] + [("sum", 1 + c, 1 + c) for c in range(nc)]
    spec += [("avg", 1, 1)] if nc else []
    engaged, ref, got, _ = _run(fts, ch, list(range(1 + nc)), [0], spec, G, valid)
    assert engaged
    assert not bool(ref.overflow)
    assert int(ref.n_groups) == (0 if share == 0 else min(k + (k > 1), G))
    _assert_same(ref, got)


def _numpy_dense_agg(hp, hv, valid, vals, nulls, G):
    """The kernel's function row by row: first-encounter groups, wrapping
    int64 sums (Python ints mod 2^64), overflow on a (G+1)-th key or a
    verify-hash mismatch."""
    order, first = [], {}
    over = False
    for i in np.flatnonzero(valid):
        h = int(hp[i])
        if h not in first:
            first[h] = i
            order.append(h)
        over |= int(hv[i]) != int(hv[first[h]])
    over |= len(order) > G
    gid = {h: g for g, h in enumerate(order[:G])}
    counts = np.zeros(G, np.int64)
    sums = [[0] * G for _ in vals]
    nns = np.zeros((len(vals), G), np.int64)
    for i in np.flatnonzero(valid):
        g = gid.get(int(hp[i]))
        if g is None:
            continue
        counts[g] += 1
        for c in range(len(vals)):
            if not nulls[c][i]:
                sums[c][g] += int(vals[c][i])
                nns[c, g] += 1
    wrap = np.array([[(s + (1 << 63)) % (1 << 64) - (1 << 63) for s in row] for row in sums], np.int64)
    rep = np.zeros(G, np.int32)
    rep[:min(len(order), G)] = [first[h] for h in order[:G]]
    return rep, min(len(order), G), over, counts, wrap.reshape(len(vals), G), nns


# the edge shapes again, plus sums that wrap near +-2^63 (outside the
# Pallas kernel's 2^46 gate) and a forced verify-hash mismatch
KERNEL_CASES = {name: (n, k, G, nc, share, False) for name, (n, k, G, nc, share) in EDGE_SHAPES.items()}
KERNEL_CASES["values near +-2^63"] = (3000, 6, 16, 3, 0.9, True)
KERNEL_CASES["40 keys, G=32"] = (3000, 40, 32, 2, 0.9, False)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_function_against_numpy(case):
    n, k, G, nc, share, near = KERNEL_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    keys = rng.integers(0, k, n)
    salt = rng.integers(0, 1 << 62, k)                 # hp: bit 63 clear
    hp, hv = salt[keys], salt[keys] ^ 0x5A5A
    if case == "n=2049":
        hv[n // 2] ^= 1                                 # a primary-hash collision
    valid = rng.random(n) < share
    if near:
        edge = rng.integers(0, 1 << 40, (nc, n))
        vals = np.where(rng.random((nc, n)) < 0.5, np.int64((1 << 63) - 1) - edge, np.int64(-(1 << 63)) + edge)
    else:
        vals = rng.integers(-(1 << 62), 1 << 62, (nc, n))
    nulls = rng.random((nc, n)) < 0.2
    want = _numpy_dense_agg(hp, hv, valid, vals, nulls, G)
    T = torch.from_numpy
    got = K1.dense_agg(T(hp), T(hv), T(valid), [T(v) for v in vals], [T(m) for m in nulls], G)
    rep, ng, ovf, counts, sums, nns = got
    assert bool(ovf) == want[2]
    assert int(ng) == want[1]
    assert np.array_equal(rep.numpy(), want[0])
    assert np.array_equal(counts.numpy(), want[3])
    assert np.array_equal(sums.numpy(), want[4])
    assert np.array_equal(nns.numpy(), want[5])
    assert sums.shape == nns.shape == (nc, G)


def _c_signatures(src: str) -> dict:
    """{name: (restype, [argtypes])} of every `extern "C"` function in a
    CUDA source, mapped to the ctypes a caller must declare."""
    import ctypes
    import re

    ctype = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "const void* const*": ctypes.POINTER(ctypes.c_void_p)}
    out = {}
    for m in re.finditer(r'extern "C"\s+([\w ]+?)\s+(\w+)\(([^)]*)\)', src):
        params = [p.strip() for p in m.group(3).split(",") if p.strip()]
        args = [ctype[re.sub(r"\s+", " ", p.rsplit(" ", 1)[0].replace("*", "* ")).replace("* *", "**")
                      .replace(" *", "*").strip()] for p in params]
        out[m.group(2)] = (ctype[m.group(1).strip()], args)
    return out


@pytest.mark.parametrize("lib", ["dense_agg", "joinscan", "join_probe"])
def test_ctypes_signatures_match_the_source(lib):
    """A wrapper's ctypes table against its source's extern "C"
    declarations: a pointer declared as a 32-bit int would be cut on the
    card, so the two must agree argument by argument."""
    import importlib

    from tidb_tpu_torch import kernels

    mod = importlib.import_module(f"tidb_tpu_torch.ops.{lib}")
    declared = _c_signatures((kernels._PKG / kernels.SOURCES[lib]).read_text())
    assert set(declared) == set(mod._SIGNATURES)
    for name, (res, args) in mod._SIGNATURES.items():
        want_res, want_args = declared[name]
        assert res is want_res, name
        assert len(args) == len(want_args), name
        for i, (a, b) in enumerate(zip(args, want_args)):
            assert a is b, (name, i, a, b)
