"""The port's TopN and full sort (tidb_tpu_torch/ops/topn.py) against the
JAX package's (tidb_tpu/ops/topn.py), element for element: the row indices,
the output validity and the overflow flag, over multi-key ORDER BYs with
NULLs in ascending and descending mixes, a string key, real keys holding
0.0 and -0.0, an unsigned key, k above the valid rows and k = 0, a small n
(the full sort), n = 2^16 with k = 10 (the sampled fast path), a tie-heavy
first word (the fast path's overflow) and k = 4096 (above FAST_K_LIMIT);
plus _first_set_positions on both of its branches. Inputs are made with
numpy from a seed and handed to both packages."""

import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.types as JT
from tidb_tpu.chunk.device import DeviceColumn as JColumn
from tidb_tpu.expr.compile import normalize_device_column as j_norm

import tidb_tpu_torch.types as TT
from tidb_tpu_torch.expr.compile import normalize_device_column as t_norm
from tidb_tpu_torch.interop import device_batch_from_numpy

# each package's ops/__init__ exports the function `topn`, which shadows the
# module of the same name as an attribute of the package
JN = importlib.import_module("tidb_tpu.ops.topn")
TN = importlib.import_module("tidb_tpu_torch.ops.topn")

I64 = np.iinfo(np.int64)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _by(cols, ft_fns, descs):
    """The same ORDER BY CompVals in both packages, from numpy columns
    (data, null, length | None) and per-column FieldType makers."""
    n = len(cols[0][0])
    jfts = [f(JT) for f in ft_fns]
    tfts = [f(TT) for f in ft_fns]
    jvals = [j_norm(JColumn(jnp.asarray(d), jnp.asarray(nl), None if ln is None else jnp.asarray(ln), ft))
             for (d, nl, ln), ft in zip(cols, jfts)]
    tb = device_batch_from_numpy(cols, np.ones(n, bool), n, tfts, device="cpu")
    tvals = [t_norm(c) for c in tb.cols]
    return list(zip(jvals, descs)), list(zip(tvals, descs))


def _same(jout, tout, names):
    for nm, a, b in zip(names, jout, tout):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, nm
        assert (a.astype(np.int64) == b.astype(np.int64)).all(), nm


def _check_topn(cols, ft_fns, descs, valid, k, full_sort=False):
    jby, tby = _by(cols, ft_fns, descs)
    jout = JN.topn(jby, jnp.asarray(valid), k, full_sort=full_sort)
    tout = TN.topn(tby, torch.from_numpy(valid), k, full_sort=full_sort)
    _same(jout, tout, ("idx", "out_valid", "overflow"))
    return tout


def _check_sort(cols, ft_fns, descs, valid):
    jby, tby = _by(cols, ft_fns, descs)
    _same(JN.sort_all(jby, jnp.asarray(valid)), TN.sort_all(tby, torch.from_numpy(valid)), ("idx", "out_valid"))


def _ll(T):
    return T.new_longlong()


def _ull(T):
    return T.new_longlong(unsigned=True)


def _dbl(T):
    return T.new_double()


def _d15(T):
    return T.new_decimal(15, 2)


def _dt(T):
    return T.new_datetime()


def _vc(T):
    return T.new_varchar(8)


def _int_col(rng, n, lo, hi, null_frac=0.0):
    return (rng.integers(lo, hi, n).astype(np.int64), rng.random(n) < null_frac, None)


def _str_col(rng, n, null_frac=0.1):
    """Short strings over a small alphabet, so prefixes and ties repeat."""
    length = rng.integers(0, 9, n).astype(np.int32)
    data = np.frombuffer(b"abcAB", np.uint8)[rng.integers(0, 5, (n, 8))]
    data = np.where(np.arange(8)[None, :] < length[:, None], data, 0).astype(np.uint8)
    return (data, rng.random(n) < null_frac, length)


def _real_col(rng, n):
    v = rng.integers(-20, 20, n).astype(np.float64) / 4
    v[rng.random(n) < 0.1] = -0.0
    v[rng.random(n) < 0.1] = 0.0
    return (v, rng.random(n) < 0.05, None)


def _case(name, n):
    """(cols, FieldType makers) for one named key mix."""
    rng = _rng(f"{name}/{n}")
    if name == "int_nulls":
        return [_int_col(rng, n, -50, 50, 0.2), _int_col(rng, n, 0, 1000, 0.1)], [_ll, _ll]
    if name == "string":
        return [_str_col(rng, n), _int_col(rng, n, 0, 100)], [_vc, _ll]
    if name == "real_zeros":
        return [_real_col(rng, n), _int_col(rng, n, 0, 4)], [_dbl, _ll]
    if name == "unsigned":
        u = rng.integers(0, 1 << 62, n).astype(np.uint64) * np.uint64(3)  # spans past 2^63
        u[rng.random(n) < 0.05] = np.uint64(0xFFFFFFFFFFFFFFFF)
        return [(u.view(np.int64), rng.random(n) < 0.05, None), _int_col(rng, n, 0, 10)], [_ull, _ll]
    if name == "extremes":
        v = rng.integers(-5, 5, n).astype(np.int64)
        v[rng.random(n) < 0.2] = I64.min
        v[rng.random(n) < 0.2] = I64.max
        return [(v, rng.random(n) < 0.1, None)], [_ll]
    # TPC-H's price / shipdate pair (the topn bench's keys)
    return ([(rng.integers(90000, 9000000, n).astype(np.int64), np.zeros(n, bool), None),
             (rng.integers(0, 1 << 40, n).astype(np.int64) << 17, np.zeros(n, bool), None)], [_d15, _dt])


DESC_MIXES = {"asc_asc": (False, False), "desc_asc": (True, False), "asc_desc": (False, True), "desc_desc": (True, True)}


@pytest.mark.parametrize("descs", list(DESC_MIXES), ids=list(DESC_MIXES))
@pytest.mark.parametrize("name", ["int_nulls", "string", "real_zeros", "unsigned", "price_date"])
@pytest.mark.parametrize("n,k", [(200, 50), (3000, 50), (1 << 16, 10)],
                         ids=["small_full_sort", "fast_path_ragged", "fast_path"])
def test_topn_matches_jax(n, k, name, descs):
    cols, fts = _case(name, n)
    valid = _rng(f"valid/{name}").random(n) < 0.9
    _check_topn(cols, fts, DESC_MIXES[descs][: len(cols)], valid, k)


def test_fast_path_is_taken_at_two_to_the_sixteen():
    """n = 2^16, k = 10: cap 256 < n, so the sampled path runs; on TPC-H's
    keys its threshold holds and the flag stays clear."""
    n = 1 << 16
    cols, fts = _case("price_date", n)
    _, tby = _by(cols, fts, (True, False))
    valid = np.ones(n, bool)
    _, _, ovf = TN.topn(tby, torch.from_numpy(valid), 10)
    assert not bool(ovf)
    # the full sort gives the same rows
    full = TN.topn(tby, torch.from_numpy(valid), 10, full_sort=True)[0]
    assert torch.equal(TN.topn(tby, torch.from_numpy(valid), 10)[0], full)
    _check_topn(cols, fts, (True, False), valid, 10)


@pytest.mark.parametrize("k", [0, 1, 2500, 5000], ids=["k0", "k1", "k_above_valid", "k_above_n"])
def test_topn_k_edges(k):
    n = 4096
    cols, fts = _case("int_nulls", n)
    valid = np.zeros(n, bool)
    valid[_rng("edges").choice(n, 2000, replace=False)] = True
    _check_topn(cols, fts, (True, False), valid, k)


@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 3], ids=["blocked", "ragged"])
def test_tie_heavy_first_word_overflows_like_jax(n):
    """Every first-key value equal: the candidate count passes cap, both
    flag overflow, and the full-sort variants agree."""
    rng = _rng(f"ties/{n}")
    cols = [(np.full(n, 777, np.int64), np.zeros(n, bool), None), _int_col(rng, n, 0, 50)]
    valid = np.ones(n, bool)
    out = _check_topn(cols, [_d15, _dt], (True, False), valid, 100)
    assert bool(out[2])
    _check_topn(cols, [_d15, _dt], (True, False), valid, 100, full_sort=True)


def test_k_above_fast_limit_is_the_full_sort():
    n = 1 << 16
    cols, fts = _case("price_date", n)
    valid = np.ones(n, bool)
    out = _check_topn(cols, fts, (True, False), valid, 4096)
    assert not bool(out[2])
    _, tby = _by(cols, fts, (True, False))
    assert torch.equal(out[0], TN.sort_all(tby, torch.from_numpy(valid))[0][:4096])


def test_no_key_word_takes_the_full_sort():
    """An empty ORDER BY gives no key word: len(keys) < 2 gates the fast
    path off, and both packages fall to the stable full sort."""
    n = 1 << 16
    valid = _rng("nokeys").random(n) < 0.5
    jout = JN.topn([], jnp.asarray(valid), 10)
    tout = TN.topn([], torch.from_numpy(valid), 10)
    _same(jout, tout, ("idx", "out_valid", "overflow"))


@pytest.mark.parametrize("descs", list(DESC_MIXES), ids=list(DESC_MIXES))
@pytest.mark.parametrize("name", ["int_nulls", "string", "real_zeros", "unsigned", "extremes"])
def test_sort_all_matches_jax(name, descs):
    n = 2048
    cols, fts = _case(name, n)
    valid = _rng(f"sortvalid/{name}").random(n) < 0.8
    _check_sort(cols, fts, DESC_MIXES[descs][: len(cols)], valid)


@pytest.mark.parametrize("n,cap,density", [
    (1 << 14, 256, 0.05),   # a multiple of the block: the two-level branch
    (1 << 14, 4096, 0.01),  # ranks past the last set bit
    (3000, 256, 0.1),       # not a multiple of the block: the flat branch
    (256, 64, 0.5),         # one block: the flat branch
    (1 << 12, 512, 0.0),    # no set bit
], ids=["blocked", "blocked_short", "flat_ragged", "flat_one_block", "empty"])
def test_first_set_positions_matches_jax(n, cap, density):
    cand = _rng(f"fsp/{n}/{cap}").random(n) < density
    a = np.asarray(JN._first_set_positions(jnp.asarray(cand), cap))
    b = TN._first_set_positions(torch.from_numpy(cand), cap).numpy()
    assert a.shape == b.shape
    assert (a.astype(np.int64) == b).all()
    want = np.nonzero(cand)[0][:cap]
    assert (b[: len(want)] == want).all()
