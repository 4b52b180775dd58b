"""The port's general join kernel (tidb_tpu_torch/ops/join.py hash_join)
against the JAX package's, element for element on every JoinResult field,
over join types, unique and general builds, NULL keys, INT64 extremes and
two-word keys (the salted-hash path, including a forced hash collision that
must raise overflow); plus merge_lo_hi, merge_searchsorted and lexsort on
random inputs. Inputs are made with numpy from a seed and handed to both."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.ops.join as JJ
import tidb_tpu.ops.keys as JK
import tidb_tpu.ops.seg as JS
import tidb_tpu.types as JT
from tidb_tpu.expr.compile import CompVal as JVal

import tidb_tpu_torch.ops.join as TJ
import tidb_tpu_torch.ops.keys as TK
import tidb_tpu_torch.ops.seg as TS
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.expr.compile import CompVal as TVal

I64 = np.iinfo(np.int64)


def _vals(cols, nulls, types_mod, val_cls, arr):
    ft = types_mod.new_longlong()
    return [val_cls(arr(np.asarray(c, np.int64)), arr(np.asarray(n, bool)), ft) for c, n in zip(cols, nulls)]


def _both(cols, nulls):
    j = _vals(cols, nulls, JT, JVal, jnp.asarray)
    t = _vals(cols, nulls, TT, TVal, torch.from_numpy)
    return j, t


def _keys(case, rng, n, domain):
    """(key columns, null masks) for one side."""
    if case == "int_nulls":
        return [rng.integers(-domain, domain, n)], [rng.random(n) < 0.15]
    if case == "extremes":
        k = rng.integers(-domain, domain, n)
        k[rng.random(n) < 0.2] = I64.min
        k[rng.random(n) < 0.2] = I64.max
        return [k], [np.zeros(n, bool)]
    # two words: the hash path
    return ([rng.integers(0, domain, n), rng.integers(0, 3, n)],
            [rng.random(n) < 0.1, np.zeros(n, bool)])


def _assert_same(jres, tres):
    for f in ("probe_idx", "build_idx", "build_null", "out_valid", "n_out", "overflow"):
        a = np.asarray(getattr(jres, f))
        b = getattr(tres, f).numpy()
        assert a.shape == b.shape, f
        assert (a.astype(np.int64) == b.astype(np.int64)).all(), f
    assert jres.probe_identity == tres.probe_identity
    assert (jres.need is None) == (tres.need is None)
    if jres.need is not None:
        assert int(jres.need) == int(tres.need)


def _run(bcols, bnulls, pcols, pnulls, bvalid, pvalid, cap, jt, unique):
    jb, tb = _both(bcols, bnulls)
    jp, tp = _both(pcols, pnulls)
    jres = JJ.hash_join(jb, jp, jnp.asarray(bvalid), jnp.asarray(pvalid), cap, jt, build_unique=unique)
    tres = TJ.hash_join(tb, tp, torch.from_numpy(bvalid), torch.from_numpy(pvalid), cap, jt, build_unique=unique)
    _assert_same(jres, tres)
    return tres


@pytest.mark.parametrize("case", ["int_nulls", "extremes", "two_words"])
@pytest.mark.parametrize("unique", [True, False], ids=["unique", "general"])
@pytest.mark.parametrize("jt", ["inner", "left_outer", "semi", "anti"])
def test_hash_join_matches_jax(jt, unique, case):
    rng = np.random.default_rng(zlib.crc32(f"{jt}/{unique}/{case}".encode()))
    nb, np_ = 60, 300
    if unique and case != "two_words":
        bcols = [rng.permutation(np.arange(-30, 30))]
        if case == "extremes":
            bcols[0][:2] = [I64.min, I64.max]
        bnulls = [rng.random(nb) < 0.1]
    else:
        bcols, bnulls = _keys(case, rng, nb, 20)
    pcols, pnulls = _keys(case, rng, np_, 40)
    bvalid = rng.random(nb) < 0.9
    pvalid = rng.random(np_) < 0.9
    _run(bcols, bnulls, pcols, pnulls, bvalid, pvalid, 512, jt, unique)


def test_hash_join_out_capacity_overflow_reports_need():
    rng = np.random.default_rng(11)
    b = [rng.integers(0, 4, 40)]
    p = [rng.integers(0, 4, 200)]
    z = [np.zeros(40, bool)], [np.zeros(200, bool)]
    tres = _run(b, z[0], p, z[1], np.ones(40, bool), np.ones(200, bool), 64, "inner", False)
    assert bool(tres.overflow) and int(tres.need) > 64


def test_forced_hash_collision_overflows(monkeypatch):
    """Two-word keys that differ only in their second word collide when
    the hash sees the first word alone: both kernels must catch it."""
    monkeypatch.setattr(JJ, "hash_words", lambda words, salt: JS.hash_words(words[:1], salt))
    monkeypatch.setattr(TJ, "hash_words", lambda words, salt: TS.hash_words(words[:1], salt))
    bcols = [np.array([1, 1, 2, 3]), np.array([0, 1, 0, 0])]
    pcols = [np.array([1, 2, 3, 1]), np.array([1, 0, 0, 5])]
    zb, zp = [np.zeros(4, bool)] * 2, [np.zeros(4, bool)] * 2
    for unique in (True, False):
        tres = _run(bcols, zb, pcols, zp, np.ones(4, bool), np.ones(4, bool), 64, "inner", unique)
        assert bool(tres.overflow)


@pytest.mark.parametrize("seed", range(4))
def test_merge_lo_hi_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nh, nq = 200, 300
    hay = np.sort(rng.integers(-50, 50, nh))
    n_counted = int(rng.integers(0, nh + 1))
    hay[n_counted:] = I64.max  # the uncounted tail sits at the top sentinel
    counted = np.arange(nh) < n_counted
    q = rng.integers(-60, 60, nq)
    q[::7] = I64.max
    jl, jh = JJ.merge_lo_hi(jnp.asarray(hay), jnp.asarray(counted), jnp.asarray(q))
    tl, th = TJ.merge_lo_hi(torch.from_numpy(hay), torch.from_numpy(counted), torch.from_numpy(q))
    assert (np.asarray(jl) == tl.numpy()).all() and (np.asarray(jh) == th.numpy()).all()


@pytest.mark.parametrize("nq", [700, 40], ids=["merge", "binary"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_forms_match_jax(side, nq):
    """merge_searchsorted, and sorted_positions on both sides of the JAX
    package's query-count switch."""
    rng = np.random.default_rng(3)
    hay = np.sort(rng.integers(0, 100, 5000))
    q = rng.integers(-5, 105, nq)
    for name in ("merge_searchsorted", "sorted_positions"):
        j = getattr(JS, name)(jnp.asarray(hay), jnp.asarray(q), side=side)
        t = getattr(TS, name)(torch.from_numpy(hay), torch.from_numpy(q), side=side)
        assert (np.asarray(j) == t.numpy()).all(), name
        assert t.dtype == torch.int32


@pytest.mark.parametrize("extra", [False, True])
def test_lexsort_matches_jax(extra):
    rng = np.random.default_rng(4)
    n = 400
    keys = [rng.integers(0, 3, n), rng.integers(-2, 2, n), rng.normal(size=n).round(1)]
    ek = rng.integers(0, 2, n) if extra else None
    j = JK.lexsort([jnp.asarray(k) for k in keys], extra_key=None if ek is None else jnp.asarray(ek))
    t = TK.lexsort([torch.from_numpy(k) for k in keys], extra_key=None if ek is None else torch.from_numpy(ek))
    assert (np.asarray(j) == t.numpy()).all()


def test_sort_by_word_and_run_head_pos_match_jax():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 20, 300)
    jw, jp = JS.sort_by_word(jnp.asarray(w))
    tw, tp = TS.sort_by_word(torch.from_numpy(w))
    assert (np.asarray(jw) == tw.numpy()).all() and (np.asarray(jp) == tp.numpy()).all()
    diff = np.ones(300, bool)
    diff[1:] = np.asarray(jw)[1:] != np.asarray(jw)[:-1]
    assert (np.asarray(JS.run_head_pos(jnp.asarray(diff))) == TS.run_head_pos(torch.from_numpy(diff)).numpy()).all()
