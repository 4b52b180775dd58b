"""The port's hashing and key machinery (tidb_tpu_torch.ops.seg / keys) bit
for bit against the JAX package: group order and overflow decisions
follow from these hashes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.expr.compile import CompVal as JVal
from tidb_tpu.ops import keys as JK
from tidb_tpu.ops import seg as JS
import tidb_tpu.types as JT

from tidb_tpu_torch.expr.compile import CompVal as TVal
from tidb_tpu_torch.ops import keys as TK
from tidb_tpu_torch.ops import seg as TS
import tidb_tpu_torch.types as TT


def _words(seed, n=512):
    rng = np.random.default_rng(seed)
    w = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    w[:8] = [0, -1, 1, -(2 ** 63), 2 ** 63 - 1, 42, -42, 1 << 40]
    return w


def _floats(seed, n=512):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n) * 10.0 ** rng.integers(-5, 300, n)
    f[:5] = [0.0, -0.0, 1.5, -2.25, np.inf]
    return f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix64_bit_equal(seed):
    w = _words(seed)
    want = np.asarray(JS._mix64(jnp.asarray(w)))
    assert np.array_equal(TS._mix64(torch.from_numpy(w)).numpy(), want)


@pytest.mark.parametrize("salt", [1, 16, 64, 4096, 16 + 0x9E3779B9])
def test_hash_words_bit_equal_int_and_float_words(salt):
    ints = [_words(salt % 7), _words(salt % 7 + 1)]
    floats = _floats(salt % 5)
    jw = [jnp.asarray(a) for a in ints] + [jnp.asarray(floats)]
    tw = [torch.from_numpy(a) for a in ints] + [torch.from_numpy(floats)]
    want = np.asarray(JS.hash_words(jw, salt))
    assert np.array_equal(TS.hash_words(tw, salt).numpy(), want)


@pytest.mark.parametrize("salt", [8, 4096])
def test_group_hash_bit_equal(salt):
    rng = np.random.default_rng(salt)
    ws = [_words(3), _words(4)]
    valid = rng.random(512) < 0.7
    want = np.asarray(JS.group_hash([jnp.asarray(a) for a in ws], jnp.asarray(valid), salt))
    got = TS.group_hash([torch.from_numpy(a) for a in ws], torch.from_numpy(valid), salt).numpy()
    assert np.array_equal(got, want)
    assert (got[valid] & 1 == 0).all() and (got[~valid] == TS.I64_MAX).all()


def _vals(kind, T, Val, conv, seed=0):
    rng = np.random.default_rng(seed)
    n = 200
    null = rng.random(n) < 0.2
    if kind == "int":
        v, ft = _words(seed, n), T.new_longlong()
    elif kind == "uint":
        v, ft = _words(seed, n), T.new_longlong(unsigned=True)
    elif kind == "decimal":
        v, ft = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64), T.new_decimal(10, 2)
    elif kind == "real":
        v, ft = _floats(seed, n), T.new_double()
    else:  # ci string words
        v = rng.integers(-(2 ** 63), 2 ** 63 - 1, (n, 5), dtype=np.int64)
        ft = T.new_varchar(16, collate=T.Collation.Utf8MB4GeneralCI)
    return Val(conv(v), conv(null), ft)


@pytest.mark.parametrize("kind", ["int", "uint", "decimal", "real", "ci_string"])
@pytest.mark.parametrize("desc", [False, True])
def test_sort_key_arrays_equal(kind, desc):
    jv = _vals(kind, JT, JVal, jnp.asarray)
    tv = _vals(kind, TT, TVal, torch.from_numpy)
    want = [np.asarray(a) for a in JK.sort_key_arrays(jv, desc)]
    got = [a.numpy() for a in TK.sort_key_arrays(tv, desc)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


def test_segments_and_first_match_equal():
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 20, 300)).astype(np.int64)
    valid = np.ones(300, bool)
    valid[-30:] = False
    jseg, jng = JK.segments_from_sorted([jnp.asarray(keys)], jnp.asarray(valid))
    tseg, tng = TK.segments_from_sorted([torch.from_numpy(keys)], torch.from_numpy(valid))
    assert np.array_equal(tseg.numpy(), np.asarray(jseg)) and int(tng) == int(jng)
    nseg = 32
    jctx = JS.make_segctx(jnp.minimum(jseg, nseg - 1), nseg)
    tctx = TS.make_segctx(torch.clamp(tseg, max=nseg - 1), nseg)
    for a in ("starts", "ends", "counts"):
        assert np.array_equal(getattr(tctx, a).numpy(), np.asarray(getattr(jctx, a)))
    mask = rng.random(300) < 0.5
    jpos, jhas = JS.seg_first_match(jctx, jnp.asarray(mask))
    tpos, thas = TS.seg_first_match(tctx, torch.from_numpy(mask))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos)) and np.array_equal(thas.numpy(), np.asarray(jhas))
    v = _words(5, 300)
    assert np.array_equal(TS.seg_sum(tctx, torch.from_numpy(v)).numpy(), np.asarray(JS.seg_sum(jctx, jnp.asarray(v))))
    for op in ("seg_min", "seg_max"):
        want = np.asarray(getattr(JS, op)(jctx, jnp.asarray(v)))
        assert np.array_equal(getattr(TS, op)(tctx, torch.from_numpy(v)).numpy(), want)
