"""K4 — the per-partition probe of the radix join
(tidb_tpu_torch/ops/join_probe.py) — and the port's radix join
(tidb_tpu_torch/ops/radix_join.py) against the JAX package: the plain
version is bit-equal to the Pallas kernel in interpret mode and to the XLA
dense probe over the key matrix of tests/test_radix_join.py (signed with
INT64 extremes, INT32_MIN, unsigned bit patterns, NULL slots, a duplicate
build key, every build slot usable); the byte count of the kernel's bound
against a hand count; the partitioned probe equals JAX's dense route on every
returned field, escapes and need included; radix_plan and the probe
strategy gate agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.ops.join_pallas as JP
import tidb_tpu.ops.radix_join as JR
import tidb_tpu.types as JT
from tidb_tpu.expr.compile import CompVal as JVal

import tidb_tpu_torch.ops.join_probe as TP
import tidb_tpu_torch.ops.radix_join as TR
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.expr.compile import CompVal as TVal


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Jitted subfunctions cached by other modules under another x64
    weak-type state can break the Pallas interpret lowering."""
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "interpret")


KEY_CASES = ["signed", "int32_min", "unsigned", "nulls", "dup", "full"]


def _tables(case, P=2, part_cap=128, probe_cap=1024, seed=5):
    """(b_key_tbl, b_slot_ok, p_key_tbl, p_slot_ok) numpy tables."""
    rng = np.random.default_rng(seed)
    nb = part_cap if case == "full" else 64  # "full": every build slot usable
    if case == "signed":
        keys = (rng.permutation(P * nb).astype(np.int64) - 32) * (1 << 37)
        keys[0], keys[1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    elif case == "int32_min":
        keys = np.arange(P * nb, dtype=np.int64) - 31
        keys[0], keys[1] = -(1 << 31), (1 << 31) - 1
    elif case == "unsigned":
        keys = rng.permutation(P * nb).astype(np.int64) * (1 << 40)
        keys[0] = -1  # the u64 max bit pattern
    elif case == "full":
        keys = rng.permutation(P * nb).astype(np.int64) * 7919 - (1 << 40)
    else:
        keys = np.arange(P * nb, dtype=np.int64)
    bk = np.zeros((P, part_cap), np.int64)
    bok = np.zeros((P, part_cap), bool)
    bk[:, :nb] = keys.reshape(P, nb)
    bok[:, :nb] = True
    bk[:, nb:] = rng.integers(-5, 5, (P, part_cap - nb))  # garbage past the count
    if case == "dup":
        bk[0, 10] = bk[0, 3]
    pick = rng.integers(0, nb, (P, probe_cap))
    pk = np.take_along_axis(bk[:, :nb], pick, axis=1)
    pk[:, ::5] = 999_999_999_999  # unmatched
    pok = np.zeros((P, probe_cap), bool)
    pok[:, :700] = True
    if case == "nulls":
        bok &= rng.random((P, part_cap)) < 0.8
        pok &= rng.random((P, probe_cap)) < 0.8
    return bk, bok, pk, pok


@pytest.mark.parametrize("case", KEY_CASES)
def test_k4_plain_bit_equal_to_pallas_and_xla(case):
    bk, bok, pk, pok = _tables(case)
    got_pos, got_dup = TP._probe_tables_plain(*(torch.from_numpy(a) for a in (bk, bok, pk, pok)))
    jt = [jnp.asarray(a) for a in (bk, bok, pk, pok)]
    pal_pos, pal_dup = JP.probe_tables_pallas(*jt, interpret=True)
    xla_pos, xla_dup = JR._probe_tables_xla(*jt, bk.shape[1])
    got = got_pos.numpy()
    assert got.dtype == np.int32
    assert (np.asarray(pal_pos) == got).all()
    # the XLA probe leaves unusable probe slots unmasked; both kernels agree
    # on every usable one
    assert (np.asarray(xla_pos)[pok] == got[pok]).all()
    assert bool(pal_dup) == bool(xla_dup) == bool(got_dup) == (case == "dup")
    assert (got[pok] < bk.shape[1]).any()


@pytest.mark.parametrize("case", ["prefix", "random", "empty_partition"])
def test_probe_tables_bytes_counts_what_the_inputs_need(case):
    """Every ok byte, 32 B per key sector (4 slots from the table's start)
    holding a usable slot on either side, bpos in full and the dup byte."""
    P, part_cap, probe_cap = 3, 8, 12
    rng = np.random.default_rng(11)
    bok = np.zeros((P, part_cap), bool)
    pok = np.zeros((P, probe_cap), bool)
    if case == "prefix":  # the radix join's layout: usable slots lead each row
        bok[0, :5], bok[1, :1], bok[2, :8] = True, True, True
        pok[0, :9], pok[1, :4], pok[2, :1] = True, True, True
        b_sectors, p_sectors = 2 + 1 + 2, 3 + 1 + 1
    elif case == "random":
        bok[:] = rng.random(bok.shape) < 0.3
        pok[:] = rng.random(pok.shape) < 0.3
        b_sectors = sum(bool(bok.reshape(-1)[i:i + 4].any()) for i in range(0, P * part_cap, 4))
        p_sectors = sum(bool(pok.reshape(-1)[i:i + 4].any()) for i in range(0, P * probe_cap, 4))
    else:  # partition 1 is empty on both sides (an escaped partition)
        bok[0, :3], bok[2, 6] = True, True
        pok[0, :2], pok[2, 11] = True, True
        b_sectors, p_sectors = 1 + 1, 1 + 1
    got_in, got_out = TP.probe_tables_bytes(torch.from_numpy(bok), torch.from_numpy(pok))
    assert got_in == P * part_cap + P * probe_cap + 32 * (b_sectors + p_sectors)
    assert got_out == 4 * P * probe_cap + 1
    # uint8 masks count the same, and a row length that is not a multiple
    # of 4 lets a sector span two partitions' rows
    assert TP.probe_tables_bytes(torch.from_numpy(bok.astype(np.uint8)), torch.from_numpy(pok))[0] == got_in
    odd = np.zeros((2, 3), bool)
    odd[0, 2], odd[1, 0] = True, True  # flat slots 2 and 3: one sector
    assert TP.probe_tables_bytes(torch.from_numpy(odd), torch.from_numpy(odd)) == (12 + 2 * 32, 4 * 6 + 1)


def _cv(vals, nulls, types_mod, val_cls, arr):
    return val_cls(arr(np.asarray(vals, np.int64)), arr(np.asarray(nulls, bool)), types_mod.new_longlong())


@pytest.mark.parametrize("plan,skew", [((8, 16, 64, 1024), 0.5), ((8, 16, 16, 64), 1.0), ((4, 128, 1024, 1024), 0.0)],
                         ids=["escape", "escape_overflow", "uniform"])
def test_probe_partitioned_matches_jax_dense(plan, skew):
    rng = np.random.default_rng(3)
    nb, np_ = 32, 512
    bw = np.arange(nb, dtype=np.int64)
    pw = np.where(rng.random(np_) < skew, np.int64(7), rng.integers(0, 40, np_)).astype(np.int64)
    bu = rng.random(nb) < 0.95
    pu = rng.random(np_) < 0.95
    jout = JR._probe_partitioned(jnp.asarray(bw), jnp.asarray(bu), jnp.asarray(pw), jnp.asarray(pu), plan, 4096, "dense")
    tout = TR._probe_partitioned(torch.from_numpy(bw), torch.from_numpy(bu), torch.from_numpy(pw),
                                 torch.from_numpy(pu), plan, 4096)
    names = ("build_idx", "matched", "dup", "esc_over", "need", "escapes")
    for nm, a, b in zip(names, jout, tout):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and (a.astype(np.int64) == b.astype(np.int64)).all(), nm
    if skew > 0:
        assert int(tout[5]) > 0  # the hot partition escaped
    assert bool(tout[3]) == (plan[3] == 64)


@pytest.mark.parametrize("jt", ["inner", "left_outer", "semi", "anti"])
def test_radix_hash_join_matches_jax(jt):
    """The port's kernel strategy against JAX's Pallas strategy (interpret)
    on every JoinResult field, at a kernel-eligible plan."""
    rng = np.random.default_rng(8)
    nb, np_ = 100, 2000
    bw = rng.permutation(np.arange(-50, 50))
    pw = rng.integers(-70, 70, np_)
    bn, pn = rng.random(nb) < 0.1, rng.random(np_) < 0.1
    bv, pv = rng.random(nb) < 0.95, rng.random(np_) < 0.95
    plan = (2, 128, 1024, 1024)
    assert TR.probe_strategy(*plan[:3]) == "kernel" and JR.probe_strategy(*plan[:3]) == "pallas-interpret"
    jres, jesc = JR.radix_hash_join([_cv(bw, bn, JT, JVal, jnp.asarray)], [_cv(pw, pn, JT, JVal, jnp.asarray)],
                                    jnp.asarray(bv), jnp.asarray(pv), jt, 4096, plan)
    tres, tesc = TR.radix_hash_join([_cv(bw, bn, TT, TVal, torch.from_numpy)], [_cv(pw, pn, TT, TVal, torch.from_numpy)],
                                    torch.from_numpy(bv), torch.from_numpy(pv), jt, 4096, plan)
    for f in ("probe_idx", "build_idx", "build_null", "out_valid", "n_out", "overflow", "need"):
        a, b = np.asarray(getattr(jres, f)), getattr(tres, f).numpy()
        assert a.shape == b.shape and (a.astype(np.int64) == b.astype(np.int64)).all(), f
    assert jres.probe_identity == tres.probe_identity and int(jesc) == int(tesc)
    assert int(tres.n_out) > 0


def test_radix_plan_matches_jax():
    for nb in (1, 16, 100, 1 << 10, 1 << 14, 1 << 17, 1 << 20):
        for np_ in (8, 1000, 1 << 12, 1 << 16, 1 << 19, 1 << 22, 1 << 24):
            for jc in (64, 4096, 1 << 22, 1 << 25):
                assert TR.radix_plan(nb, np_, jc) == JR.radix_plan(nb, np_, jc), (nb, np_, jc)
    assert TR.radix_plan(1 << 17, 1 << 22, 1 << 22) == (4096, 128, 2048, 1 << 18)


def test_probe_strategy_is_kernel_exactly_where_the_tpu_gate_passes():
    for P in (2, 64, 4096, 1 << 15, 1 << 16):
        for part_cap in (128, 256, 512):
            for probe_cap in (8, 512, 1024, 2048, 3072, 4096):
                want = JP.pallas_probe_eligible(P, part_cap, probe_cap) is not None
                assert (TR.probe_strategy(P, part_cap, probe_cap) == "kernel") == want, (P, part_cap, probe_cap)
                assert TP.probe_kernel_eligible(P, part_cap, probe_cap) == want
