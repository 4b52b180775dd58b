"""K2 and K3 — the post-sort passes of the packed join+group chain
(tidb_tpu_torch/ops/joinscan.py) — against the JAX package's Pallas kernels
run in interpret mode on the CPU: the plain torch versions must be
bit-equal on every [n] output, the overflow flag and the join rows. Then
membership_chain and packed_join_groupsum, the port against the JAX
package (interpret), including the INT32_MIN key (a phantom-key guard) and
a key over 2^30 (overflow), and a case whose only JAX overflow is the TPU
kernel's run-length cap, which the port does not have."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.ops.joinagg as JA
import tidb_tpu.ops.joinscan as JSC
import tidb_tpu.types as JT
from tidb_tpu.chunk.device import DeviceBatch as JBatch
from tidb_tpu.chunk.device import DeviceColumn as JColumn
from tidb_tpu.exec.builder import ProgramCache as JCache
from tidb_tpu.exec.executor import drive_program_info as j_drive
from tidb_tpu.expr.compile import CompVal as JVal

import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.ops.joinagg as TA
import tidb_tpu_torch.ops.joinscan as TSC
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
from tidb_tpu_torch.exec.executor import drive_program_info as t_drive
from tidb_tpu_torch.expr.compile import CompVal as TVal
from tidb_tpu_torch.interop import device_batch_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """Jitted subfunctions cached by other modules under another x64
    weak-type state can break the Pallas interpret lowering."""
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "interpret")


class _Agg:
    def __init__(self, name):
        self.name = name


def _case(name):
    """(hay keys, probe keys with None for NULL) of tests/test_joinscan.py's
    cases."""
    rng = np.random.default_rng(0)
    if name == "basic":
        return np.arange(50), list(rng.integers(0, 64, 700))
    if name == "null_probe":
        return np.arange(1, 4), [1, None, 2, None, 1, 3]
    if name == "unmatched_negative":
        return np.arange(20), list(rng.integers(-40, 40, 900))
    if name == "dup_build":
        return np.array([1, 1, 2, 3]), list(rng.integers(0, 8, 200))
    T = TSC.K2_TILE
    if name == "long_run":  # key 3's run crosses two of the CUDA kernel's tile boundaries
        return np.arange(10), [3] * (2 * T + 900) + list(rng.integers(0, 12, 400))
    if name == "tile_end":  # runs end at T - 1 and 2T - 1; key 7's unmatched run crosses 3T
        return np.arange(6), [0] * (T - 1) + [1] * (T - 1) + [7] * T + list(rng.integers(3, 7, 300))
    return np.array([0, 1, 7]), [-1, 0, 1, 7, 7]  # min key, no pins


def _inputs(name, lanes, seed=1):
    """Both packages' (hay_key, hay_ok, probe CompVal, probe_ok, aggs) for
    one case; `lanes` picks the value lanes: "count", "nn" (one NOT NULL),
    "null" (one nullable) or "two" (one of each)."""
    rng = np.random.default_rng(seed)
    hay, probe = _case(name)
    np_ = len(probe)
    pnull = np.array([p is None for p in probe])
    pkey = np.array([0 if p is None else p for p in probe], np.int64)
    hay = np.asarray(hay, np.int64)
    hay_ok = np.ones(len(hay), bool)
    pvalid = rng.random(np_) < 0.95
    if name == "tile_end":
        pvalid[:] = True  # no pinned rows: the run ends stay where the case puts them
    v_nn = rng.integers(-10**6, 10**6, np_)
    v_null = rng.integers(-1000, 1000, np_)
    null_mask = rng.random(np_) < 0.2
    spec = {"count": [], "nn": [(v_nn, None)], "null": [(v_null, null_mask)],
            "two": [(v_nn, None), (v_null, null_mask)]}[lanes]

    def build(T, Val, arr):
        LL, NN = T.new_longlong(), T.new_longlong(notnull=True)
        pk = Val(arr(pkey), arr(pnull), LL)
        aggs = [(_Agg("count"), [])]
        for v, nl in spec:
            a = Val(arr(v.astype(np.int64)), arr(np.zeros(np_, bool) if nl is None else nl), NN if nl is None else LL)
            aggs += [(_Agg("sum"), [a]), (_Agg("avg"), [a]), (_Agg("count"), [a])]
        return arr(hay), arr(hay_ok), pk, arr(pvalid) & ~pk.null, aggs

    return build(JT, JVal, jnp.asarray), build(TT, TVal, torch.from_numpy)


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), what


CASES = ["basic", "null_probe", "unmatched_negative", "dup_build", "min_key_no_pins", "long_run", "tile_end"]


K2_MATRIX = [(c, lanes) for c in CASES for lanes in ("nn", "two")] + [("basic", "count"), ("basic", "null")]


@pytest.mark.parametrize("name,lanes", K2_MATRIX)
def test_k2_plain_bit_equal_to_pallas(name, lanes):
    _, (hk, hok, pk, pok, aggs) = _inputs(name, lanes)
    spk, lanes_s, bad, nw_s, nn_bits, _keys = TA.packed_groupsum_lanes(hk, hok, pk, pok, aggs)
    got = TSC._postsort_segscan_plain(spk, lanes_s, bad, nw_s=nw_s, nn_bits=nn_bits)
    want = JSC.postsort_segscan(
        jnp.asarray(spk.numpy()), [jnp.asarray(x.numpy()) for x in lanes_s], jnp.asarray(bad.numpy()),
        nw_s=None if nw_s is None else jnp.asarray(nw_s.numpy()), nn_bits=nn_bits, interpret=True)
    for nm, a, b in zip(("gv", "cnt", "key32"), want[:3], got[:3]):
        _eq(a, b, nm)
    for c in range(len(lanes_s)):
        _eq(want[3][c], got[3][c], f"sum[{c}]")
        _eq(want[4][c], got[4][c], f"nn[{c}]")
    assert bool(want[5]) == bool(got[5]) == (name == "dup_build")
    assert int(want[6]) == int(got[6])
    assert bool(got[0].any())
    if name == "tile_end":
        T = TSC.K2_TILE
        assert bool(got[0][T - 1]) and bool(got[0][2 * T - 1]) and not bool(got[0][T:2 * T - 1].any())


def test_k2_all_rows_usable_emits_the_last_run():
    """The max-key run ends at element n - 1: it must be emitted there."""
    spk = torch.tensor([0, 1, 1, 4, 5, 5, 5], dtype=torch.int32)
    lane = torch.tensor([0, 3, 4, 0, 1, 2, 3], dtype=torch.int32)
    bad = torch.zeros(7, dtype=torch.bool)
    gv, cnt, key32, sums, _nns, ovf, jr = TSC._postsort_segscan_plain(spk, [lane], bad, None, [-1])
    want = JSC.postsort_segscan(jnp.asarray(spk.numpy()), [jnp.asarray(lane.numpy())], jnp.asarray(bad.numpy()),
                                nn_bits=[-1], interpret=True)
    assert gv.tolist() == [False, False, True, False, False, False, True]
    assert sums[0].tolist() == [0, 0, 7, 0, 0, 0, 6] and int(jr) == 5 and not bool(ovf)
    for a, b in zip(want[:3], (gv, cnt, key32)):
        _eq(a, b, "last run")


@pytest.mark.parametrize("seed", range(3))
def test_k3_plain_bit_equal_to_pallas(seed):
    rng = np.random.default_rng(seed)
    no, nc = 400, 60
    inner = rng.permutation(np.arange(-30, 30))
    if seed != 2:
        inner[:5] = inner[5]  # duplicate inner keys
    outer = rng.integers(-40, 40, no)
    payload = rng.integers(0, 1000, no)
    if seed == 1:
        payload[3] = 1 << 40  # outside int32: a bad bit
    o_ok = torch.from_numpy(rng.random(no) < 0.9)
    i_ok = torch.from_numpy(rng.random(nc) < 0.9)
    spk, _spay, wbad = TA.membership_lanes(torch.from_numpy(outer), o_ok, torch.from_numpy(inner), i_ok,
                                           torch.from_numpy(payload))
    ok, ovf = TSC._membership_segscan_plain(spk, wbad)
    jok, jovf = JSC.membership_segscan(jnp.asarray(spk.numpy()), jnp.asarray(wbad.numpy()), interpret=True)
    _eq(jok, ok, "ok_out")
    assert bool(jovf) == bool(ovf) == (seed != 2)
    assert bool(ok.any())


def _chain_inputs(seed, inner_key_fix=None, payload_fix=None):
    rng = np.random.default_rng(seed)
    no, nc = 300, 40
    outer = rng.integers(0, 50, no)
    inner = rng.permutation(nc)
    payload = rng.permutation(no)
    if inner_key_fix is not None:
        inner[0] = inner_key_fix
        outer[:10] = inner_key_fix
    if payload_fix is not None:
        payload[0] = payload_fix
    o_ok = rng.random(no) < 0.9
    i_ok = rng.random(nc) < 0.9
    return outer, o_ok, inner, i_ok, payload


@pytest.mark.parametrize("fix", [None, ("key", -(1 << 31)), ("key", (1 << 30) + 5), ("payload", 1 << 35)],
                         ids=["plain", "int32_min_key", "key_over_2^30", "payload_over_int32"])
def test_membership_chain_matches_jax(fix):
    kw = {} if fix is None else ({"inner_key_fix": fix[1]} if fix[0] == "key" else {"payload_fix": fix[1]})
    outer, o_ok, inner, i_ok, payload = _chain_inputs(7, **kw)
    jout = JA.membership_chain(*(jnp.asarray(x) for x in (outer, o_ok, inner, i_ok, payload)))
    tout = TA.membership_chain(*(torch.from_numpy(np.asarray(x)) for x in (outer, o_ok, inner, i_ok, payload)))
    for nm, a, b in zip(("payload", "ok_out", "overflow"), jout, tout):
        _eq(a, b, nm)
    assert bool(tout[2]) == (fix is not None)
    if fix is not None and fix[0] == "key" and fix[1] < 0:
        # INT32_MIN must not pack to pk 0 and join as a phantom key 0
        sel = tout[1].numpy()
        assert not (tout[0].numpy()[sel] == payload[:10, None]).any()


@pytest.mark.parametrize("probe_fix", [None, -(1 << 31), (1 << 30) + 1], ids=["plain", "int32_min", "over_2^30"])
@pytest.mark.parametrize("lanes", ["nn", "two", "three"])
def test_packed_join_groupsum_matches_jax(lanes, probe_fix):
    """K2 (<= 2 lanes) and the torch scan branch (3 lanes) against the JAX
    package's route for the same lane count."""
    name = "basic"
    spec = "two" if lanes == "three" else lanes
    (jh, jhok, jpk, jpok, jaggs), (th, thok, tpk, tpok, taggs) = _inputs(name, spec)
    if lanes == "three":
        rng = np.random.default_rng(9)
        v3 = rng.integers(-5, 5, tpk.value.shape[0])
        ja = JVal(jnp.asarray(v3), jnp.zeros(v3.shape, bool), JT.new_longlong(notnull=True))
        ta = TVal(torch.from_numpy(v3), torch.zeros(v3.shape, dtype=torch.bool), TT.new_longlong(notnull=True))
        jaggs = jaggs + [(_Agg("sum"), [ja])]
        taggs = taggs + [(_Agg("sum"), [ta])]
    if probe_fix is not None:
        jpk = JVal(jpk.value.at[0].set(probe_fix), jpk.null, jpk.ft)
        tv = tpk.value.clone()
        tv[0] = probe_fix
        tpk = TVal(tv, tpk.null, tpk.ft)
        jpok = jpok.at[0].set(True)
        tpok = tpok.clone()
        tpok[0] = True
    jst, jgv, jkey, jovf, jrows = JA.packed_join_groupsum(jh, jhok, jpk, jpok, jaggs)
    tst, tgv, tkey, tovf, trows = TA.packed_join_groupsum(th, thok, tpk, tpok, taggs)
    _eq(jgv, tgv, "group_valid")
    _eq(jkey.value, tkey.value, "key_out")
    _eq(jrows, trows, "join_rows")
    assert bool(jovf) == bool(tovf) == (probe_fix is not None)
    for i, (a, b) in enumerate(zip(jst, tst)):
        for (jv, jn), (tv_, tn) in zip(a, b):
            _eq(jv, tv_, f"state {i}")
            _eq(jn, tn, f"state null {i}")


def _groupsum_dag(E, X, T):
    """probe(k, v) JOIN build(k, w) on k (unique build), GROUP BY probe k,
    sum(v), count(*)."""
    LL = T.new_longlong(notnull=True)
    ps = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    bs = E.TableScan(2, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    join = E.Join(build=(bs,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),),
                  join_type="inner", build_unique=True)
    agg = E.Aggregation(group_by=(X.col(0, LL),), aggs=(X.AggDesc("sum", (X.col(1, LL),)), X.AggDesc("count", ())))
    return E.DAGRequest((ps, join, agg), output_offsets=(0, 1, 2)), [[LL, LL], [LL, LL]]


def _canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def test_run_cap_overflow_is_gone(monkeypatch):
    """The TPU kernel flags a run over its limb-carry cap (2^23 - 32768
    rows) as overflow; the port's K2 adds int64 and keeps such a run. The
    cap is lowered here so the case fits a CPU test: the JAX kernel flags
    the 40-row run, the port's does not, and the port's rows equal the JAX
    package's non-Pallas route."""
    monkeypatch.setattr(JSC, "_RUN_CAP", JSC.T + 16)
    rng = np.random.default_rng(3)
    pk = np.concatenate([np.full(40, 5), rng.integers(0, 30, 200)]).astype(np.int64)
    v = rng.integers(0, 100, pk.size).astype(np.int64)
    cols = [[(pk, np.zeros(pk.size, bool), None), (v, np.zeros(pk.size, bool), None)],
            [(np.arange(30, dtype=np.int64), np.zeros(30, bool), None),
             (np.zeros(30, np.int64), np.zeros(30, bool), None)]]
    LLt = TT.new_longlong(notnull=True)
    hay = torch.arange(30)
    probe = TVal(torch.from_numpy(pk), torch.zeros(pk.size, dtype=torch.bool), LLt)
    val = TVal(torch.from_numpy(v), torch.zeros(pk.size, dtype=torch.bool), LLt)
    lanes = TA.packed_groupsum_lanes(hay, torch.ones(30, dtype=torch.bool), probe,
                                     torch.ones(pk.size, dtype=torch.bool), [(_Agg("sum"), [val])])
    spk, lanes_s, bad = lanes[:3]
    got = TSC._postsort_segscan_plain(spk, lanes_s, bad, None, [-1])
    want = JSC.postsort_segscan(jnp.asarray(spk.numpy()), [jnp.asarray(lanes_s[0].numpy())],
                                jnp.asarray(bad.numpy()), nn_bits=[-1], interpret=True)
    assert bool(want[5]) and not bool(got[5])
    _eq(want[3][0], got[3][0], "sums")

    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")
    jdag, jfts = _groupsum_dag(JE, JX, JT)
    tdag, tfts = _groupsum_dag(TE, TX, TT)
    jb = [JBatch([JColumn(jnp.asarray(d), jnp.asarray(nl), None, ft) for (d, nl, _), ft in zip(c, f)],
                 jnp.ones(len(c[0][0]), bool), jnp.int32(len(c[0][0]))) for c, f in zip(cols, jfts)]
    tb = [device_batch_from_numpy(c, np.ones(len(c[0][0]), bool), len(c[0][0]), f, device="cpu")
          for c, f in zip(cols, tfts)]
    jrows = _canon(j_drive(JCache(), jdag, jb, 64)[0].rows())
    trows = _canon(t_drive(TCache(), tdag, tb, 64)[0].rows())
    assert trows == jrows and len(trows) == 30
