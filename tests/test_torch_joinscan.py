"""K2 and K3 — the post-sort passes of the packed join+group chain
(tidb_tpu_torch/ops/joinscan.py) — against the JAX package's Pallas kernels
run in interpret mode on the CPU: the plain torch versions must be
bit-equal on every [n] output, the overflow flag and the join rows. Then
membership_chain and packed_join_groupsum, the port against the JAX
package (interpret), including the INT32_MIN key (a phantom-key guard) and
a key over 2^30 (overflow), and a case whose only JAX overflow is the TPU
kernel's run-length cap, which the port does not have. K3's cases at the
CUDA kernel's tile boundaries (K3_TILE) hold its plain version against the
JAX kernel where the tiled kernel's edges lie."""

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


_I32_MIN = -(1 << 31)


def _k3_spk(n, seed, fixed=()):
    """Sorted packed keys of runs (inner 2k heading outer 2k + 1 rows):
    the `fixed` runs first, each (headed by an inner row, rows), then
    random runs of 1-16 rows, 3 in 4 headed, cut at n; the last rows pinned
    (unusable inner, then outer rows)."""
    rng = np.random.default_rng(seed)
    out, key = [], 1
    for headed, rows in fixed:
        out += [2 * key] * int(headed) + [2 * key + 1] * (rows - int(headed))
        key += 1
    while len(out) < n:
        headed, rows = rng.random() < 0.75, int(rng.integers(1, 17))
        out += [2 * key] * int(headed) + [2 * key + 1] * (rows - int(headed))
        key += 1
    spk = np.array(out[:n], np.int64)
    pins = min(4, n // 4)
    spk[n - pins:n - pins // 2] = TSC.PIN
    spk[n - pins // 2:] = TSC.PIN + 1
    return spk


def _k3_edge(name):
    """(spk, bad) of one K3 tile-edge case, boundaries at the CUDA kernel's
    tile size."""
    T = TSC.K3_TILE
    if name == "run_over_one_boundary":
        spk = _k3_spk(2 * T + 7, 1, [(True, T - 50), (True, 200)])
    elif name == "run_over_two_boundaries_headed":
        spk = _k3_spk(4 * T, 2, [(True, T - 100), (True, 2 * T + 300)])
    elif name == "run_over_two_boundaries_not_headed":
        spk = _k3_spk(4 * T, 3, [(True, T - 100), (False, 2 * T + 300)])
    elif name == "runs_start_at_a_tile_end":
        spk = _k3_spk(3 * T, 4, [(True, T - 1), (True, 50), (True, T - 50), (False, 40)])
    elif name == "leading_run_over_32_rows":
        spk = _k3_spk(2 * T + 9, 5, [(True, T - 40), (True, 80)])
    elif name == "duplicate_straddling_a_boundary":
        spk = _k3_spk(3 * T, 6, [(True, T - 1), (True, 60)])
        spk[T] = spk[T - 1]
    elif name == "int32_min_inner_at_element_0":
        spk = np.concatenate([[_I32_MIN], [_I32_MIN + 1] * (T + 50), _k3_spk(2 * T, 7)])
    elif name == "all_pinned":
        spk = np.array([TSC.PIN] * (3 * T // 2) + [TSC.PIN + 1] * (3 * T // 2 + 5), np.int64)
    elif name == "n_1":
        spk = np.array([3], np.int64)
    else:  # bad_bit_on_the_last_row
        spk = _k3_spk(3 * T, 8)
    bad = np.zeros(len(spk), bool)
    if name == "bad_bit_on_the_last_row":
        bad[-1] = True
    return spk.astype(np.int32), bad


K3_EDGES = ["run_over_one_boundary", "run_over_two_boundaries_headed", "run_over_two_boundaries_not_headed",
            "runs_start_at_a_tile_end", "leading_run_over_32_rows", "duplicate_straddling_a_boundary",
            "int32_min_inner_at_element_0", "all_pinned", "n_1", "bad_bit_on_the_last_row"]


@pytest.mark.parametrize("name", K3_EDGES)
def test_k3_tile_edges_bit_equal_to_pallas(name):
    """K3's plain version against the JAX kernel (interpret) on runs placed
    at the CUDA kernel's tile boundaries: runs crossing one and two
    boundaries, runs starting at a tile's last row, a leading run longer
    than the kernel's 32-row window, a duplicate inner key straddling a
    boundary, INT32_MIN at element 0 (whose predecessor is INT32_MIN, so it
    heads no run and is a duplicate), all rows pinned, one row, and a bad
    bit on the last row only."""
    spk, bad = _k3_edge(name)
    ok, ovf = TSC._membership_segscan_plain(torch.from_numpy(spk), torch.from_numpy(bad))
    jok, jovf = JSC.membership_segscan(jnp.asarray(spk), jnp.asarray(bad), interpret=True)
    _eq(jok, ok, "ok_out")
    want_ovf = name in ("duplicate_straddling_a_boundary", "int32_min_inner_at_element_0", "bad_bit_on_the_last_row")
    assert bool(jovf) == bool(ovf) == want_ovf
    T, ok = TSC.K3_TILE, ok.numpy()
    if name == "run_over_two_boundaries_headed":
        assert ok[T - 99:3 * T + 200].all()
    if name == "run_over_two_boundaries_not_headed":
        assert not ok[T - 100:3 * T + 200].any()
    if name == "runs_start_at_a_tile_end":
        assert ok[T:T + 49].all() and not ok[2 * T - 1:2 * T + 39].any()
    if name == "int32_min_inner_at_element_0":
        assert not ok[:T + 51].any()
    if name in ("all_pinned", "n_1"):
        assert not ok.any()


def test_k3_tile_matches_the_source():
    """K3_TILE is the CUDA kernel's rows per CTA (K3_THREADS * K3_ITEMS)."""
    import re

    from tidb_tpu_torch import kernels

    src = (kernels._PKG / kernels.SOURCES["joinscan"]).read_text()
    threads, items = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("K3_THREADS", "K3_ITEMS"))
    assert threads * items == TSC.K3_TILE


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
