"""The port's batched coprocessor on the CPU: the region-stacked batch, the
region-batched program, its driver and the store's batch endpoint,
against the JAX package's and against the port's own single-region path.

(a) to_stacked_device_batch equals the JAX package's leaf by leaf (a
    varlen column padded to the batch-wide width, an empty pad lane);
(b) drive_batched_program_info(device="cpu") equals the JAX package's
    lane by lane (decoded rows, per-executor counts, the lanes that fall
    out as None) and equals the port's single-region drive_program_info
    on every lane that did not fall out, over the scalar aggregate, Q6,
    Q1 with and without the small-G hint, TopN with a tie-heavy lane that
    falls out alone, Sort, Window, Q3 and the join bench (uniform, 700
    groups);
(c) under torch.func.vmap each of K1-K4's ops equals its plain version
    called lane by lane, K4 also with a build table that has no region
    axis (in_dim None);
(d) the store's batch endpoint (mirroring tests/test_batch_cop.py): one
    build then hits per batch shape, one program execution per bucket
    for 17 regions, two capacity buckets from skewed regions, a stale
    epoch and a missing region answered inline, paging requests kept out,
    an overflowing lane riding the single ladder with every row counted
    once;
(e) a JAX TPUStore and a port TPUStore(device="cpu") answer the same
    batch_coprocessor_bytes frame with the same response bytes, the two
    clock fields of every execution summary zeroed, `batched` ids
    included.
Tolerance: exact everywhere (integer and decimal data, no float sums).
"""

import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.codec as JCodec
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.chunk.device import to_device_batch as j_to_batch
from tidb_tpu.chunk.device import to_stacked_device_batch as j_stack
from tidb_tpu.codec import wire as JW
from tidb_tpu.exec.builder import ProgramCache as JCache
from tidb_tpu.exec.executor import drive_batched_program_info as j_drive_batched
from tidb_tpu.store import CopRequest as JReq
from tidb_tpu.store import KeyRange as JRange
from tidb_tpu.store import TPUStore as JStore

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.chunk import to_device_batch as t_to_batch
from tidb_tpu_torch.chunk import to_stacked_device_batch as t_stack
from tidb_tpu_torch.exec.builder import ProgramCache as TCache
from tidb_tpu_torch.exec.executor import drive_batched_program_info as t_drive_batched
from tidb_tpu_torch.exec.executor import drive_program_info as t_drive
from tidb_tpu_torch.exec.ladder import rung_for
from tidb_tpu_torch.ops import dense_agg as K1
from tidb_tpu_torch.ops import join_probe as K4
from tidb_tpu_torch.ops import joinscan as K23
from tidb_tpu_torch.store import CopRequest as TReq
from tidb_tpu_torch.store import KeyRange as TRange
from tidb_tpu_torch.store import TPUStore as TStore


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def _pow2(n):
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


# ---------------------------------------------------------------------------
# (a) the region-stacked batch
# ---------------------------------------------------------------------------

def _str_chunks(mod, cmod, ft, seed):
    """Three same-schema chunks (int64 with NULLs, a varchar of region-
    dependent widths) and an empty pad lane."""
    rng = np.random.default_rng(seed)
    out = []
    for n, w in ((5, 3), (7, 9), (3, 1)):
        rows = [[mod.Datum.NULL if rng.random() < 0.2 else mod.Datum.i64(int(rng.integers(-50, 50))),
                 mod.Datum.NULL if rng.random() < 0.2 else mod.Datum.string(
                     "".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(0, w + 1)))))]
                for _ in range(n)]
        out.append(cmod.Chunk.from_rows(ft, rows))
    out.append(cmod.Chunk.empty(ft))
    return out


def test_stacked_batch_equals_the_jax_one_leaf_by_leaf():
    jfts = [JT.new_longlong(), JT.new_varchar(16)]
    tfts = [TT.new_longlong(), TT.new_varchar(16)]
    jb = j_stack(_str_chunks(JT, JC, jfts, 1), 8)
    tb = t_stack(_str_chunks(TT, TC, tfts, 1), 8, device="cpu")
    assert np.array_equal(tb.row_valid.numpy(), np.asarray(jb.row_valid))
    assert np.array_equal(tb.n_rows.numpy(), np.asarray(jb.n_rows))
    assert tb.n_rows.tolist() == [5, 7, 3, 0]
    for tc, jc in zip(tb.cols, jb.cols):
        assert np.array_equal(tc.data.numpy(), np.asarray(jc.data))
        assert np.array_equal(tc.null.numpy(), np.asarray(jc.null))
        assert (tc.length is None) == (jc.length is None)
        if tc.length is not None:
            assert np.array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert tuple(tb.cols[1].data.shape) == (4, 8, 9)  # the batch-wide varlen width


def test_stacked_batch_refuses_non_ascii_under_ci():
    """Every lane is checked, as to_device_batch checks a region."""
    ft = TT.new_varchar(8, collate=TT.Collation.Utf8MB4GeneralCI)
    chunks = [TC.Chunk.from_rows([ft], [[TT.Datum.string("abc")]]),
              TC.Chunk.from_rows([ft], [[TT.Datum.string("été")]])]
    with pytest.raises(NotImplementedError):
        t_stack(chunks, 2, device="cpu")


# ---------------------------------------------------------------------------
# (b) the region-batched program through its driver
# ---------------------------------------------------------------------------

N = 2048


def _lineitem(n, seed):
    return W.make_tables(n, seed)


def _tie(n, seed):
    t = W.make_tables(n, seed)
    t["price"] = np.full(n, 123456, np.int64)  # every price equal: TopN's sampled threshold misses
    return t


# name -> (dag builder, per-lane probe columns, aux columns, group capacity, small-G hint)
CASES = {
    "scalar": (W.scalar_agg_dag, lambda s: W.scalar_agg_columns(_lineitem(N - 300 * s, s)), None, 64, None),
    "q6": (W.q6_dag, lambda s: W.q6_columns(_lineitem(N - 300 * s, s)), None, 64, None),
    "q1": (W.q1_dag, lambda s: W.q1_columns(_lineitem(N - 300 * s, s)), None, 64, None),
    "q1 hint 16": (W.q1_dag, lambda s: W.q1_columns(_lineitem(N - 300 * s, s)), None, 64, 16),
    "topn, a tie-heavy lane": (W.topn_dag, lambda s: W.topn_columns((_tie if s == 1 else _lineitem)(N - 300 * s, s)),
                               None, 64, None),
    "sort": (W.sort_dag, lambda s: W.topn_columns(_lineitem(N - 300 * s, s)), None, 64, None),
    "window": (W.window_dag, lambda s: W.q3_columns(N, s)[0], None, 64, None),
    "q3": (W.q3_dag, lambda s: W.q3_columns(N, s)[0], lambda: W.q3_columns(N, 0)[1:], rung_for(N // 4), None),
    "join uniform": (W.join_bench_dag, lambda s: W.join_bench_columns(N, 32, False, seed=7 + s)[0],
                     lambda: W.join_bench_columns(N, 32, False)[1:], 128, None),
    "join 700 groups": (lambda E, X, T: W.join_bench_dag(E, X, T, groups=700),
                        lambda s: W.join_bench_columns(N, 32, False, 700, seed=7 + s)[0],
                        lambda: W.join_bench_columns(N, 32, False, 700)[1:], rung_for(700), None),
}
LANES = 3  # padded to 4 with an empty lane, as the store pads


@pytest.mark.parametrize("name", list(CASES))
def test_batched_driver_matches_jax_and_the_single_region_path(name):
    build, lane_cols, aux_cols, gcap, smg = CASES[name]
    jdag, jfts = build(JE, JX, JT)
    tdag, tfts = build(TE, TX, TT)
    jfts = jfts if isinstance(jfts[0], list) else [jfts]
    tfts = tfts if isinstance(tfts[0], list) else [tfts]
    lanes = [lane_cols(s) for s in range(LANES)]
    aux = aux_cols() if aux_cols else []
    cap = _pow2(max(len(c[0][0]) for c in lanes))
    jchunks = [W.make_chunk(JC, jfts[0], c) for c in lanes] + [JC.Chunk.empty(jfts[0])]
    tchunks = [W.make_chunk(TC, tfts[0], c) for c in lanes] + [TC.Chunk.empty(tfts[0])]
    jaux = [j_to_batch(W.make_chunk(JC, f, c), capacity=_pow2(len(c[0][0]))) for c, f in zip(aux, jfts[1:])]
    taux = [t_to_batch(W.make_chunk(TC, f, c), capacity=_pow2(len(c[0][0])), device="cpu")
            for c, f in zip(aux, tfts[1:])]
    jper, _ = j_drive_batched(JCache(), jdag, j_stack(jchunks, cap), jaux, gcap, small_groups=smg)
    cache = TCache()
    tper, tinfo = t_drive_batched(cache, tdag, t_stack(tchunks, cap, device="cpu"), taux, gcap, small_groups=smg)
    assert cache.stats()["compiles"] == 1 and len(tper) == LANES + 1
    fell = [p is None for p in tper]
    assert fell == [p is None for p in jper]
    assert fell == ([False, True, False, False] if name.startswith("topn") else [False] * 4)
    for b, (tp, jp) in enumerate(zip(tper, jper)):
        if tp is None:
            continue
        assert canon(tp[0].rows()) == canon(jp[0].rows()), b
        assert tp[1] == jp[1], b
        single, counts, _ = t_drive(TCache(), tdag, [t_to_batch(tchunks[b], capacity=cap, device="cpu")] + taux,
                                    gcap, small_groups=smg)
        assert canon(tp[0].rows()) == canon(single.rows()), b
        assert tp[1] == counts, b
    if name.startswith("join"):
        assert tinfo["radix"]["escapes_by_lane"] == [0] * 4


# ---------------------------------------------------------------------------
# (c) K1-K4 under torch.func.vmap against their plain versions per lane
# ---------------------------------------------------------------------------

def _eq(got, want):
    got = [x for o in got for x in (o if isinstance(o, (list, tuple)) else [o])]
    want = [x for o in want for x in (o if isinstance(o, (list, tuple)) else [o])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _lane(outs, b):
    return [[x[b] for x in o] if isinstance(o, (list, tuple)) else o[b] for o in outs]


def test_k1_under_vmap_equals_its_plain_version_per_lane():
    rng = np.random.default_rng(5)
    B, n, G = 3, 1500, 8
    keys = rng.integers(0, 6, (B, n))
    keys[2] = rng.integers(0, 12, n)  # lane 2 overflows: 12 keys > G
    salt = rng.integers(0, 1 << 62, 12)
    hp, hv = torch.from_numpy(salt[keys]), torch.from_numpy(salt[keys] ^ 0x33)
    valid = torch.from_numpy(rng.random((B, n)) < 0.9)
    vals = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (B, n))) for _ in range(2)]
    nulls = [torch.from_numpy(rng.random((B, n)) < 0.2) for _ in range(2)]
    shared_val = torch.from_numpy(rng.integers(-9, 9, n))  # no region axis
    got = torch.func.vmap(lambda a, b, c, v0, v1, m0, m1: K1.dense_agg(a, b, c, [v0, shared_val], [m0, m1], G))(
        hp, hv, valid, vals[0], vals[1], nulls[0], nulls[1])
    for b in range(B):
        want = K1._dense_agg_plain(hp[b], hv[b], valid[b], [vals[0][b], shared_val], [nulls[0][b], nulls[1][b]], G)
        _eq(_lane(got, b), want)
    assert got[2].tolist() == [False, False, True]


def _k2_inputs(rng, B, n):
    spk = np.sort(rng.integers(0, 400, (B, n)).astype(np.int32), axis=1)
    spk[:, -20:] = K23.PIN + 1  # a pinned tail
    lanes = [np.where(spk & 1, rng.integers(-1000, 1000, (B, n)), 0).astype(np.int32) for _ in range(2)]
    bad = rng.random((B, n)) < 0.0005
    nw = rng.integers(0, 4, (B, n)).astype(np.uint8)
    T = torch.from_numpy
    return T(spk), [T(x) for x in lanes], T(bad), T(nw)


def test_k2_and_k3_under_vmap_equal_their_plain_versions_per_lane():
    rng = np.random.default_rng(9)
    B, n = 4, 3000
    spk, lanes, bad, nw = _k2_inputs(rng, B, n)
    got = torch.func.vmap(lambda s, l0, l1, b, w: K23.postsort_segscan(s, [l0, l1], b, w, (1, -1)))(
        spk, lanes[0], lanes[1], bad, nw)
    for b in range(B):
        _eq(_lane(got, b), K23._postsort_segscan_plain(spk[b], [lanes[0][b], lanes[1][b]], bad[b], nw[b], (1, -1)))
    got3 = torch.func.vmap(K23.membership_segscan)(spk, bad)
    for b in range(B):
        _eq(_lane(got3, b), K23._membership_segscan_plain(spk[b], bad[b]))
    # a region axis that is not the first one (in_dims=1)
    got3t = torch.func.vmap(K23.membership_segscan, in_dims=1)(spk.t().contiguous(), bad.t().contiguous())
    _eq(got3t, got3)


@pytest.mark.parametrize("shared", [True, False])
def test_k4_under_vmap_equals_its_plain_version_per_lane(shared):
    rng = np.random.default_rng(11)
    B, P, part_cap, probe_cap = 3, 8, 16, 64
    bk = torch.from_numpy(rng.integers(0, 50, (P, part_cap)))
    bo = torch.from_numpy(rng.random((B, P, part_cap)) < 0.7)
    pk = torch.from_numpy(rng.integers(0, 60, (B, P, probe_cap)))
    po = torch.from_numpy(rng.random((B, P, probe_cap)) < 0.8)
    if shared:  # the broadcast build side: key table and slot mask without the region axis
        bo = bo[0]
        got = torch.func.vmap(lambda p, q: K4.probe_tables(bk, bo, p, q))(pk, po)
    else:
        bks = torch.stack([bk, bk.flip(0), bk + 1])
        got = torch.func.vmap(K4.probe_tables)(bks, bo, pk, po)
    for b in range(B):
        want = K4._probe_tables_plain(bk if shared else bks[b], bo if shared else bo[b], pk[b], po[b])
        _eq(_lane(got, b), want)


def test_vmapped_ops_count_no_launch_on_the_cpu():
    """The plain versions launch nothing: the launch counters stay put."""
    before = (K1.dense_agg.launches, K23.postsort_segscan.launches, K23.membership_segscan.launches,
              K4.probe_tables.launches)
    test_k2_and_k3_under_vmap_equal_their_plain_versions_per_lane()
    assert before == (K1.dense_agg.launches, K23.postsort_segscan.launches, K23.membership_segscan.launches,
                      K4.probe_tables.launches)


# ---------------------------------------------------------------------------
# (d) the store's batch endpoint
# ---------------------------------------------------------------------------

TID = 91
FT = TT.new_longlong()
BOOL = TT.new_longlong(notnull=True)


def _fill(n=340, regions=17, splits=None):
    store = TStore(device="cpu")
    for h in range(n):
        store.put_row(TID, h, [1], [TT.Datum.i64(h * 3)], ts=10)
    for b in (splits or [i * n // regions for i in range(1, regions)]):
        store.cluster.split(TCodec.encode_row_key(TID, b))
    return store


def _scan_dag():
    return TE.DAGRequest((TE.TableScan(TID, (TE.ColumnInfo(1, FT),)),), output_offsets=(0,))


def _full():
    return [TRange(TCodec.record_prefix(TID), TCodec.record_prefix(TID + 1))]


def _reqs(store, dag, ts=100, **kw):
    return [TReq(dag, _full(), ts, r.region_id, r.epoch, **kw) for r in store.cluster.regions()]


def _vals(resps):
    return sorted(int(v) for r in resps for v in r.chunk.columns[0].data)


def test_one_program_execution_for_17_regions():
    store = _fill(340, 17)
    assert len(store.cluster.regions()) == 17
    s0 = store.programs.stats()
    resps = store.batch_coprocessor(_reqs(store, _scan_dag()))
    s1 = store.programs.stats()
    # one program fetched from the cache (built once) and run once
    assert (s1["compiles"] + s1["hits"]) - (s0["compiles"] + s0["hits"]) == 1
    assert s1["compiles"] - s0["compiles"] == 1
    st = store.stats()
    assert (st["batch_batches"], st["batch_regions"], st["batch_launches_saved"]) == (1, 17, 16)
    assert st["batch_fallbacks"] == 0
    assert _vals(resps) == [h * 3 for h in range(340)]
    assert all(r.batched == 1 and len(r.exec_summaries) == 1 for r in resps)


def test_one_build_then_hits_per_batch_shape():
    store = _fill(340, 17)
    store.batch_coprocessor(_reqs(store, _scan_dag()))
    for ts in (200, 300, 400):
        # a write moves the store's write version: the result cache misses
        # and the regions decode again, but the program shape is the same
        store.put_row(TID, 0, [1], [TT.Datum.i64(0)], ts=ts - 10)
        s0 = store.programs.stats()
        resps = store.batch_coprocessor(_reqs(store, _scan_dag(), ts))
        s1 = store.programs.stats()
        assert s1["compiles"] == s0["compiles"] and s1["hits"] - s0["hits"] == 1
        assert _vals(resps) == [h * 3 for h in range(340)]


def test_capacity_buckets_split_skewed_regions(monkeypatch):
    """4 regions of 20 rows and 3 of 40: two buckets (capacities 32 and
    64), the first padded to 4 lanes, never one 64-capacity program over
    all seven."""
    import tidb_tpu_torch.store.store as S

    store = _fill(200, splits=[20, 40, 60, 80, 120, 160])
    seen = []
    real = S.to_stacked_device_batch
    monkeypatch.setattr(S, "to_stacked_device_batch",
                        lambda chunks, cap, device: seen.append((len(chunks), cap)) or real(chunks, cap, device=device))
    resps = store.batch_coprocessor(_reqs(store, _scan_dag()))
    assert sorted(seen) == [(4, 32), (4, 64)]
    st = store.stats()
    assert (st["batch_batches"], st["batch_regions"], st["batch_launches_saved"]) == (2, 7, 5)
    assert sorted({r.batched for r in resps}) == [1, 2]
    assert _vals(resps) == [h * 3 for h in range(200)]


def test_stale_epoch_and_missing_region_answer_inline():
    store = _fill(200, 4)
    reqs = _reqs(store, _scan_dag())
    regions = store.cluster.regions()
    reqs[1] = TReq(_scan_dag(), _full(), 100, regions[1].region_id, regions[1].epoch + 7)
    reqs[2] = TReq(_scan_dag(), _full(), 100, 4242, 1)
    resps = store.batch_coprocessor(reqs)
    assert resps[1].region_error.startswith("epoch_not_match")
    assert resps[2].region_error == "region 4242 not found"
    ok = [resps[0], resps[3]]
    assert all(r.region_error is None and r.chunk is not None and r.batched == 1 for r in ok)
    assert store.stats()["batch_regions"] == 2


def test_paging_requests_stay_out_of_the_batch():
    store = _fill(200, 4)
    resps = store.batch_coprocessor(_reqs(store, _scan_dag(), paging_size=16))
    assert store.stats()["batch_batches"] == 0
    assert all(r.batched == 0 and r.last_range is not None for r in resps)
    assert all(r.chunk.num_rows() == 16 for r in resps)


def test_overflowing_lane_rides_the_single_ladder():
    """Four regions of 100 rows in one bucket: region 0 holds 100
    distinct keys (more than the smallest group-capacity rung, 64), the
    others 10. Only region 0's flag fires; it alone takes the single
    path's ladder, and every row is counted once."""
    store = TStore(device="cpu")
    for h in range(400):
        store.put_row(TID, h, [1], [TT.Datum.i64(h if h < 100 else h % 10)], ts=10)
    for b in (100, 200, 300):
        store.cluster.split(TCodec.encode_row_key(TID, b))
    scan = TE.TableScan(TID, (TE.ColumnInfo(1, FT),))
    agg = TE.Aggregation(group_by=(TX.col(0, FT),), aggs=(TX.AggDesc("count", ()),), partial=True)
    dag = TE.DAGRequest((scan, agg), output_offsets=(0, 1))
    resps = store.batch_coprocessor(_reqs(store, dag), group_capacity=2)
    assert all(r.region_error is None and r.other_error is None for r in resps)
    assert [r.batched for r in resps] == [0, 1, 1, 1]
    assert [r.chunk.num_rows() for r in resps] == [100, 10, 10, 10]
    assert sum(int(v) for r in resps for v in r.chunk.columns[0].data) == 400  # every row once
    st = store.stats()
    assert (st["batch_batches"], st["batch_regions"], st["oracle_fallbacks"]) == (1, 3, 0)


def test_a_failing_bucket_falls_back_region_by_region(monkeypatch):
    """An error in the batched program sends its bucket's regions through
    the single path (which owns the ladder and the oracle fallback), and
    the store counts the fallback."""
    import tidb_tpu_torch.store.store as S

    def boom(*a, **k):
        raise RuntimeError("the batched program failed")

    store = _fill(200, 4)
    monkeypatch.setattr(S, "drive_batched_program_info", boom)
    resps = store.batch_coprocessor(_reqs(store, _scan_dag()))
    assert [r.batched for r in resps] == [0, 0, 0, 0]
    assert _vals(resps) == [h * 3 for h in range(200)]
    st = store.stats()
    assert (st["batch_fallbacks"], st["batch_batches"], st["device_served"]) == (1, 0, 4)


def test_result_cache_answers_a_repeat_inline():
    store = _fill(200, 4)
    first = store.batch_coprocessor(_reqs(store, _scan_dag()))
    again = store.batch_coprocessor(_reqs(store, _scan_dag()))
    assert store.stats()["result_cache_hits"] == 4 and store.stats()["batch_batches"] == 1
    assert _vals(first) == _vals(again)


# ---------------------------------------------------------------------------
# (e) the batch frame, byte for byte against the JAX store
# ---------------------------------------------------------------------------

SN, SPLITS, N_ORDERS = 600, (150, 300, 400, 500), 96
STID = W.LINEITEM_TABLE_ID
FULL = (b"", b"\xff" * 16)


@pytest.fixture(scope="module")
def pair():
    t = W.store_lineitem(SN, N_ORDERS, seed=3)
    js, ts_ = JStore(), TStore(device="cpu")
    jts, tts = js.next_ts(), ts_.next_ts()
    assert jts == tts
    js.txn.bulk_ingest(W.store_items(JCodec, W.store_rows(JT, t)), jts)
    ts_.bulk_ingest(W.store_items(TCodec, W.store_rows(TT, t)), tts)
    for h in SPLITS:
        js.cluster.split(JCodec.encode_row_key(STID, h))
        ts_.cluster.split(TCodec.encode_row_key(STID, h))
    assert [(r.region_id, r.epoch) for r in js.cluster.regions()] == \
        [(r.region_id, r.epoch) for r in ts_.cluster.regions()]
    return js, ts_


def _canon_frame(b: bytes) -> bytes:
    resps = JW.decode_batch_cop_response(b)
    for r in resps:
        for s in r.exec_summaries:
            s.time_processed_ns = 0
            s.time_compile_ns = 0
    return JW.encode_batch_cop_response(resps)


@pytest.mark.parametrize("name", ["q6", "q1", "topn", "q3", "join"])
def test_batch_frame_answers_as_the_jax_store(pair, name):
    js, ts_ = pair
    js.evict_caches()
    ts_.evict_caches()
    jdag, jfts = W.store_dags(JE, JX, JT)[name]
    aux = []
    if name == "q3":
        aux = [W.make_chunk(JC, f, c) for c, f in zip(W.store_q3_build_columns(N_ORDERS, 24, seed=3), jfts)]
    elif name == "join":
        aux = [W.make_chunk(JC, f, c) for c, f in zip(W.store_join_build_columns(N_ORDERS // 2), jfts)]
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    regions = js.cluster.regions()
    reqs = [JReq(dag=jdag, ranges=[JRange(*FULL)], start_ts=ts, region_id=r.region_id, region_epoch=r.epoch,
                 aux_chunks=list(aux), small_groups=16 if name == "q1" else None) for r in regions]
    # a stale epoch rides in the same frame
    r1 = regions[1]
    reqs.append(JReq(dag=jdag, ranges=[JRange(*FULL)], start_ts=ts, region_id=r1.region_id,
                     region_epoch=r1.epoch - 1, aux_chunks=list(aux)))
    frame = JW.encode_batch_cop_request(reqs)
    jb, tb = js.batch_coprocessor_bytes(frame), ts_.batch_coprocessor_bytes(frame)
    assert _canon_frame(tb) == _canon_frame(jb)
    resps = JW.decode_batch_cop_response(tb)
    # regions of 150, 150, 100, 100 and 100 rows: buckets of capacity 256
    # (two lanes) and 128 (three lanes, padded to four)
    assert [r.batched for r in resps] == [1, 1, 2, 2, 2, 0]
    assert resps[-1].region_error.startswith("epoch_not_match")
    # the repeat: result-cache hits for the cacheable DAGs, the same bytes
    jb2, tb2 = js.batch_coprocessor_bytes(frame), ts_.batch_coprocessor_bytes(frame)
    assert _canon_frame(tb2) == _canon_frame(jb2)
