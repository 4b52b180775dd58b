"""The port's coprocessor store against the JAX package's, over the wire.

A JAX TPUStore and a port TPUStore(device="cpu") hold the same lineitem
rows (workloads.store_rows, one bulk ingest at the same timestamp) in the
same three regions. The JAX package's codec encodes each request, both
stores' `coprocessor_bytes` answer it, and the two answers, decoded, must
be equal in everything but the two clock fields of each execution summary
(time_processed_ns, time_compile_ns): they are re-encoded with the clocks
zeroed and compared byte for byte. Tolerance: exact everywhere.

The cases: Q6, Q1 with the small-G hint (K1's plain version runs in the
port), Q3 and the join bench with their build sides as aux chunks, TopN,
Sort, a paged Selection followed through its cursors, a stale epoch, a
missing region, malformed bytes, a repeat (a result-cache hit), a write
between two requests (a miss), an `upper` projection (both stores run it
on their device: the same bytes, no oracle fallback), and a `replace`
projection and a group_concat (host-only: the oracle in both). The window DAG has no wire frame in
either codec, so it goes through `coprocessor(req)` in both stores and its
responses are compared encoded.
"""

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.codec as JCodec
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.codec import wire as JW
from tidb_tpu.exec.builder import ProgramCache as JCache
from tidb_tpu.store import CopRequest as JReq
from tidb_tpu.store import KeyRange as JRange
from tidb_tpu.store import TPUStore as JStore

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.ops.dense_agg as TK1
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.codec import wire as TW
from tidb_tpu_torch.store import CopRequest as TReq
from tidb_tpu_torch.store import KeyRange as TRange
from tidb_tpu_torch.store import TPUStore as TStore

N = 600
SPLITS = (200, 400)  # three regions of 200 rows
N_ORDERS = 96
TID = W.LINEITEM_TABLE_ID
FULL = (b"", b"\xff" * 16)


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def _make_pair(n=N, n_orders=N_ORDERS, splits=SPLITS):
    t = W.store_lineitem(n, n_orders, seed=3)
    js, ts_ = JStore(), TStore(device="cpu")
    jts, tts = js.next_ts(), ts_.next_ts()
    assert jts == tts
    js.txn.bulk_ingest(W.store_items(JCodec, W.store_rows(JT, t)), jts)
    ts_.bulk_ingest(W.store_items(TCodec, W.store_rows(TT, t)), tts)
    for h in splits:
        js.cluster.split(JCodec.encode_row_key(TID, h))
        ts_.cluster.split(TCodec.encode_row_key(TID, h))
    jr = [(r.region_id, r.epoch) for r in js.cluster.regions()]
    assert jr == [(r.region_id, r.epoch) for r in ts_.cluster.regions()]
    return js, ts_, t


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


@pytest.fixture(autouse=True)
def _fresh_results(request):
    """Each test starts with no decoded chunk and no cached response in the
    module's stores (so a test sees its own cache misses and hits)."""
    if "pair" in request.fixturenames:
        js, ts_, _ = request.getfixturevalue("pair")
        js.evict_caches()
        ts_.evict_caches()


def _aux(build_cols, aux_fts):
    return ([W.make_chunk(JC, f, c) for c, f in zip(build_cols, aux_fts[0])],
            [W.make_chunk(TC, f, c) for c, f in zip(build_cols, aux_fts[1])])


def _dags(name):
    jdag, jfts = W.store_dags(JE, JX, JT)[name]
    tdag, tfts = W.store_dags(TE, TX, TT)[name]
    return (jdag, tdag), (jfts, tfts)


def _regions(js):
    return [(r.region_id, r.epoch) for r in js.cluster.regions()]


def _request_bytes(dag, rid, epoch, ts, aux=(), ranges=(FULL,), **kw):
    return JW.encode_cop_request(JReq(dag=dag, ranges=[JRange(*r) for r in ranges], start_ts=ts, region_id=rid,
                                      region_epoch=epoch, aux_chunks=list(aux), **kw))


def _canon(resp_bytes: bytes) -> bytes:
    """The response re-encoded with its clock fields zeroed."""
    resp = JW.decode_cop_response(resp_bytes)
    for s in resp.exec_summaries:
        s.time_processed_ns = 0
        s.time_compile_ns = 0
    return JW.encode_cop_response(resp)


def _both(js, ts_, req_bytes):
    """Both stores answer the same bytes; the answers must agree, clocks
    aside, and each package's codec must decode the other's bytes."""
    jb, tb = js.coprocessor_bytes(req_bytes), ts_.coprocessor_bytes(req_bytes)
    assert _canon(tb) == _canon(jb)
    tresp = TW.decode_cop_response(jb)
    assert TW.encode_cop_response(tresp) == jb
    return JW.decode_cop_response(jb), TW.decode_cop_response(tb)


@pytest.mark.parametrize("name", ["q6", "q1", "topn", "sort", "q3", "join"])
def test_every_region_answers_as_the_jax_store(pair, name, monkeypatch):
    js, ts_, t = pair
    (jdag, _tdag), (jfts, tfts) = _dags(name)
    jaux = []
    if name == "q3":
        jaux, _ = _aux(W.store_q3_build_columns(N_ORDERS, 24, seed=3), (jfts, tfts))
    elif name == "join":
        jaux, _ = _aux(W.store_join_build_columns(N_ORDERS // 2), (jfts, tfts))
    plain = []
    real = TK1._dense_agg_plain
    monkeypatch.setattr(TK1, "_dense_agg_plain", lambda *a, **k: plain.append(1) or real(*a, **k))
    before = ts_.stats()
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    rows = 0
    for rid, epoch in _regions(js):
        smg = 16 if name == "q1" else None
        jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts, jaux, small_groups=smg))
        assert jresp.region_error is None and jresp.other_error is None
        assert tresp.chunk.num_rows() >= 1
        rows += tresp.exec_summaries[0].num_produced_rows
    assert rows == N
    after = ts_.stats()
    assert after["device_served"] - before["device_served"] == 3
    assert after["oracle_fallbacks"] == before["oracle_fallbacks"]
    if name == "q1":
        assert len(plain) == 3  # K1's plain version, once a region


def test_join_at_the_radix_probe_shape(monkeypatch):
    """One region of 4096 rows against 128 orders: the radix plan K4's
    gate takes (its Pallas kernel in interpret mode in the JAX store, its
    plain version in the port), with the same radix attribution on the
    Join's summary in both."""
    import tidb_tpu_torch.ops.join_probe as TK4

    monkeypatch.setenv("TIDB_TPU_PALLAS", "interpret")
    probes = []
    real = TK4._probe_tables_plain
    monkeypatch.setattr(TK4, "_probe_tables_plain", lambda *a, **k: probes.append(1) or real(*a, **k))
    js, ts_, _ = _make_pair(4096, 128, ())
    (jdag, _), (jfts, tfts) = _dags("join")
    jaux, _ = _aux(W.store_join_build_columns(128), (jfts, tfts))
    rid, epoch = _regions(js)[0]
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts, jaux, ranges=[FULL]))
    assert tresp.exec_summaries[2].radix_partitions == 4 and probes == [1]
    assert int(tresp.chunk.columns[1].data[0]) == 4096  # every l_orderkey < 128 finds its order


def test_window_through_the_object_endpoint(pair):
    js, ts_, _ = pair
    (jdag, tdag), _ = _dags("window")
    with pytest.raises(NotImplementedError, match="Window"):
        JW.encode_dag(jdag)
    with pytest.raises(NotImplementedError, match="Window"):
        TW.encode_dag(tdag)
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    for rid, epoch in _regions(js):
        jresp = js.coprocessor(JReq(dag=jdag, ranges=[JRange(*FULL)], start_ts=ts, region_id=rid, region_epoch=epoch))
        tresp = ts_.coprocessor(TReq(dag=tdag, ranges=[TRange(*FULL)], start_ts=ts, region_id=rid, region_epoch=epoch))
        assert tresp.other_error is None and tresp.chunk.num_rows() == 200
        assert _canon(TW.encode_cop_response(tresp)) == _canon(JW.encode_cop_response(jresp))


def test_paged_selection_follows_its_cursor(pair):
    js, ts_, t = pair
    jdag = W.store_selection_dag(JE, JX, JT)
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    got = []
    for rid, epoch in _regions(js):
        ranges, pages = [FULL], 0
        while ranges is not None:
            jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts, ranges=ranges, paging_size=64))
            got += [int(v) for v in tresp.chunk.columns[0].data]
            ranges = None if tresp.last_range is None else [(r.start, r.end) for r in tresp.last_range]
            pages += 1
        assert pages == 4  # 200 rows a region in pages of 64: the fourth drains it
    cut = JT.MyTime.parse("1995-03-15", 0).packed
    want = t["okey"][(t["shipdate"] > cut) & (t["disc"] >= 5)]
    assert got == want.tolist()


def test_paging_refuses_an_aggregation(pair):
    js, ts_, _ = pair
    (jdag, _), _ = _dags("q6")
    rid, epoch = _regions(js)[0]
    jresp, _ = _both(js, ts_, _request_bytes(jdag, rid, epoch, js.next_ts() and ts_.next_ts(), paging_size=64))
    assert jresp.other_error.startswith("paging requires a row-local DAG")


def test_region_errors_and_malformed_bytes(pair):
    js, ts_, _ = pair
    (jdag, _), _ = _dags("q6")
    rid, epoch = _regions(js)[1]
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    stale, _ = _both(js, ts_, _request_bytes(jdag, rid, epoch - 1, ts))
    assert stale.region_error == f"epoch_not_match: have {epoch}, got {epoch - 1}"
    missing, _ = _both(js, ts_, _request_bytes(jdag, 999, 1, ts))
    assert missing.region_error == "region 999 not found"
    jb, tb = js.coprocessor_bytes(b"\x05\x00"), ts_.coprocessor_bytes(b"\x05\x00")
    assert tb == jb
    assert TW.decode_cop_response(tb).other_error.startswith("bad request")
    ts_.set_down(0)
    try:
        down = TW.decode_cop_response(ts_.coprocessor_bytes(_request_bytes(jdag, rid, epoch, ts)))
    finally:
        ts_.set_up(0)
    assert down.region_error.startswith("store_unavailable")


def test_a_repeat_hits_the_result_cache_and_a_write_misses_it():
    js, ts_, _ = _make_pair()
    (jdag, _), _ = _dags("q1")
    rid, epoch = _regions(js)[0]
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    req = _request_bytes(jdag, rid, epoch, ts, small_groups=16)
    first, _ = _both(js, ts_, req)
    hits = ts_.stats()["result_cache_hits"]
    jhit, thit = _both(js, ts_, req)
    assert ts_.stats()["result_cache_hits"] == hits + 1
    assert all(s.cache_hit and s.time_compile_ns == 0 for s in thit.exec_summaries)
    assert all(s.cache_hit and s.time_compile_ns == 0 for s in jhit.exec_summaries)
    # a row of this region changes: the next request decodes again
    wts = js.next_ts()
    assert wts == ts_.next_ts()
    _h, jrow = next(W.store_rows(JT, W.store_lineitem(N, N_ORDERS, seed=5), 0, 1))
    _h, trow = next(W.store_rows(TT, W.store_lineitem(N, N_ORDERS, seed=5), 0, 1))
    col_ids = [W.LINEITEM_COL_IDS[k] for k in W.LINEITEM_COLUMNS]
    js.put_row(TID, 7, col_ids, jrow, wts)
    ts_.put_row(TID, 7, col_ids, trow, wts)
    decodes = ts_.stats()["chunk_decodes"]
    ts2 = js.next_ts()
    assert ts2 == ts_.next_ts()
    after, tafter = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts2, small_groups=16))
    assert ts_.stats()["result_cache_hits"] == hits + 1
    assert ts_.stats()["chunk_decodes"] == decodes + 1
    assert JW.encode_chunk(after.chunk) != JW.encode_chunk(first.chunk)
    assert all(s.cache_hit for s in tafter.exec_summaries)  # the program cache still hits
    # a deleted row misses too, and its region answers one row fewer
    dts = js.next_ts()
    assert dts == ts_.next_ts()
    js.delete_row(TID, 9, dts)
    ts_.delete_row(TID, 9, dts)
    ts3 = js.next_ts()
    assert ts3 == ts_.next_ts()
    gone, _ = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts3, small_groups=16))
    assert ts_.stats()["result_cache_hits"] == hits + 1
    assert gone.exec_summaries[0].num_produced_rows == after.exec_summaries[0].num_produced_rows - 1


def _upper_dag(E, X, T):
    V1 = T.new_varchar(1)
    scan = E.TableScan(TID, (E.ColumnInfo(W.LINEITEM_COL_IDS["rflag"], V1), E.ColumnInfo(W.LINEITEM_COL_IDS["okey"], T.new_longlong())))
    proj = E.Projection((X.func("upper", T.new_varchar(4), X.col(0, V1)), X.col(1, T.new_longlong())))
    return E.DAGRequest((scan, proj), output_offsets=(0, 1))


def _group_concat_dag(E, X, T):
    V1 = T.new_varchar(1)
    scan = E.TableScan(TID, (E.ColumnInfo(W.LINEITEM_COL_IDS["rflag"], V1), E.ColumnInfo(W.LINEITEM_COL_IDS["lstat"], V1)))
    agg = E.Aggregation(group_by=(X.col(1, V1),), aggs=(X.AggDesc("group_concat", (X.col(0, V1),)),))
    return E.DAGRequest((scan, agg), output_offsets=(0, 1))


def _replace_dag(E, X, T):
    V1 = T.new_varchar(1)
    scan = E.TableScan(TID, (E.ColumnInfo(W.LINEITEM_COL_IDS["rflag"], V1), E.ColumnInfo(W.LINEITEM_COL_IDS["okey"], T.new_longlong())))
    proj = E.Projection((X.func("replace", T.new_varchar(4), X.col(0, V1), X.lit("N", V1), X.lit("no", T.new_varchar(2))),
                         X.col(1, T.new_longlong())))
    return E.DAGRequest((scan, proj), output_offsets=(0, 1))


def test_upper_runs_on_the_device_in_both(pair):
    js, ts_, t = pair
    jdag = _upper_dag(JE, JX, JT)
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    before = ts_.stats()["oracle_fallbacks"]
    for rid, epoch in _regions(js):
        jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts))
        assert tresp.other_error is None and tresp.chunk.num_rows() == 200
        # a program built (or taken from the cache) and run on each device
        assert [s.cache_hit for s in tresp.exec_summaries] == [s.cache_hit for s in jresp.exec_summaries]
        assert tresp.exec_summaries[0].cache_hit or tresp.exec_summaries[0].time_compile_ns > 0
    assert ts_.stats()["oracle_fallbacks"] == before + 0
    got = [bytes(tresp.chunk.columns[0].get_bytes(j)).decode() for j in range(200)]
    assert got == ["ANR"[c] for c in t["rflag"][400:]]


def test_replace_goes_to_the_oracle_in_both(pair):
    js, ts_, t = pair
    jdag = _replace_dag(JE, JX, JT)
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    before = ts_.stats()["oracle_fallbacks"]
    for rid, epoch in _regions(js):
        jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts))
        assert tresp.other_error is None and tresp.chunk.num_rows() == 200
        assert all(s.time_compile_ns == 0 for s in jresp.exec_summaries)  # the JAX oracle too
    assert ts_.stats()["oracle_fallbacks"] == before + 3
    got = [bytes(tresp.chunk.columns[0].get_bytes(j)).decode() for j in range(200)]
    assert got == [("A", "no", "R")[c] for c in t["rflag"][400:]]


def test_group_concat_goes_to_the_oracle_in_both(pair):
    js, ts_, _ = pair
    jdag = _group_concat_dag(JE, JX, JT)
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    before = ts_.stats()["oracle_fallbacks"]
    for rid, epoch in _regions(js):
        jresp, tresp = _both(js, ts_, _request_bytes(jdag, rid, epoch, ts))
        assert tresp.other_error is None and tresp.chunk.num_rows() == 2
        assert all(s.time_compile_ns == 0 for s in jresp.exec_summaries)  # the JAX oracle too
    assert ts_.stats()["oracle_fallbacks"] == before + 3


def test_a_follower_read_is_refused_and_a_follower_is_not_leader():
    """A plain read at a follower answers NotLeader with the leader as the
    hint; a replica read there is served while the follower's safe_ts
    covers the snapshot (equal to the leader's answer), and refused with
    DataIsNotReady once its apply loop lags behind a newer write."""
    from tidb_tpu_torch.codec import encode_row_key
    from tidb_tpu_torch.store import DataIsNotReady, parse_region_error
    from tidb_tpu_torch.types import Datum
    from tidb_tpu_torch.util import failpoint

    ts_ = TStore(device="cpu")
    ts_.cluster.set_stores(3)
    (_, tdag), _ = _dags("q6")
    r = ts_.cluster.regions()[0]
    leader = ts_.cluster.leader_of(r.region_id)
    follower = ts_.cluster.followers_of(r.region_id)[0]
    base = dict(dag=tdag, ranges=[TRange(*FULL)], start_ts=ts_.next_ts(), region_id=r.region_id, region_epoch=r.epoch)
    nl = ts_.coprocessor(TReq(peer_store=follower, **base))
    assert nl.region_error.startswith("not_leader") and f"leader_store={leader}" in nl.region_error
    rr = ts_.coprocessor(TReq(peer_store=follower, replica_read=True, **base))
    ok = ts_.coprocessor(TReq(peer_store=leader, **base))
    assert ok.other_error is None and ok.region_error is None
    assert rr.other_error is None and rr.region_error is None and rr.chunk.rows() == ok.chunk.rows()
    with failpoint.enabled("replica/apply-lag", {follower}):
        ts_.put_row(7, 1, [1], [Datum.i64(1)], ts=ts_.next_ts())
        assert ts_.cluster.locate(encode_row_key(7, 1)).region_id == r.region_id
        late = dict(base, start_ts=ts_.next_ts())
        refused = ts_.coprocessor(TReq(peer_store=follower, replica_read=True, **late))
        err = parse_region_error(refused.region_error)
        assert isinstance(err, DataIsNotReady) and err.store_id == follower


def test_the_default_device_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TStore()
