"""The port's wire codec (codec/wire.py) against the JAX package's.

Every workload DAG, chunks of every column class (NULLs, decimals, times,
strings, JSON), a cop request with aux chunks and paging, and a cop
response with summaries and a resume cursor: the two codecs must write the
same bytes, and each must decode the other's bytes back to what re-encodes
to them. The batch frames (several requests sharing one build side, and
their responses) round-trip too, the shared build side decoding to one
object. Tolerance: exact everywhere (byte equality).
"""

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.codec import wire as JW
from tidb_tpu.store import store as JS

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.codec import wire as TW
from tidb_tpu_torch.store import store as TS


def _workload_dags(E, X, T):
    out = {
        "scalar_agg": W.scalar_agg_dag(E, X, T)[0],
        "q6": W.q6_dag(E, X, T)[0],
        "q1": W.q1_dag(E, X, T)[0],
        "topn": W.topn_dag(E, X, T)[0],
        "sort": W.sort_dag(E, X, T)[0],
        "q3": W.q3_dag(E, X, T)[0],
        "join": W.join_bench_dag(E, X, T)[0],
        "join_grouped": W.join_bench_dag(E, X, T, groups=700)[0],
        "store_selection": W.store_selection_dag(E, X, T),
    }
    for name, (dag, _fts) in W.store_dags(E, X, T).items():
        if name != "window":
            out["store_" + name] = dag
    return out


DAG_NAMES = sorted(_workload_dags(TE, TX, TT))


@pytest.mark.parametrize("name", DAG_NAMES)
def test_dag_bytes_match_and_cross_decode(name):
    jdag, tdag = _workload_dags(JE, JX, JT)[name], _workload_dags(TE, TX, TT)[name]
    tb = TW.encode_dag(tdag)
    assert tb == JW.encode_dag(jdag)
    assert TW.decode_dag(tb).fingerprint() == tdag.fingerprint()
    assert TW.encode_dag(TW.decode_dag(tb)) == tb
    assert JW.encode_dag(JW.decode_dag(tb)) == tb


def test_window_has_no_frame_in_either_codec():
    with pytest.raises(NotImplementedError, match="Window"):
        TW.encode_dag(W.window_dag(TE, TX, TT)[0])
    with pytest.raises(NotImplementedError, match="Window"):
        JW.encode_dag(W.window_dag(JE, JX, JT)[0])


def _chunk(C, T, seed: int, n: int = 50):
    """A chunk of every column class, NULLs among the rows."""
    from_json = __import__(T.__name__ + ".json_binary", fromlist=["encode"])
    rng = np.random.default_rng(seed)
    D = T.Datum
    fts = [T.new_longlong(), T.new_longlong(unsigned=True), T.new_double(), T.new_decimal(15, 2),
           T.new_datetime(), T.new_varchar(8), T.new_json()]
    rows = []
    for i in range(n):
        row = [D.i64(int(rng.integers(-(1 << 40), 1 << 40))), D.u64(int(rng.integers(0, 1 << 63, dtype=np.uint64))),
               D.f64(float(rng.standard_normal())), D.dec(T.MyDecimal.from_scaled_int(int(rng.integers(-10**9, 10**9)), 2)),
               D.time(T.MyTime.parse(f"199{i % 10}-0{1 + i % 9}-1{i % 10} 0{i % 10}:1{i % 6}:00", 0)),
               D.string("abcdefgh"[: i % 9]), D.json(from_json.encode([i, {"a": str(i)}]))]
        rows.append([D.NULL if rng.random() < 0.2 else d for d in row])
    return C.Chunk.from_rows(fts, rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_bytes_match_and_cross_decode(seed):
    tb = TW.encode_chunk(_chunk(TC, TT, seed))
    assert tb == JW.encode_chunk(_chunk(JC, JT, seed))
    assert TW.encode_chunk(TW.decode_chunk(tb)) == tb
    assert JW.encode_chunk(JW.decode_chunk(tb)) == tb
    # the workloads' numpy-made chunks too (Q3's build sides)
    cols = W.q3_columns(512)
    for c, jf, tf in zip(cols, W.q3_dag(JE, JX, JT)[1], W.q3_dag(TE, TX, TT)[1]):
        assert TW.encode_chunk(W.make_chunk(TC, tf, c)) == JW.encode_chunk(W.make_chunk(JC, jf, c))


def _request(S, E, X, T, C, aux, paging=None):
    dag = W.store_dags(E, X, T)["q3"][0]
    return S.CopRequest(dag=dag, ranges=[S.KeyRange(b"t\x80", b"t\x81"), S.KeyRange(b"u", b"v")], start_ts=123,
                        region_id=4, region_epoch=3, aux_chunks=aux, paging_size=paging, small_groups=16,
                        peer_store=2, replica_read=True, mesh=True, mesh_min_rows=1 << 40)


@pytest.mark.parametrize("paging", [None, 8192])
def test_cop_request_bytes_match_and_cross_decode(paging):
    cols = W.store_q3_build_columns(64, 16)
    (_, jfts), (_, tfts) = W.store_dags(JE, JX, JT)["q3"], W.store_dags(TE, TX, TT)["q3"]
    jaux = [W.make_chunk(JC, f, c) for c, f in zip(cols, jfts)]
    taux = [W.make_chunk(TC, f, c) for c, f in zip(cols, tfts)]
    tb = TW.encode_cop_request(_request(TS, TE, TX, TT, TC, taux, paging))
    assert tb == JW.encode_cop_request(_request(JS, JE, JX, JT, JC, jaux, paging))
    back = TW.decode_cop_request(tb)
    assert isinstance(back, TS.CopRequest) and back.paging_size == paging and back.mesh_min_rows == 1 << 40
    assert TW.encode_cop_request(back) == tb
    assert JW.encode_cop_request(JW.decode_cop_request(tb)) == tb


def _response(S, C, T, chunk):
    sums = [S.ExecSummary(11, 7, 1, 5, False, 99, 0, 0, 0), S.ExecSummary(13, 3, 1, 0, True, 0, 64, 8192, 5)]
    return S.CopResponse(chunk=chunk, exec_summaries=sums, last_range=[S.KeyRange(b"t\x80k", b"t\x81")])


def test_cop_response_bytes_match_and_cross_decode():
    tb = TW.encode_cop_response(_response(TS, TC, TT, _chunk(TC, TT, 3)))
    assert tb == JW.encode_cop_response(_response(JS, JC, JT, _chunk(JC, JT, 3)))
    back = TW.decode_cop_response(tb)
    assert isinstance(back, TS.CopResponse) and back.exec_summaries[1].radix_escapes == 5
    assert TW.encode_cop_response(back) == tb
    assert JW.encode_cop_response(JW.decode_cop_response(tb)) == tb
    for err in (TS.CopResponse(region_error="epoch_not_match: have 3, got 2"), TS.CopResponse(other_error="bad request: x")):
        eb = TW.encode_cop_response(err)
        assert JW.encode_cop_response(JW.decode_cop_response(eb)) == eb


def test_batch_frames_round_trip_and_share_the_build_side():
    cols = W.store_join_build_columns(64)
    tf = W.store_dags(TE, TX, TT)["join"][1]
    jf = W.store_dags(JE, JX, JT)["join"][1]
    taux = [W.make_chunk(TC, f, c) for c, f in zip(cols, tf)]
    jaux = [W.make_chunk(JC, f, c) for c, f in zip(cols, jf)]
    treqs = [TS.CopRequest(W.store_dags(TE, TX, TT)["join"][0], [TS.KeyRange(b"a", b"b")], 5, region_id=r,
                           region_epoch=2, aux_chunks=taux) for r in (2, 3, 4)]
    jreqs = [JS.CopRequest(W.store_dags(JE, JX, JT)["join"][0], [JS.KeyRange(b"a", b"b")], 5, region_id=r,
                           region_epoch=2, aux_chunks=jaux) for r in (2, 3, 4)]
    tb = TW.encode_batch_cop_request(treqs)
    assert tb == JW.encode_batch_cop_request(jreqs)
    back = TW.decode_batch_cop_request(tb)
    assert [r.region_id for r in back] == [2, 3, 4]
    assert back[0].aux_chunks[0] is back[2].aux_chunks[0]  # one decoded build side
    assert TW.encode_batch_cop_request(back) == tb
    resps = [_response(TS, TC, TT, _chunk(TC, TT, s)) for s in (4, 5)] + [TS.CopResponse(region_error="region 9 not found")]
    rb = TW.encode_batch_cop_response(resps)
    assert TW.encode_batch_cop_response(TW.decode_batch_cop_response(rb)) == rb
    assert JW.encode_batch_cop_response(JW.decode_batch_cop_response(rb)) == rb
