"""The root's planning half in the port (tidb_tpu_torch distsql/root.py)
and two-phase statements over the port store, against the JAX package on
the CPU.

  * split_dag gives the same push and root plans in both packages
    (fingerprints and wire bytes) over every workloads.store_dags DAG, the
    statements of workloads.store_statements (BIT_*, DISTINCT at the
    root, a Final merge of ~ a group a row) and the group_concat,
    host-only, HAVING, Limit, Sort and Window shapes; _partial2_dag too;
  * one two-phase statement per shape of chip_smoke.py's phase 8 over a
    JAX TPUStore and a port TPUStore(device="cpu") of 600 rows in five
    regions: the push half as one batch frame answers the same bytes
    (clock fields zeroed), and the root half — run_dag_on_chunks over the
    concatenated answers, as the JAX package's _execute_root runs it —
    gives the same rows, equal to the Complete DAG's oracle rows; the
    Final merge forced to spill gives the unspilled rows with
    SPILL_PARTITIONS + 1 in both.
Tolerance: exact (integer and decimal data).
"""

import warnings

import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.codec as JCodec
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.codec import wire as JW
from tidb_tpu.distsql import root as JR
from tidb_tpu.exec.executor import run_dag_on_chunks as j_run
from tidb_tpu.exec.executor import run_dag_reference as j_oracle
from tidb_tpu.store import CopRequest as JReq
from tidb_tpu.store import KeyRange as JRange
from tidb_tpu.store import TPUStore as JStore
from tidb_tpu.util import metrics as JM

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.codec import wire as TW
from tidb_tpu_torch.distsql import root as TR
from tidb_tpu_torch.exec.executor import run_dag_on_chunks as t_run
from tidb_tpu_torch.store import TPUStore as TStore
from tidb_tpu_torch.util import metrics as TM


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


# ---------------------------------------------------------------------------
# split_dag and _partial2_dag
# ---------------------------------------------------------------------------

def _extra_shapes(E, X, T):
    """Shapes beyond the workloads: group_concat at the root, a host-only
    op before the merge point, HAVING after a merge, Limit, and a
    Projection before a TopN."""
    LL, V = T.new_longlong(), T.new_varchar(16)
    BOOL = T.new_longlong(notnull=True)
    scan = E.TableScan(3, (E.ColumnInfo(1, LL), E.ColumnInfo(2, V), E.ColumnInfo(3, LL)))
    a, s, b = X.col(0, LL), X.col(1, V), X.col(2, LL)
    A = X.AggDesc
    gc = E.Aggregation(group_by=(a,), aggs=(A("group_concat", (s,)), A("count", ())))
    agg = E.Aggregation(group_by=(a, b), aggs=(A("sum", (b,)), A("max", (s,)), A("first_row", (s,))))
    having = E.Selection((X.func("gt", BOOL, X.col(0, agg.aggs[0].ft), X.lit(3, LL)),))
    replace = X.func("replace", V, s, X.lit("a", V), X.lit("b", V))
    return {
        "group_concat": E.DAGRequest((scan, gc), output_offsets=(0, 1, 2)),
        "host_only": E.DAGRequest((scan, E.Selection((X.func("gt", BOOL, a, X.lit(1, LL)),)),
                                   E.Projection((replace, a))), output_offsets=(0, 1)),
        "host_only_agg": E.DAGRequest((scan, E.Aggregation(group_by=(replace,), aggs=(A("count", ()),))),
                                      output_offsets=(0, 1)),
        "having": E.DAGRequest((scan, agg, having), output_offsets=(0, 1, 2, 3, 4)),
        "limit": E.DAGRequest((scan, E.Selection((X.func("gt", BOOL, b, X.lit(0, LL)),)), E.Limit(7)),
                              output_offsets=(0, 2)),
        "proj_topn": E.DAGRequest((scan, E.Projection((b, a)), E.TopN(order_by=((X.col(0, LL), True),), limit=5)),
                                  output_offsets=(1, 0)),
    }


def _all_dags(E, X, T):
    out = {f"store_{k}": v[0] for k, v in W.store_dags(E, X, T).items()}
    out.update({f"statement_{k}": v for k, v in W.store_statements(E, X, T).items()})
    out.update(_extra_shapes(E, X, T))
    return out


DAG_NAMES = sorted(_all_dags(TE, TX, TT))


@pytest.mark.parametrize("name", DAG_NAMES)
def test_split_dag_plans_as_the_jax_package(name):
    jdag, tdag = _all_dags(JE, JX, JT)[name], _all_dags(TE, TX, TT)[name]
    jp, tp = JR.split_dag(jdag), TR.split_dag(tdag)
    assert tp.push_dag.fingerprint() == jp.push_dag.fingerprint()
    assert TW.encode_dag(tp.push_dag) == JW.encode_dag(jp.push_dag)
    assert (tp.root_dag is None) == (jp.root_dag is None)
    if tp.root_dag is not None:
        assert tp.root_dag.fingerprint() == jp.root_dag.fingerprint()
        assert [f.fingerprint() if hasattr(f, "fingerprint") else repr(f) for f in tp.root_dag.output_fts()] == \
            [f.fingerprint() if hasattr(f, "fingerprint") else repr(f) for f in jp.root_dag.output_fts()]
    jp2, tp2 = JR._partial2_dag(jp), TR._partial2_dag(tp)
    assert (tp2 is None) == (jp2 is None)
    if tp2 is not None:
        assert tp2.fingerprint() == jp2.fingerprint()


def test_split_dag_keeps_what_the_device_cannot_merge_at_the_root():
    dags = _all_dags(TE, TX, TT)
    root_only = {"statement_distinct", "statement_distinct_scalar", "group_concat", "store_sort", "store_window"}
    for name in root_only:
        plan = TR.split_dag(dags[name])
        assert [type(e).__name__ for e in plan.push_dag.executors] == ["TableScan"], name
    plan = TR.split_dag(dags["statement_okey"])
    merge = plan.root_dag.executors[1]
    assert plan.push_dag.executors[1].partial and merge.merge
    assert all(d.mode == TX.AggMode.Final for d in merge.aggs)
    assert TR.split_dag(dags["store_q3"]).root_dag is not None  # the join pushes, the merge stays
    assert TR.split_dag(dags["host_only"]).push_dag.executors[-1].__class__.__name__ == "Selection"


# ---------------------------------------------------------------------------
# two-phase statements over both stores
# ---------------------------------------------------------------------------

SN, SPLITS, N_ORDERS = 600, (150, 300, 400, 500), 96
FULL = (b"", b"\xff" * 16)


@pytest.fixture(scope="module")
def pair():
    t = W.store_lineitem(SN, N_ORDERS, seed=5)
    js, ts_ = JStore(), TStore(device="cpu")
    jts, tts = js.next_ts(), ts_.next_ts()
    assert jts == tts
    js.txn.bulk_ingest(W.store_items(JCodec, W.store_rows(JT, t)), jts)
    ts_.bulk_ingest(W.store_items(TCodec, W.store_rows(TT, t)), tts)
    for h in SPLITS:
        js.cluster.split(JCodec.encode_row_key(W.LINEITEM_TABLE_ID, h))
        ts_.cluster.split(TCodec.encode_row_key(W.LINEITEM_TABLE_ID, h))
    return js, ts_


def _canon_frame(b: bytes) -> bytes:
    resps = JW.decode_batch_cop_response(b)
    for r in resps:
        for s in r.exec_summaries:
            s.time_processed_ns = 0
            s.time_compile_ns = 0
    return JW.encode_batch_cop_response(resps)


def _push(pair, name):
    """The push half of statement `name` as one batch frame over every
    region of both stores: (port answers, JAX answers, both plans)."""
    js, ts_ = pair
    js.evict_caches()  # no result-cache hit: every region runs its push half
    ts_.evict_caches()
    jplan = JR.split_dag(W.store_statements(JE, JX, JT)[name])
    tplan = TR.split_dag(W.store_statements(TE, TX, TT)[name])
    ts = js.next_ts()
    assert ts == ts_.next_ts()
    reqs = [JReq(dag=jplan.push_dag, ranges=[JRange(*FULL)], start_ts=ts, region_id=r.region_id,
                 region_epoch=r.epoch, small_groups=16 if name == "q1" else None) for r in js.cluster.regions()]
    frame = JW.encode_batch_cop_request(reqs)
    jb = js.batch_coprocessor_bytes(frame)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        tb = ts_.batch_coprocessor_bytes(frame)
    assert not [str(w.message) for w in ws if "batching rule" in str(w.message)]  # no lane-by-lane op
    assert _canon_frame(tb) == _canon_frame(jb)
    tresps = TW.decode_batch_cop_response(tb)
    jresps = JW.decode_batch_cop_response(jb)
    for r in tresps:
        assert r.other_error is None and r.region_error is None
        assert r.batched in (1, 2)  # every region served by a bucket's program
    assert ts_.stats()["oracle_fallbacks"] == 0 and ts_.stats()["batch_fallbacks"] == 0
    return [r.chunk for r in tresps], [r.chunk for r in jresps], tplan, jplan


@pytest.mark.parametrize("name", ["q1", "q6", "bit", "distinct", "distinct_scalar", "okey"])
def test_two_phase_statement_equals_the_jax_store(pair, name):
    tparts, jparts, tplan, jplan = _push(pair, name)
    assert tplan.root_dag is not None
    tin, jin = TC.Chunk.concat(tparts), JC.Chunk.concat(jparts)
    got = t_run(tplan.root_dag, [tin], device="cpu", oracle_fallback=False)
    want = j_run(jplan.root_dag, [jin], oracle_fallback=False)
    assert canon(got.rows()) == canon(want.rows())
    dag = W.store_statements(JE, JX, JT)[name]
    cols = dag.scan().columns
    rows = W.store_rows(JT, W.store_lineitem(SN, N_ORDERS, seed=5))
    whole = JC.Chunk.from_rows([c.ft for c in cols], [[row[c.col_id - 1] for c in cols] for _h, row in rows])
    oracle = j_oracle(dag, [whole])
    assert sorted(canon(got.rows())) == sorted(canon(oracle))


def test_forced_spill_of_the_final_merge(pair):
    """The GROUP BY l_orderkey merge (~96 groups) at group capacity 64
    with no retry: one level of four key-hash parts in both packages, the
    unspilled rows."""
    tparts, jparts, tplan, jplan = _push(pair, "okey")
    tin, jin = TC.Chunk.concat(tparts), JC.Chunk.concat(jparts)
    plain = t_run(tplan.root_dag, [tin], device="cpu", oracle_fallback=False)
    t0, j0 = TM.SPILL_PARTITIONS.value, JM.SPILL_PARTITIONS.value
    got = t_run(tplan.root_dag, [tin], device="cpu", group_capacity=64, max_retries=0, oracle_fallback=False)
    want = j_run(jplan.root_dag, [jin], group_capacity=64, max_retries=0, oracle_fallback=False)
    assert TM.SPILL_PARTITIONS.value - t0 == JM.SPILL_PARTITIONS.value - j0 == 1
    assert canon(got.rows()) == canon(want.rows())
    assert sorted(canon(got.rows())) == sorted(canon(plain.rows()))
    assert len(got.rows()) > 64
