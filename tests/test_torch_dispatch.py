"""The port's region dispatch loop (tidb_tpu_torch/distsql/dispatch.py)
against the JAX package's, on the CPU.

A JAX TPUStore and a port TPUStore(device="cpu") get the same rows and the
same splits, and every case runs through both packages' `select` (or their
stores' endpoints) with the same request:

  * the five cases of tests/test_store_distsql.py (multi-region scan,
    Partial1 per region then a Final merge at the root, a pushed
    Selection, a split after the tasks were built, MVCC snapshots);
  * the dispatch cases of tests/test_paging.py (the paging loop over three
    regions, a two-range paged scan);
  * the dispatch cases of tests/test_batch_cop.py: one batch per store for
    17 regions, two capacity buckets, an epoch mismatch that retries only
    its region, paging kept out of batching, exec summaries in task order
    under a pool, and the wire route (single and batch tiers);
  * a split made by the `distsql.before_task` failpoint on its first
    evaluation, in the single, pool and batch tiers: the stale task answers
    epoch_not_match, is re-split and retried, and REGION_ERRORS
    {kind="epoch_not_match"} rises by one in each package;
  * `select` in the single, pool and batch tiers with mesh=False;
  * the retry ladder both packages share: all stores down with
    backoff_weight=0 raises RegionUnavailableError; a not_leader answer
    with a hint switches peers once; a follower read ends in
    CopInternalError in the port (its store answers other_error);
  * the kernels' launch counters stay exact from four threads.

Rows are compared exactly, chunk by chunk in task order, and the exec
summaries with their two clock fields zeroed. In the pool tier which
region's task builds a program depends on thread timing, so there
`cache_hit` is compared as a count. Tolerance: exact (integer and decimal
data).
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.codec as JCodec
import tidb_tpu.distsql as JD
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.distsql import dispatch as j_dispatch
from tidb_tpu.exec.executor import run_dag_on_chunk as j_run_one
from tidb_tpu.exec.executor import run_dag_reference as j_oracle
from tidb_tpu.store import CopRequest as JReq
from tidb_tpu.store import TPUStore as JStore
from tidb_tpu.util import failpoint as j_failpoint
from tidb_tpu.util import metrics as j_metrics

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.distsql as TD
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.distsql import dispatch as t_dispatch
from tidb_tpu_torch.exec.executor import run_dag_on_chunk as t_run_one
from tidb_tpu_torch.store import CopRequest as TReq
from tidb_tpu_torch.store import TPUStore as TStore
from tidb_tpu_torch.util import failpoint as t_failpoint
from tidb_tpu_torch.util import metrics as t_metrics

J = SimpleNamespace(name="jax", T=JT, E=JE, X=JX, C=JC, Codec=JCodec, D=JD, dispatch=j_dispatch, Req=JReq,
                    store=lambda: JStore(), run_one=lambda dag, ch: j_run_one(dag, ch), metrics=j_metrics,
                    failpoint=j_failpoint)
P = SimpleNamespace(name="torch", T=TT, E=TE, X=TX, C=TC, Codec=TCodec, D=TD, dispatch=t_dispatch, Req=TReq,
                    store=lambda: TStore(device="cpu"), run_one=lambda dag, ch: t_run_one(dag, ch, device="cpu"),
                    metrics=t_metrics, failpoint=t_failpoint)


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def canon_rows(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def chunk_rows(ch):
    return canon_rows(ch.rows()) if ch is not None else None


def summaries(res, pool=False):
    """The per-task summary lists with the clock fields dropped (and, in
    the pool tier, cache_hit: see the module docstring)."""
    def one(s):
        t = (s.num_produced_rows, s.num_iterations, s.num_bytes, s.radix_partitions, s.radix_rung,
             s.radix_escapes)
        return t if pool else t + (s.cache_hit,)
    return [[one(s) for s in task] for task in res.exec_summaries]


def hits(res):
    return sum(s.cache_hit for task in res.exec_summaries for s in task)


def same_select(jres, tres, pool=False):
    """Two SelectResults equal: chunk by chunk, summaries, batch stats."""
    assert [chunk_rows(c) for c in tres.chunks] == [chunk_rows(c) for c in jres.chunks]
    assert summaries(tres, pool) == summaries(jres, pool)
    if pool:
        assert hits(tres) == hits(jres)
    assert tres.batch_stats == jres.batch_stats
    return [r for c in tres.chunks for r in chunk_rows(c)]


def both(case):
    """Run `case(pkg)` with each package's namespace; return (jax, torch)."""
    return case(J), case(P)


# ---------------------------------------------------------------------------
# tests/test_store_distsql.py
# ---------------------------------------------------------------------------

SD_TID = 44


def sd_fts(T):
    return [T.new_longlong(), T.new_decimal(10, 2), T.new_varchar(6)]


def sd_values(n, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 9)), f"{int(rng.integers(-10000, 10000)) / 100:.2f}",
             ["red", "green", "blue"][int(rng.integers(3))]) for _ in range(n)]


def sd_fill(pkg, n=300, regions=4, seed=2):
    T = pkg.T
    store = pkg.store()
    rows = []
    for h, (a, d, s) in enumerate(sd_values(n, seed)):
        row = [T.Datum.i64(a), T.Datum.dec(T.MyDecimal(d)), T.Datum.string(s)]
        rows.append(row)
        store.put_row(SD_TID, h, [1, 2, 3], row, ts=10)
    for i in range(1, regions):
        store.cluster.split(pkg.Codec.encode_row_key(SD_TID, i * n // regions))
    return store, rows


def sd_scan(pkg):
    return pkg.E.TableScan(SD_TID, tuple(pkg.E.ColumnInfo(cid, ft) for cid, ft in zip((1, 2, 3), sd_fts(pkg.T))))


def test_multi_region_scan_concat():
    def case(pkg):
        store, rows = sd_fill(pkg)
        dag = pkg.E.DAGRequest((sd_scan(pkg),), output_offsets=(0, 1, 2))
        res = pkg.D.select(store, pkg.D.KVRequest(dag, pkg.D.full_table_ranges(SD_TID), start_ts=100))
        assert len(res.chunks) == 4  # one per region
        assert sorted(canon_rows(res.merged().rows())) == sorted(canon_rows(rows))
        return res

    got = same_select(*both(case), pool=True)
    assert len(got) == 300


def test_partial_agg_per_region_then_merge():
    """Partial1 on each region (mesh=False: a chunk per region in both
    packages), the Final merge at the root over the stacked partials."""
    def case(pkg):
        E, X, T = pkg.E, pkg.X, pkg.T
        store, rows = sd_fill(pkg, n=200, regions=4)
        fts = sd_fts(T)
        g, d = X.col(0, fts[0]), X.col(1, fts[1])
        partial = E.Aggregation(group_by=(g,), aggs=(X.AggDesc("avg", (d,)), X.AggDesc("count", ())), partial=True)
        dag = E.DAGRequest((sd_scan(pkg), partial), output_offsets=tuple(range(4)))
        res = pkg.D.select(store, pkg.D.KVRequest(dag, pkg.D.full_table_ranges(SD_TID), start_ts=100, mesh=False))
        stacked = res.merged()
        pfts = stacked.field_types()
        merge_agg = E.Aggregation(
            group_by=(X.col(3, pfts[3]),),
            aggs=(X.AggDesc("avg", (X.col(0, pfts[0]), X.col(1, pfts[1])), mode=X.AggMode.Final),
                  X.AggDesc("count", (X.col(2, pfts[2]),), mode=X.AggMode.Final)),
            merge=True,
        )
        root = E.DAGRequest((E.TableScan(0, tuple(E.ColumnInfo(i, ft) for i, ft in enumerate(pfts))), merge_agg),
                            output_offsets=(0, 1, 2))
        final = pkg.run_one(root, stacked)
        return res, sorted(canon_rows(final.rows())), rows

    (jres, jfinal, rows), (tres, tfinal, _) = both(case)
    same_select(jres, tres, pool=True)
    assert tfinal == jfinal
    # the single-shot oracle over all rows
    fts = sd_fts(JT)
    agg = JE.Aggregation(group_by=(JX.col(0, fts[0]),),
                         aggs=(JX.AggDesc("avg", (JX.col(1, fts[1]),)), JX.AggDesc("count", ())))
    scan = JE.TableScan(SD_TID, tuple(JE.ColumnInfo(c, ft) for c, ft in zip((1, 2, 3), fts)))
    want = j_oracle(JE.DAGRequest((scan, agg), output_offsets=(0, 1, 2)), JC.Chunk.from_rows(fts, rows))
    assert tfinal == sorted(canon_rows(want))


def test_selection_pushdown_multi_region():
    def case(pkg):
        E, X, T = pkg.E, pkg.X, pkg.T
        store, rows = sd_fill(pkg, n=150, regions=3)
        pred = X.func("gt", T.new_longlong(notnull=True), X.col(1, sd_fts(T)[1]), X.lit("0.00", T.new_decimal(3, 2)))
        dag = E.DAGRequest((sd_scan(pkg), E.Selection((pred,))), output_offsets=(0, 1))
        res = pkg.D.select(store, pkg.D.KVRequest(dag, pkg.D.full_table_ranges(SD_TID), start_ts=100))
        want = [r for r in rows if not r[1].is_null() and r[1].val > T.MyDecimal("0")]
        assert res.merged().num_rows() == len(want)
        return res

    assert len(same_select(*both(case), pool=True)) > 0


def test_region_split_retry():
    """A split after the tasks are built: the stale task answers
    epoch_not_match, and select over the fresh view returns every row."""
    def case(pkg):
        store, _rows = sd_fill(pkg, n=100, regions=2)
        dag = pkg.E.DAGRequest((sd_scan(pkg),), output_offsets=(0,))
        ranges = pkg.D.full_table_ranges(SD_TID)
        tasks = pkg.dispatch._build_tasks(store, ranges)
        store.cluster.split(pkg.Codec.encode_row_key(SD_TID, 25))
        stale = tasks[0]
        resp = store.coprocessor(pkg.Req(dag, stale.ranges, 100, stale.region_id, stale.epoch))
        assert resp.region_error is not None and "epoch_not_match" in resp.region_error
        res = pkg.D.select(store, pkg.D.KVRequest(dag, ranges, start_ts=100))
        assert res.merged().num_rows() == 100
        return resp.region_error, res

    (jerr, jres), (terr, tres) = both(case)
    assert terr == jerr
    same_select(jres, tres, pool=True)


def test_mvcc_snapshot_read():
    def case(pkg):
        T = pkg.T
        store, _ = sd_fill(pkg, n=20, regions=1)
        store.put_row(SD_TID, 0, [1, 2, 3], [T.Datum.i64(777), T.Datum.dec("1.00"), T.Datum.string("red")], ts=50)
        dag = pkg.E.DAGRequest((sd_scan(pkg),), output_offsets=(0,))

        def at(ts):
            return pkg.D.select(store, pkg.D.KVRequest(dag, pkg.D.full_table_ranges(SD_TID), start_ts=ts)).merged()

        old, new = sorted(r[0].val for r in at(20).rows()), sorted(r[0].val for r in at(60).rows())
        assert 777 not in old and 777 in new
        store.delete_row(SD_TID, 1, ts=70)
        counts = (at(60).num_rows(), at(80).num_rows())
        assert counts == (20, 19)
        return old, new, counts

    jout, tout = both(case)
    assert tout == jout


# ---------------------------------------------------------------------------
# tests/test_paging.py
# ---------------------------------------------------------------------------

PG_TID = 21


def pg_fill(pkg, n=90, regions=1):
    store = pkg.store()
    for h in range(n):
        store.put_row(PG_TID, h, [1], [pkg.T.Datum.i64(h)], ts=5)
    for i in range(1, regions):
        store.cluster.split(pkg.Codec.encode_row_key(PG_TID, i * n // regions))
    return store


def pg_dag(pkg):
    return pkg.E.DAGRequest((pkg.E.TableScan(PG_TID, (pkg.E.ColumnInfo(1, pkg.T.new_longlong()),)),),
                            output_offsets=(0,))


def test_dispatch_paging_loop_multi_region():
    def case(pkg):
        store = pg_fill(pkg, 120, regions=3)
        ranges = pkg.D.full_table_ranges(PG_TID)
        paged = pkg.D.select(store, pkg.D.KVRequest(pg_dag(pkg), ranges, start_ts=100, paging_size=17))
        plain = pkg.D.select(store, pkg.D.KVRequest(pg_dag(pkg), ranges, start_ts=100))
        assert len(paged.chunks) > len(plain.chunks)
        got = sorted(r[0].val for c in paged.chunks for r in c.rows())
        assert got == sorted(r[0].val for c in plain.chunks for r in c.rows()) == list(range(120))
        return paged

    both_paged = both(case)
    same_select(*both_paged, pool=True)
    assert len(both_paged[1].chunks) == 9  # three regions of 40 rows in pages of 17


def test_paging_multi_range():
    def case(pkg):
        store = pg_fill(pkg, 60)
        region = store.cluster.regions_in_range(b"", b"\xff" * 20)[0]
        ranges = pkg.D.handle_ranges(PG_TID, [(5, 14), (30, 44)])
        got, pages = [], 0
        while True:
            resp = store.coprocessor(pkg.Req(pg_dag(pkg), ranges, 100, region.region_id, region.epoch, paging_size=7))
            assert resp.other_error is None
            got += [r[0].val for r in resp.chunk.rows()]
            pages += 1
            if resp.last_range is None:
                break
            ranges = resp.last_range
        assert got == list(range(5, 15)) + list(range(30, 45))
        # and through select's paging loop
        res = pkg.D.select(store, pkg.D.KVRequest(pg_dag(pkg), pkg.D.handle_ranges(PG_TID, [(5, 14), (30, 44)]),
                                                  start_ts=100, paging_size=7))
        assert [r[0].val for c in res.chunks for r in c.rows()] == got
        return got, pages, res

    (jgot, jpages, jres), (tgot, tpages, tres) = both(case)
    assert (tgot, tpages) == (jgot, jpages)
    same_select(jres, tres)


# ---------------------------------------------------------------------------
# tests/test_batch_cop.py, dispatch level
# ---------------------------------------------------------------------------

BC_TID = 91


def bc_fill(pkg, n=340, regions=17, bounds=None):
    """n rows of (v = 3*handle) split into regions, one store."""
    store = pkg.store()
    for h in range(n):
        store.put_row(BC_TID, h, [1], [pkg.T.Datum.i64(h * 3)], ts=10)
    for b in (bounds if bounds is not None else [i * n // regions for i in range(1, regions)]):
        store.cluster.split(pkg.Codec.encode_row_key(BC_TID, b))
    return store


def bc_scan_dag(pkg):
    return pkg.E.DAGRequest((pkg.E.TableScan(BC_TID, (pkg.E.ColumnInfo(1, pkg.T.new_longlong()),)),),
                            output_offsets=(0,))


def bc_agg_dag(pkg):
    E, X, T = pkg.E, pkg.X, pkg.T
    ft = T.new_longlong()
    scan = E.TableScan(BC_TID, (E.ColumnInfo(1, ft),))
    sel = E.Selection((X.func("lt", T.new_longlong(notnull=True), X.col(0, ft), X.lit(300, T.new_longlong())),))
    agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("count", ()),), partial=True)
    return E.DAGRequest((scan, sel, agg), output_offsets=(0,))


def bc_req(pkg, dag, ts=100, **kw):
    return pkg.D.KVRequest(dag, pkg.D.full_table_ranges(BC_TID), start_ts=ts, **kw)


def all_vals(res):
    return sorted(r[0].val for r in res.merged().rows())


def test_one_batch_per_store_for_17_regions():
    def case(pkg):
        store = bc_fill(pkg)
        res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), batch_cop=True))
        assert res.batch_stats == {"batches": 1, "regions": 17, "launches_saved": 16,
                                   "mesh_batches": 0, "mesh_lanes": 0}
        assert all_vals(res) == [h * 3 for h in range(340)]
        assert len(res.exec_summaries) == 17  # still one summary list per region
        return res, store

    (jres, _), (tres, tstore) = both(case)
    same_select(jres, tres)
    st = tstore.stats()
    assert (st["batch_batches"], st["batch_regions"], st["batch_fallbacks"]) == (1, 17, 0)


def test_capacity_buckets_split_skewed_regions():
    def case(pkg):
        store = bc_fill(pkg, n=200, bounds=(20, 40, 60, 80, 120, 160))
        res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), batch_cop=True))
        assert res.batch_stats == {"batches": 2, "regions": 7, "launches_saved": 5,
                                   "mesh_batches": 0, "mesh_lanes": 0}
        assert all_vals(res) == [h * 3 for h in range(200)]
        return res

    same_select(*both(case))


def test_epoch_mismatch_one_region_retries_only_that_region():
    """A split lands between task build and dispatch: the stale region
    falls out of the batch into the single-task retry path; every other
    region's batched result stands."""
    def case(pkg):
        store = bc_fill(pkg, n=200, regions=8)
        orig = store.batch_coprocessor
        fired = []

        def hijack(reqs, **kw):
            if not fired:
                fired.append(1)
                store.cluster.split(pkg.Codec.encode_row_key(BC_TID, 10))
            return orig(reqs, **kw)

        store.batch_coprocessor = hijack
        r0 = pkg.metrics.DISTSQL_RETRIES.value
        e0 = pkg.metrics.REGION_ERRORS.labels("epoch_not_match").value
        res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), batch_cop=True))
        assert pkg.metrics.DISTSQL_RETRIES.value - r0 == 1  # only the split region
        assert pkg.metrics.REGION_ERRORS.labels("epoch_not_match").value - e0 == 1
        assert res.batch_stats["regions"] == 7  # the other 7 stayed batched
        assert all_vals(res) == [h * 3 for h in range(200)]
        return res

    same_select(*both(case))


def test_paging_requests_are_excluded_from_batching():
    def case(pkg):
        store = bc_fill(pkg, n=200, regions=8)
        called = []
        orig = store.batch_coprocessor
        store.batch_coprocessor = lambda *a, **k: called.append(1) or orig(*a, **k)
        res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), batch_cop=True, paging_size=16))
        assert not called  # paging bypasses the batch path entirely
        assert res.batch_stats is None
        assert all_vals(res) == [h * 3 for h in range(200)]
        return res

    same_select(*both(case), pool=True)


def test_exec_summaries_follow_task_order():
    """Regions of different sizes over a pool: the scan summaries come
    back in region (task) order, not completion order."""
    def case(pkg):
        store = pkg.store()
        for h in range(100):
            store.put_row(BC_TID, h, [1], [pkg.T.Datum.i64(h)], ts=10)
        for b in (10, 30, 60):  # region sizes 10, 20, 30, 40
            store.cluster.split(pkg.Codec.encode_row_key(BC_TID, b))
        out = []
        for _ in range(3):
            store.evict_caches()  # defeat the result cache: run the real path
            res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=4, keep_order=True))
            assert [task[0].num_produced_rows for task in res.exec_summaries] == [10, 20, 30, 40]
            out.append(res)
        return out

    for jres, tres in zip(*both(case)):
        same_select(jres, tres, pool=True)


@pytest.mark.parametrize("tier", ["single", "batch"])
def test_dispatch_over_wire_matches(tier):
    kw = {"batch_cop": True} if tier == "batch" else {"concurrency": 1}

    def case(pkg):
        store = bc_fill(pkg, n=200, regions=8)
        res = pkg.D.select(store, bc_req(pkg, bc_agg_dag(pkg), use_wire=True, mesh=False, **kw))
        obj = pkg.D.select(store, bc_req(pkg, bc_agg_dag(pkg), ts=101, mesh=False, **kw))
        assert [chunk_rows(c) for c in res.chunks] == [chunk_rows(c) for c in obj.chunks]
        assert sum(all_vals(res)) == 100
        return res

    same_select(*both(case))


# ---------------------------------------------------------------------------
# the tiers, and a split made by the failpoint mid-statement
# ---------------------------------------------------------------------------

TIERS = {"single": {"concurrency": 1}, "pool": {"concurrency": 4}, "batch": {"batch_cop": True}}


def tier_dags(pkg):
    E, X, T = pkg.E, pkg.X, pkg.T
    ft = T.new_longlong()
    scan = E.TableScan(BC_TID, (E.ColumnInfo(1, ft),))
    grouped = E.Aggregation(group_by=(X.func("mod", ft, X.col(0, ft), X.lit(7, ft)),),
                            aggs=(X.AggDesc("count", ()), X.AggDesc("sum", (X.col(0, ft),))), partial=True)
    topn = E.TopN(order_by=((X.col(0, ft), True),), limit=5)
    return {
        "scan": bc_scan_dag(pkg),
        "partial_agg": bc_agg_dag(pkg),
        "grouped": E.DAGRequest((scan, grouped), output_offsets=tuple(range(len(grouped.output_fts())))),
        "topn": E.DAGRequest((scan, topn), output_offsets=(0,)),
    }


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("dag", ["scan", "partial_agg", "grouped", "topn"])
def test_select_tiers_equal_the_jax_ones(tier, dag):
    def case(pkg):
        store = bc_fill(pkg, n=240, regions=6)
        res = pkg.D.select(store, bc_req(pkg, tier_dags(pkg)[dag], mesh=False, **TIERS[tier]))
        assert len(res.chunks) == 6
        assert (res.batch_stats is not None) == (tier == "batch")
        return res

    same_select(*both(case), pool=tier == "pool")


def _arm_split(pkg, store, handle):
    """Arm distsql.before_task so that its first evaluation splits the
    region holding `handle`; every evaluation waits for that split (the
    callable runs under one lock), so no task is sent before it."""
    lock, done = threading.Lock(), []

    def split_once():
        with lock:
            if not done:
                done.append(store.cluster.split(pkg.Codec.encode_row_key(BC_TID, handle)))

    pkg.failpoint.enable("distsql.before_task", split_once)
    return done


@pytest.mark.parametrize("tier", list(TIERS))
def test_failpoint_split_mid_statement(tier):
    def case(pkg):
        store = bc_fill(pkg, n=240, regions=6)
        e0 = pkg.metrics.REGION_ERRORS.labels("epoch_not_match").value
        done = _arm_split(pkg, store, 100)  # inside the third region (80..120)
        try:
            res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), **TIERS[tier]))
        finally:
            pkg.failpoint.disable("distsql.before_task")
        assert done and len(store.cluster.regions()) == 7
        assert pkg.metrics.REGION_ERRORS.labels("epoch_not_match").value - e0 == 1
        assert all_vals(res) == [h * 3 for h in range(240)]
        assert len(res.chunks) == 7  # the stale task came back as two
        return res

    jres, tres = both(case)
    same_select(jres, tres, pool=tier == "pool")
    if tier == "batch":
        assert tres.batch_stats["regions"] == 5


# ---------------------------------------------------------------------------
# the retry ladder without a PD
# ---------------------------------------------------------------------------

def test_all_stores_down_with_no_backoff_budget_raises_region_unavailable():
    def case(pkg):
        store = bc_fill(pkg, n=60, regions=3)
        store.cluster.set_stores(3)
        for sid in range(3):
            store.set_down(sid)
        with pytest.raises(pkg.D.RegionUnavailableError, match="backoff budget exhausted") as ei:
            pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=1, backoff_weight=0))
        return type(ei.value).__name__, store.breakers.states()

    (jname, jstates), (tname, tstates) = both(case)
    assert tname == jname == "RegionUnavailableError"
    assert tstates == jstates


def test_not_leader_hint_switches_peers_once():
    """A task routed to a follower answers not_leader with the leader as
    its hint; the loop switches to the hinted peer with no backoff."""
    def case(pkg):
        store = bc_fill(pkg, n=60, regions=1)
        store.cluster.set_stores(3)
        region = store.cluster.regions()[0]
        leader = store.cluster.leader_of(region.region_id)
        follower = next(p for p in store.cluster.peers_of(region.region_id) if p != leader)
        real = pkg.dispatch._route_task
        routed = []

        def route_to_follower_first(store_, req, task, avoid=frozenset(), leader_only=False, ctx=None):
            sid = follower if not routed else real(store_, req, task, avoid, leader_only, ctx)
            routed.append(sid)
            return sid

        nl0 = pkg.metrics.REGION_ERRORS.labels("not_leader").value
        b0 = pkg.metrics.BACKOFF_SECONDS.labels("not_leader").value
        pkg.dispatch._route_task = route_to_follower_first
        try:
            res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=1))
        finally:
            pkg.dispatch._route_task = real
        assert pkg.metrics.REGION_ERRORS.labels("not_leader").value - nl0 == 1
        assert pkg.metrics.BACKOFF_SECONDS.labels("not_leader").value == b0  # no backoff round
        assert routed == [follower]  # the second send took the hint, not the router
        assert all_vals(res) == [h * 3 for h in range(60)]
        return res, (leader, follower)

    (jres, jpeers), (tres, tpeers) = both(case)
    assert tpeers == jpeers
    same_select(jres, tres)


def test_follower_read_ends_in_cop_internal_error():
    """A follower read is served by a follower peer whose safe_ts covers the
    snapshot (the store's replication gate), in both packages alike and
    equal to the leader read; an other_error on that path
    (`cop-other-error` armed) ends in CopInternalError, in both."""
    def case(pkg):
        store = bc_fill(pkg, n=60, regions=1)
        store.cluster.set_stores(3)
        f0 = pkg.metrics.REPLICA_READS.labels("follower").value
        res = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=1, replica_read="follower"))
        served = pkg.metrics.REPLICA_READS.labels("follower").value - f0
        lead = pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=1))
        assert served == 1 and all_vals(res) == all_vals(lead) == [h * 3 for h in range(60)]
        with pkg.failpoint.enabled("cop-other-error"):
            with pytest.raises(pkg.D.CopInternalError, match="injected coprocessor error"):
                pkg.D.select(store, bc_req(pkg, bc_scan_dag(pkg), concurrency=1, replica_read="follower"))
        return served, all_vals(res)

    j, t = both(case)
    assert t == j


def test_store_exposes_the_client_seams():
    jstore, tstore = JStore(), TStore(device="cpu")
    for store in (jstore, tstore):
        store.set_down(2)
        assert store.down_stores() == {2}
        store.set_up(2)
        assert store.down_stores() == set()
        assert store.breakers.all_closed()
    assert type(tstore.breakers) is t_dispatch.BreakerBoard


# ---------------------------------------------------------------------------
# the kernels' launch counters from several threads
# ---------------------------------------------------------------------------

def test_launch_counters_are_exact_from_four_threads(monkeypatch):
    """The pool tier launches from several threads: each launch adds one
    to its wrapper's `launches` under a lock (kernels.count_launch), so no
    increment is lost; the plain versions, which the CPU runs, add none."""
    import sys

    import torch

    from tidb_tpu_torch import kernels
    from tidb_tpu_torch.ops import dense_agg as K1
    from tidb_tpu_torch.ops import join_probe as K4
    from tidb_tpu_torch.ops import joinscan as K23

    fns = (K1.dense_agg, K23.postsort_segscan, K23.membership_segscan, K4.probe_tables)
    for f in fns:
        monkeypatch.setattr(f, "launches", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    n = 2000
    hp = torch.arange(64, dtype=torch.int64) % 5
    vals, nulls = [torch.arange(64, dtype=torch.int64)], [torch.zeros(64, dtype=torch.bool)]
    valid = torch.ones(64, dtype=torch.bool)
    errors = []

    def work():
        try:
            for i in range(n):
                if i % 500 == 0:  # the plain path, as the CPU runs it: no launch
                    K1.dense_agg(hp, hp * 7, valid, vals, nulls, 8)
                for f in fns:
                    kernels.count_launch(f)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert [f.launches for f in fns] == [4 * n] * 4
