"""The port's store mesh tier and its dispatch (tidb_tpu_torch/store/
store.py _run_cop_mesh, exec/executor.py drive_mesh_program_info,
distsql/planner.py) against the JAX package's, on the CPU: the 17
non-slow cases of tests/test_mesh_dispatch.py.

A JAX TPUStore on tests/conftest.py's eight virtual CPU devices and a port
`TPUStore(device="cpu", mesh_devices=["cpu"] * 8)` get the same rows,
splits and stores; each case runs through both packages: the tier rules,
the merge-kind gate, one merged state per store (scalar, through
select_stream and over the wire), execute_root scalar / grouped / TopN,
epoch fall-out, the min-rows floor (the store's and the request's), the
skew guard, mesh off, the wire fields, the scalar entry point refusing a
grouped DAG, EXPLAIN ANALYZE and TRACE of a SQL statement, and a quick
storm of topology churn under SQL with the mesh on. Chunks are compared
row by row in order, with `mesh_merged`, the batch stats and the mesh
counters' deltas. Tolerance: exact (integer data).

The storm here churns the topology the mesh tier sees (splits, merges, a
split in the middle of a statement) and holds every answer to a
single-region session's and to the JAX package's. Beside it stands the
reference's form of the storm: the port's own seeded chaos harness
(tidb_tpu_torch/tools/chaos.py run_chaos) with its PD, replica reads and
store faults over a store whose mesh tier has eight CPU devices, held to
the reference's invariants (a storm's interleaving is its backoffs', so
not to the JAX package's run); the 80-statement form is marked slow, as
the reference marks it.
"""

import threading
from types import SimpleNamespace

import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.codec.wire as JW
import tidb_tpu.distsql.dispatch as JDd
import tidb_tpu.distsql.planner as JPl
import tidb_tpu.distsql.root as JR
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.parallel as JPar
import tidb_tpu.sql as JS
import tidb_tpu.store as JSt
import tidb_tpu.store.store as JStS
import tidb_tpu.types as JT
import tidb_tpu.util.failpoint as j_fp
import tidb_tpu.util.metrics as JM
import tidb_tpu.util.tracing as JTr
from tidb_tpu.codec import tablecodec as j_tc

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec.wire as TW
import tidb_tpu_torch.distsql.dispatch as TDd
import tidb_tpu_torch.distsql.planner as TPl
import tidb_tpu_torch.distsql.root as TR
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.parallel as TPar
import tidb_tpu_torch.sql as TS
import tidb_tpu_torch.store as TSt
import tidb_tpu_torch.store.store as TStS
import tidb_tpu_torch.types as TT
import tidb_tpu_torch.util.failpoint as t_fp
import tidb_tpu_torch.util.metrics as TM
import tidb_tpu_torch.util.tracing as TTr
from tidb_tpu_torch.codec import tablecodec as t_tc

CPU8 = ["cpu"] * 8
J = SimpleNamespace(name="jax", C=JC, W=JW, D=JDd, Pl=JPl, R=JR, E=JE, X=JX, Par=JPar, S=JS, St=JSt, StS=JStS, T=JT,
                    fp=j_fp, M=JM, Tr=JTr, tc=j_tc, store=lambda: JSt.TPUStore(),
                    mesh=lambda: JPar.region_mesh(), session=lambda: JS.Session(),
                    stack=lambda ch, n: JPar.stack_region_batches(ch, n_total=n))
P = SimpleNamespace(name="torch", C=TC, W=TW, D=TDd, Pl=TPl, R=TR, E=TE, X=TX, Par=TPar, S=TS, St=TSt, StS=TStS,
                    T=TT, fp=t_fp, M=TM, Tr=TTr, tc=t_tc, store=lambda: TSt.TPUStore(device="cpu", mesh_devices=CPU8),
                    mesh=lambda: TPar.region_mesh(CPU8), session=lambda: TS.Session(device="cpu", mesh_devices=CPU8),
                    stack=lambda ch, n: TPar.stack_region_batches(ch, n_total=n, device="cpu"))

TID = 21


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def both(case):
    return case(J), case(P)


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def plain(values):
    """Session.values() rows as strings (each package has its own Datum
    value classes)."""
    return [[None if v is None else str(v) for v in row] for row in values]


def chunks_of(res):
    return [None if c is None else canon(c.rows()) for c in res.chunks]


def deltas(pkg, fn):
    """(fn(), the mesh counters' deltas over the call)."""
    names = ("MESH_COP_LANES", "MESH_COP_BATCHES", "MESH_COP_FALLBACKS")
    before = [getattr(pkg.M, n).value for n in names]
    out = fn()
    return out, [getattr(pkg.M, n).value - b for n, b in zip(names, before)]


def fill_store(pkg, rows=180, regions=6, stores=2):
    store = pkg.store()
    for h in range(rows):
        store.put_row(TID, h, [1, 2], [pkg.T.Datum.i64(h % 7), pkg.T.Datum.i64(h)], ts=10)
    for i in range(1, regions):
        store.cluster.split(pkg.tc.encode_row_key(TID, i * rows // regions))
    if stores > 1:
        store.cluster.set_stores(stores)
        store.cluster.scatter()
    return store


def scan(pkg):
    I = pkg.T.new_longlong()
    return pkg.E.TableScan(TID, (pkg.E.ColumnInfo(1, I), pkg.E.ColumnInfo(2, I)))


def four_aggs(pkg):
    I, X = pkg.T.new_longlong(), pkg.X
    return (X.AggDesc("count", ()), X.AggDesc("sum", (X.col(1, I),)), X.AggDesc("min", (X.col(1, I),)),
            X.AggDesc("max", (X.col(1, I),)))


def scalar_partial_dag(pkg):
    E, X, T = pkg.E, pkg.X, pkg.T
    I = T.new_longlong()
    agg = E.Aggregation(group_by=(), aggs=four_aggs(pkg), partial=True)
    pred = X.func("gt", T.new_longlong(notnull=True), X.col(0, I), X.lit(1, I))
    return E.DAGRequest((scan(pkg), E.Selection((pred,)), agg), output_offsets=tuple(range(4)))


def logical_dag(pkg, aggs, group_by=()):
    agg = pkg.E.Aggregation(group_by=group_by, aggs=aggs)
    return pkg.E.DAGRequest((scan(pkg), agg), output_offsets=tuple(range(len(aggs) + len(group_by))))


def folded(pkg, chunks):
    """The Final merge of partial states, by the oracle."""
    merge = pkg.R.split_dag(logical_dag(pkg, four_aggs(pkg))).root_dag
    return canon(pkg.E.run_dag_reference(merge, pkg.C.Chunk.concat([c for c in chunks if c is not None])))


def oracle_rows(pkg, dag, rows=180):
    I = pkg.T.new_longlong()
    ch = pkg.C.Chunk.from_rows([I, I], [[pkg.T.Datum.i64(h % 7), pkg.T.Datum.i64(h)] for h in range(rows)])
    return canon(pkg.E.run_dag_reference(dag, ch))


def full(pkg):
    return pkg.D.full_table_ranges(TID)


# ------------------------------------------------------------ the planner

def test_planner_tier_rules():
    def case(pkg):
        store = fill_store(pkg)
        tasks = list(range(6))
        pdag, sdag = scalar_partial_dag(pkg), pkg.E.DAGRequest((scan(pkg),), output_offsets=(0, 1))
        KV, ct = pkg.D.KVRequest, pkg.Pl.choose_tier
        out = [ct(store, KV(pdag, [], 100), tasks)]
        out += [ct(store, KV(sdag, [], 100, batch_cop=True), tasks).tier, ct(store, KV(sdag, [], 100), tasks).tier,
                ct(store, KV(pdag, [], 100, paging_size=16), tasks).tier, ct(store, KV(pdag, [], 100), tasks[:1]).tier,
                ct(store, KV(pdag, [], 100, mesh=False), tasks).tier,
                ct(store, KV(pdag, [], 100, mesh=False, batch_cop=True), tasks).tier,
                ct(store, KV(pdag, [], 100, mesh_min_rows=1 << 30), tasks).tier]
        assert out[0] == pkg.Pl.TierDecision("mesh", "scalar")
        return [(out[0].tier, out[0].kind)] + out[1:]

    j, p = both(case)
    assert p == j == [("mesh", "scalar"), "batch", "pool", "pool", "single", "pool", "batch", "pool"]
    # one mesh device (the port's default for a cpu store): no mesh tier
    one = TSt.TPUStore(device="cpu")
    assert TPl.choose_tier(one, TDd.KVRequest(scalar_partial_dag(P), [], 100), list(range(6))).tier == "pool"


def test_mesh_merge_kind_gate():
    from dataclasses import replace

    def case(pkg):
        E, X, I = pkg.E, pkg.X, pkg.T.new_longlong()
        k = pkg.Pl.mesh_merge_kind
        gagg = E.Aggregation(group_by=(X.col(0, I),), aggs=(X.AggDesc("sum", (X.col(1, I),)),), partial=True)
        tdag = E.DAGRequest((scan(pkg), E.TopN(order_by=((X.col(1, I), True),), limit=5)), output_offsets=(0, 1))
        cagg = E.Aggregation(group_by=(), aggs=(X.AggDesc("count", ()),))
        dagg = E.Aggregation(group_by=(), aggs=(X.AggDesc("count", (X.col(1, I),), distinct=True),), partial=True)
        return [k(scalar_partial_dag(pkg)), k(E.DAGRequest((scan(pkg), gagg), output_offsets=(0, 1))), k(tdag),
                k(E.DAGRequest((scan(pkg), cagg), output_offsets=(0,))),
                k(E.DAGRequest((scan(pkg), dagg), output_offsets=(0,))),
                k(replace(scalar_partial_dag(pkg), output_offsets=(1, 0, 2, 3)))]

    j, p = both(case)
    assert p == j == ["scalar", "group", "topn", None, None, None]


# -------------------------------------------- one merged state per store

def test_scalar_merge_one_merged_state_per_store():
    def case(pkg):
        store = fill_store(pkg)
        dag = scalar_partial_dag(pkg)
        res, d = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100)))
        assert d[:2] == [6, 2] and res.batch_stats["mesh_lanes"] == 6 and res.batch_stats["mesh_batches"] == 2
        assert len([c for c in res.chunks if c is not None and c.num_rows()]) == 2
        ref = pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100, mesh=False))
        assert folded(pkg, res.chunks) == folded(pkg, ref.chunks)
        return chunks_of(res), res.batch_stats, d

    j, p = both(case)
    assert p == j


@pytest.mark.parametrize("shape", ["scalar", "grouped", "topn"])
def test_execute_root_matches_oracle(shape):
    def case(pkg):
        store = fill_store(pkg)
        X, E, I = pkg.X, pkg.E, pkg.T.new_longlong()
        if shape == "scalar":
            dag = logical_dag(pkg, (X.AggDesc("count", ()), X.AggDesc("sum", (X.col(1, I),)),
                                    X.AggDesc("avg", (X.col(1, I),)), X.AggDesc("min", (X.col(0, I),)),
                                    X.AggDesc("max", (X.col(1, I),)), X.AggDesc("first_row", (X.col(0, I),))))
        elif shape == "grouped":
            dag = logical_dag(pkg, (X.AggDesc("count", ()), X.AggDesc("sum", (X.col(1, I),)),
                                    X.AggDesc("max", (X.col(1, I),))), group_by=(X.col(0, I),))
        else:
            dag = E.DAGRequest((scan(pkg), E.TopN(order_by=((X.col(1, I), True),), limit=9)), output_offsets=(0, 1))
        out, d = deltas(pkg, lambda: pkg.R.execute_root(store, dag, full(pkg), start_ts=100))
        assert d[0] > 0 and d[2] == 0  # the mesh tier ran and never fell back
        got, want = canon(out.rows()), oracle_rows(pkg, dag)
        assert (sorted(got) == sorted(want)) if shape == "grouped" else (got == want)
        return got, d

    j, p = both(case)
    assert p == j


def test_select_stream_mesh_yields_merged_states():
    def case(pkg):
        store = fill_store(pkg)
        dag = scalar_partial_dag(pkg)
        got = list(pkg.D.select_stream(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100)))
        live = [c for c, _sums in got if c.num_rows()]
        assert len(live) == 2
        ref = pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100, mesh=False))
        assert folded(pkg, live) == folded(pkg, ref.chunks)
        return [canon(c.rows()) for c, _ in got]

    j, p = both(case)
    assert p == j


# ---------------------------------------------------- robustness contracts

def test_epoch_mismatch_falls_out_of_mesh_batch():
    def case(pkg):
        store = fill_store(pkg, stores=1)
        dag = scalar_partial_dag(pkg)
        orig, fired = store.batch_coprocessor, []

        def hijack(reqs, **kw):
            if not fired:
                fired.append(1)
                store.cluster.split(pkg.tc.encode_row_key(TID, 5))
            return orig(reqs, **kw)

        store.batch_coprocessor = hijack
        r0 = pkg.M.DISTSQL_RETRIES.value
        res = pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100))
        assert pkg.M.DISTSQL_RETRIES.value - r0 >= 1 and res.batch_stats["mesh_lanes"] >= 4
        store.batch_coprocessor = orig
        ref = pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100, mesh=False))
        assert folded(pkg, res.chunks) == folded(pkg, ref.chunks)
        return chunks_of(res), res.batch_stats

    j, p = both(case)
    assert p == j


def test_min_group_rows_floor_degrades_to_vmap():
    def case(pkg):
        store = fill_store(pkg)
        store.MESH_MIN_GROUP_ROWS = 10_000
        res, d = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(scalar_partial_dag(pkg), full(pkg),
                                                                           start_ts=100)))
        assert d[0] == 0 and res.batch_stats["mesh_lanes"] == 0 and res.batch_stats["regions"] > 0
        return chunks_of(res), res.batch_stats, d

    j, p = both(case)
    assert p == j


def test_mesh_min_rows_hint_enforced_on_actual_rows():
    def case(pkg):
        store = fill_store(pkg, stores=1)
        dag = scalar_partial_dag(pkg)
        res1, d1 = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=100,
                                                                             mesh_min_rows=120)))
        assert d1[0] > 0
        for h in range(100):
            store.put_row(TID + 1, h, [1, 2], [pkg.T.Datum.i64(h), pkg.T.Datum.i64(h)], ts=11)
        res2, d2 = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(dag, full(pkg), start_ts=101,
                                                                             mesh_min_rows=200)))
        assert d2[0] == 0 and res2.batch_stats["mesh_lanes"] == 0 and res2.batch_stats["regions"] > 0
        return chunks_of(res1), chunks_of(res2), d1, d2

    j, p = both(case)
    assert p == j


def test_skewed_capacities_degrade_to_vmap_buckets():
    def case(pkg):
        store = pkg.store()
        for h in range(220):
            store.put_row(TID, h, [1, 2], [pkg.T.Datum.i64(h % 7), pkg.T.Datum.i64(h)], ts=10)
        for i in range(5):
            store.cluster.split(pkg.tc.encode_row_key(TID, 200 + i * 4))
        res, d = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(scalar_partial_dag(pkg), full(pkg),
                                                                           start_ts=100)))
        assert d[0] == 0 and d[2] == 1 and res.batch_stats["regions"] > 0
        assert int(folded(pkg, res.chunks)[0][0]) == sum(1 for h in range(220) if h % 7 > 1)
        return chunks_of(res), d

    j, p = both(case)
    assert p == j


def test_mesh_off_pins_old_paths():
    def case(pkg):
        store = fill_store(pkg)
        res, d = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(scalar_partial_dag(pkg), full(pkg),
                                                                           start_ts=100, mesh=False)))
        assert d[0] == 0 and res.batch_stats is None
        return chunks_of(res)

    j, p = both(case)
    assert p == j


def test_wire_roundtrip_mesh_fields():
    def case(pkg):
        req = pkg.St.CopRequest(scalar_partial_dag(pkg), full(pkg), 100, 3, 1, mesh=True, mesh_min_rows=1 << 33)
        raw = pkg.W.encode_cop_request(req)
        back = pkg.W.decode_cop_request(raw)
        assert back.mesh is True and back.mesh_min_rows == 1 << 33
        resp = pkg.StS.CopResponse(chunk=None, region_error="x", batched=2, mesh_merged=5)
        rraw = pkg.W.encode_cop_response(resp)
        rback = pkg.W.decode_cop_response(rraw)
        assert rback.batched == 2 and rback.mesh_merged == 5
        return raw, rraw

    j, p = both(case)
    assert p == j


def test_run_sharded_partial_agg_rejects_grouped_dag():
    def case(pkg):
        E, X, I = pkg.E, pkg.X, pkg.T.new_longlong()
        rows = [[pkg.T.Datum.i64(i % 3), pkg.T.Datum.i64(i)] for i in range(8)]
        chunks = [pkg.C.Chunk.from_rows([I, I], rows)] * 2
        gagg = E.Aggregation(group_by=(X.col(0, I),), aggs=(X.AggDesc("sum", (X.col(1, I),)),), partial=True)
        dag = E.DAGRequest((scan(pkg), gagg), output_offsets=(0, 1))
        with pytest.raises(AssertionError, match="scalar"):
            pkg.Par.run_sharded_partial_agg(dag, pkg.stack(chunks, 8), pkg.mesh())

    both(case)


def test_wire_mode_select_meshes():
    def case(pkg):
        store = fill_store(pkg)
        res, d = deltas(pkg, lambda: pkg.D.select(store, pkg.D.KVRequest(scalar_partial_dag(pkg), full(pkg),
                                                                           start_ts=100, use_wire=True)))
        assert d[0] == 6 and res.batch_stats["mesh_lanes"] == 6
        return chunks_of(res), res.batch_stats, d

    j, p = both(case)
    assert p == j


# ----------------------------------------------------------- SQL + a storm

def test_sql_mesh_explain_and_trace():
    def case(pkg):
        s = pkg.session()
        s.execute("CREATE TABLE mt (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO mt VALUES " + ",".join(f"({i},{i % 13})" for i in range(400)))
        tid = s.catalog.table("mt").table_id
        for i in range(1, 8):
            s.store.cluster.split(pkg.tc.encode_row_key(tid, i * 50))
        q = "SELECT count(*), sum(v), min(v), max(v) FROM mt WHERE v < 9"
        s.execute("SET tidb_enable_tpu_mesh = OFF")
        want = s.execute(q).values()
        s.execute("SET tidb_enable_tpu_mesh = ON")
        s.store.evict_caches()
        got = s.execute(q).values()
        assert got == want
        s.store.evict_caches()
        mc = {r[0]: r for r in s.execute("EXPLAIN ANALYZE " + q).values()}["mesh_cop"]
        assert mc[1] == 8 and mc[2] >= 1 and mc[5].startswith("merged=8->")
        with pkg.Tr.trace("t") as root:
            s.execute(q)
        spans = root.find("distsql.batch_cop")
        assert spans and spans[0].attrs.get("tier") == "mesh"
        assert root.sum_attr("distsql.batch_cop", "mesh_lanes_merged") == 8
        mesh_exec = root.find("cop.mesh_execute")
        assert mesh_exec and mesh_exec[0].attrs.get("kind") == "scalar"
        return plain(got), mc[1:3], mc[5]

    j, p = both(case)
    assert p == j


STORM_ROWS = 160


def storm_fill(pkg, split: bool):
    s = pkg.session()
    s.execute("CREATE TABLE chaos_t (id BIGINT PRIMARY KEY, v BIGINT, g BIGINT)")
    s.execute("CREATE TABLE chaos_d (g BIGINT PRIMARY KEY, name VARCHAR(16))")
    s.execute("INSERT INTO chaos_t VALUES " + ",".join(f"({i},{(i * 37) % 101},{i % 6})" for i in range(STORM_ROWS)))
    s.execute("INSERT INTO chaos_d VALUES " + ",".join(f"({g},'grp{g}')" for g in range(6)))
    if split:
        tid = s.catalog.table("chaos_t").table_id
        for i in range(1, 8):
            s.store.cluster.split(pkg.tc.encode_row_key(tid, i * STORM_ROWS // 8))
        s.store.cluster.set_stores(4)
        s.store.cluster.scatter()
        s.execute("SET tidb_allow_batch_cop = ON")
    else:
        s.execute("SET tidb_enable_tpu_mesh = OFF")
    return s


STORM = [
    "SELECT count(*), sum(v) FROM chaos_t WHERE v < 40",
    "SELECT g, count(*), sum(v) FROM chaos_t GROUP BY g ORDER BY g",
    "SELECT max(v), min(v), count(*) FROM chaos_t WHERE id >= 33",
    "SELECT t.g, d.name, count(*) FROM chaos_t t JOIN chaos_d d ON t.g = d.g WHERE t.v < 70 "
    "GROUP BY t.g, d.name ORDER BY t.g",
    "SELECT id, v FROM chaos_t ORDER BY v DESC, id LIMIT 10",
    "SELECT id, v FROM chaos_t WHERE id BETWEEN 50 AND 70 ORDER BY id",
]


def test_chaos_small_storm_mesh_quick():
    """Topology churn under SQL with the mesh on: splits and merges between
    statements and a split in the middle of one (the distsql.before_task
    failpoint): every answer equals a single-region session's (mesh off)
    and the JAX package's, and the mesh tier ran."""
    def case(pkg):
        s, oracle = storm_fill(pkg, True), storm_fill(pkg, False)
        tid = s.catalog.table("chaos_t").table_id
        l0 = pkg.M.MESH_COP_LANES.value
        out = []
        for i in range(9):
            sql = STORM[i % len(STORM)]
            if i % 5 == 2:
                s.store.cluster.split(pkg.tc.encode_row_key(tid, 7 + 11 * i))
            if i % 7 == 3:
                regions = s.store.cluster.regions()
                s.store.cluster.merge(regions[1].region_id)
            if i % 6 == 4:
                lock, done = threading.Lock(), []

                def split_once():
                    with lock:
                        if not done:
                            done.append(s.store.cluster.split(pkg.tc.encode_row_key(tid, 3 + 5 * i)))

                pkg.fp.enable("distsql.before_task", split_once)
            try:
                got = s.execute(sql).values()
            finally:
                pkg.fp.disable("distsql.before_task")
            assert got == oracle.execute(sql).values(), sql
            out.append(plain(got))
        assert pkg.M.MESH_COP_LANES.value > l0
        return out

    j, p = both(case)
    assert p == j


def test_run_chaos_small_storm_mesh_quick():
    """The reference's tier-1 storm (tests/test_mesh_dispatch.py
    test_chaos_small_storm_mesh_quick) over the port: run_chaos at seed 23,
    30 statements, the storm's store sharding its mesh tier over eight CPU
    devices: zero wrong results, every error typed, and the mesh tier
    merged region lanes. Invariants only."""
    from tidb_tpu_torch.tools.chaos import run_chaos

    l0 = TM.MESH_COP_LANES.value
    report = run_chaos(seed=23, statements=30, device="cpu", mesh_devices=CPU8)
    assert report["wrong_results"] == []
    assert report["untyped_errors"] == []
    assert TM.MESH_COP_LANES.value > l0


@pytest.mark.slow
def test_chaos_storm_with_mesh_tier():
    """The chaos acceptance bar with the mesh tier on (the reference's
    slow case): seeded splits, outages and transfers at seed 17, 80
    statements, zero wrong results, and on-device merges really happened.
    Invariants only."""
    from tidb_tpu_torch.tools.chaos import run_chaos

    l0 = TM.MESH_COP_LANES.value
    report = run_chaos(seed=17, statements=80, device="cpu", mesh_devices=CPU8)
    assert report["wrong_results"] == []
    assert report["untyped_errors"] == []
    assert TM.MESH_COP_LANES.value > l0  # the storm rode the mesh
