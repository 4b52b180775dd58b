"""The port's root executor (tidb_tpu_torch/distsql/root.py execute_root)
against the JAX package's, on the CPU.

A JAX TPUStore and a port TPUStore(device="cpu") get the same rows and
splits, and each case of tests/test_root_exec.py runs through both
packages' execute_root: a grouped and a scalar aggregate split into
Partial1 + Final, TopN and Limit re-applied at the root, DISTINCT at the
root, HAVING + TopN after the merge, a Selection before the aggregate, a
plain scan with no root half, an empty table, and TPC-H Q3 with its build
sides fetched by select and passed as aux chunks. The two packages' rows
must be equal (in order where the statement orders them), and equal to the
JAX package's single-shot oracle over all rows. Beyond those cases:
low_memory=True (the Partial2 fold over select_stream) gives the normal
path's rows; summary_sink receives the per-task summary lists and, in the
batch tier, the batch-stats dict, as in the JAX package; a memory tracker
returns to 0 on the normal path and ends where the JAX package's does on
the low-memory one; and the tiers (single, pool, batch) agree.

The JAX side runs with the planner's defaults, so on its 8 CPU devices its
dispatch may take the mesh tier; the Final merge makes the rows equal
either way. Tolerance: exact (integer, decimal and string data).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import tidb_tpu.chunk as JC
import tidb_tpu.codec as JCodec
import tidb_tpu.distsql as JD
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.exec.executor import datum_group_key
from tidb_tpu.exec.executor import run_dag_reference as j_oracle
from tidb_tpu.store import TPUStore as JStore

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.distsql as TD
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch.store import TPUStore as TStore

J = SimpleNamespace(name="jax", T=JT, E=JE, X=JX, C=JC, Codec=JCodec, D=JD, store=lambda: JStore())
P = SimpleNamespace(name="torch", T=TT, E=TE, X=TX, C=TC, Codec=TCodec, D=TD, store=lambda: TStore(device="cpu"))

TID = 77


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def keyed(rows):
    return [tuple(datum_group_key(d) for d in r) for r in rows]


def canon(rows):
    return [tuple(None if d.is_null() else str(d.val) for d in r) for r in rows]


def unordered(rows):
    """Canonical rows in a fixed order (NULLs included)."""
    return sorted(rows, key=repr)


def fts_of(T):
    return [T.new_longlong(), T.new_decimal(10, 2), T.new_varchar(8), T.new_longlong(unsigned=True)]


def values(n, seed, null_p):
    """The table's values, drawn once for both packages."""
    rng = np.random.default_rng(seed)
    words = ["ox", "ant", "bee", "Cat", "dog", ""]
    out = []
    for _ in range(n):
        def maybe(v):
            return None if rng.random() < null_p else v

        out.append([maybe(int(rng.integers(0, 7))), maybe(f"{int(rng.integers(-9999, 9999)) / 100:.2f}"),
                    maybe(words[int(rng.integers(len(words)))]), maybe(int(rng.integers(0, 1 << 62)))])
    return out


def datums(T, vals):
    mk = (T.Datum.i64, lambda v: T.Datum.dec(T.MyDecimal(v)), T.Datum.string, T.Datum.u64)
    return [T.Datum.NULL if v is None else f(v) for f, v in zip(mk, vals)]


def fill(pkg, n=260, regions=4, seed=11, null_p=0.05):
    store = pkg.store()
    rows = []
    for h, vals in enumerate(values(n, seed, null_p)):
        row = datums(pkg.T, vals)
        rows.append(row)
        store.put_row(TID, h, [1, 2, 3, 4], row, ts=10)
    for i in range(1, regions):
        store.cluster.split(pkg.Codec.encode_row_key(TID, i * n // regions))
    return store, rows


def scan(pkg):
    return pkg.E.TableScan(TID, tuple(pkg.E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts_of(pkg.T))))


def C(pkg, i):
    return pkg.X.col(i, fts_of(pkg.T)[i])


def BOOL(pkg):
    return pkg.T.new_longlong(notnull=True)


# each statement of tests/test_root_exec.py, made over either package
def grouped(pkg):
    E, X = pkg.E, pkg.X
    agg = E.Aggregation(
        group_by=(C(pkg, 0), C(pkg, 2)),
        aggs=(X.AggDesc("count", ()), X.AggDesc("sum", (C(pkg, 1),)), X.AggDesc("avg", (C(pkg, 1),)),
              X.AggDesc("min", (C(pkg, 2),)), X.AggDesc("max", (C(pkg, 3),)), X.AggDesc("first_row", (C(pkg, 1),))),
    )
    return E.DAGRequest((scan(pkg), agg), output_offsets=tuple(range(8)))


def scalar(pkg):
    E, X = pkg.E, pkg.X
    agg = E.Aggregation(group_by=(), aggs=(X.AggDesc("count", ()), X.AggDesc("sum", (C(pkg, 1),)),
                                           X.AggDesc("min", (C(pkg, 1),))))
    return E.DAGRequest((scan(pkg), agg), output_offsets=(0, 1, 2))


def topn(pkg):
    t = pkg.E.TopN(order_by=((C(pkg, 1), True), (C(pkg, 0), False)), limit=7)
    return pkg.E.DAGRequest((scan(pkg), t), output_offsets=(0, 1, 2))


def limit(pkg):
    return pkg.E.DAGRequest((scan(pkg), pkg.E.Limit(10)), output_offsets=(0, 1))


def distinct(pkg):
    E, X = pkg.E, pkg.X
    agg = E.Aggregation(group_by=(C(pkg, 0),), aggs=(X.AggDesc("count", (C(pkg, 1),), distinct=True),
                                                     X.AggDesc("sum", (C(pkg, 1),))))
    return E.DAGRequest((scan(pkg), agg), output_offsets=(0, 1, 2))


def having(pkg):
    E, X, T = pkg.E, pkg.X, pkg.T
    agg = E.Aggregation(group_by=(C(pkg, 0),), aggs=(X.AggDesc("count", ()), X.AggDesc("sum", (C(pkg, 1),))))
    hv = E.Selection((X.func("gt", BOOL(pkg), X.col(0, agg.aggs[0].ft), X.lit(20, T.new_longlong())),))
    t = E.TopN(order_by=((X.col(1, agg.aggs[1].ft), True),), limit=3)
    return E.DAGRequest((scan(pkg), agg, hv, t), output_offsets=(0, 1, 2))


def sel_agg(pkg):
    E, X, T = pkg.E, pkg.X, pkg.T
    sel = E.Selection((X.func("ge", BOOL(pkg), C(pkg, 1), X.lit("0.00", T.new_decimal(3, 2))),))
    agg = E.Aggregation(group_by=(C(pkg, 2),), aggs=(X.AggDesc("avg", (C(pkg, 1),)), X.AggDesc("count", ())))
    return E.DAGRequest((scan(pkg), sel, agg), output_offsets=(0, 1, 2))


def plain_scan(pkg):
    E, X = pkg.E, pkg.X
    return E.DAGRequest((scan(pkg), E.Selection((X.func("isnull", BOOL(pkg), C(pkg, 2)),))), output_offsets=(0, 2))


# name -> (the DAG maker, (n, regions), ordered: the statement orders its rows)
CASES = {
    "grouped_agg_split": (grouped, (260, 4), False),
    "scalar_agg_split": (scalar, (150, 3), False),
    "multi_region_topn_reapplied": (topn, (200, 4), True),
    "distinct_agg_runs_at_root": (distinct, (180, 3), False),
    "having_after_agg": (having, (200, 4), True),
    "selection_then_agg": (sel_agg, (220, 4), False),
    "plain_scan_no_root": (plain_scan, (90, 3), False),
}


def run_both(build, size, **kw):
    """execute_root over a JAX and a port store with the same rows; returns
    (jax chunk, port chunk, the JAX rows, the JAX DAG)."""
    n, regions = size
    jstore, jrows = fill(J, n, regions)
    tstore, _ = fill(P, n, regions)
    jdag, tdag = build(J), build(P)
    jgot = JD.execute_root(jstore, jdag, JD.full_table_ranges(TID), start_ts=100, **kw)
    tgot = TD.execute_root(tstore, tdag, TD.full_table_ranges(TID), start_ts=100, **kw)
    return jgot, tgot, jrows, jdag, tstore


@pytest.mark.parametrize("name", list(CASES))
def test_root_executor_equals_the_jax_one(name):
    build, size, ordered = CASES[name]
    jgot, tgot, jrows, jdag, tstore = run_both(build, size)
    want = j_oracle(jdag, JC.Chunk.from_rows(fts_of(JT), jrows))
    if ordered:
        assert canon(tgot.rows()) == canon(jgot.rows())
        assert keyed(tgot.rows()) == keyed(want)
    else:
        assert unordered(canon(tgot.rows())) == unordered(canon(jgot.rows()))
        assert unordered(keyed(tgot.rows())) == unordered(keyed(want))
    assert [ft.tp for ft in tgot.field_types()] == [ft.tp for ft in jgot.field_types()]
    if name == "multi_region_topn_reapplied":
        assert tgot.num_rows() == 7
    plan = TD.split_dag(build(P))
    assert (plan.root_dag is None) == (name == "plain_scan_no_root")
    st = tstore.stats()
    assert st["oracle_fallbacks"] == st["other_errors"] == 0


def test_multi_region_limit_reapplied():
    """LIMIT over an unordered scan is any 10 rows: both packages give 10
    rows of the table (the same ones: regions answer in task order)."""
    jgot, tgot, jrows, _dag, _ = run_both(limit, (120, 3))
    assert tgot.num_rows() == jgot.num_rows() == 10
    assert canon(tgot.rows()) == canon(jgot.rows())
    table = {tuple(datum_group_key(d) for d in (r[0], r[1])) for r in jrows}
    assert all(k in table for k in keyed(tgot.rows()))


def test_empty_table():
    got = {}
    for pkg in (J, P):
        agg = pkg.E.Aggregation(group_by=(), aggs=(pkg.X.AggDesc("count", ()),))
        dag = pkg.E.DAGRequest((scan(pkg), agg), output_offsets=(0,))
        out = pkg.D.execute_root(pkg.store(), dag, pkg.D.full_table_ranges(TID), start_ts=100)
        assert out.num_rows() == 1 and out.row(0)[0].val == 0
        got[pkg.name] = canon(out.rows())
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# Q3 with its build sides fetched by select (tests/test_root_exec.py)
# ---------------------------------------------------------------------------

def q3_fts(T):
    return ([T.new_longlong(), T.new_decimal(10, 2), T.new_decimal(4, 2), T.new_datetime()],
            [T.new_longlong(), T.new_longlong(), T.new_datetime(), T.new_longlong()],
            [T.new_longlong(), T.new_varchar(10)])


def q3_values(nl=300, no=60, nc=20, seed=5, null_p=0.04):
    """tests/test_join_dag.py make_tables' draws as plain values."""
    rng = np.random.default_rng(seed)

    def maybe(v):
        return None if rng.random() < null_p else v

    def date():
        return ("date", 1994 + int(rng.integers(3)), 1 + int(rng.integers(12)), 1 + int(rng.integers(28)))

    lrows = [[maybe(int(rng.integers(0, no + 10))), maybe(f"{int(rng.integers(100, 99999)) / 100:.2f}"),
              maybe(f"0.0{int(rng.integers(10))}"), maybe(date())] for _ in range(nl)]
    orows = [[k, maybe(int(rng.integers(0, nc + 3))), maybe(date()), int(rng.integers(0, 3))] for k in range(no)]
    crows = [[k, maybe(["BUILDING", "AUTOMOBILE", "MACHINERY"][int(rng.integers(3))])] for k in range(nc)]
    return lrows, orows, crows


def q3_datum(T, v):
    if v is None:
        return T.Datum.NULL
    if isinstance(v, tuple):
        return T.Datum.time(T.MyTime.from_ymd(*v[1:]))
    if isinstance(v, int):
        return T.Datum.i64(v)
    if v[0].isdigit():
        return T.Datum.dec(T.MyDecimal(v))
    return T.Datum.string(v)


def q3_dag(pkg, partial=False):
    """tests/test_join_dag.py q3_dag over a package."""
    E, X, T = pkg.E, pkg.X, pkg.T
    LFTS, OFTS, CFTS = q3_fts(T)
    b = T.new_longlong(notnull=True)
    ls = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(LFTS)))
    os_ = E.TableScan(2, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(OFTS)))
    cs = E.TableScan(3, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(CFTS)))
    cust_sel = E.Selection((X.func("eq", b, X.col(1, CFTS[1]), X.lit("BUILDING", T.new_varchar(10))),))
    inner = E.Join(build=(cs, cust_sel), probe_keys=(X.col(1, OFTS[1]),), build_keys=(X.col(0, CFTS[0]),),
                   join_type="inner")
    build = (os_, E.Selection((X.func("lt", b, X.col(2, OFTS[2]), X.lit("1995-03-15", T.new_datetime())),)), inner)
    outer = E.Join(build=build, probe_keys=(X.col(0, LFTS[0]),), build_keys=(X.col(0, OFTS[0]),), join_type="inner")
    lsel = E.Selection((X.func("gt", b, X.col(3, LFTS[3]), X.lit("1995-03-15", T.new_datetime())),))
    post = LFTS + OFTS + CFTS
    revenue = X.func("mul", T.new_decimal(31, 4), X.col(1, post[1]),
                     X.func("minus", T.new_decimal(12, 2), X.lit(1, T.new_longlong()), X.col(2, post[2])))
    agg = E.Aggregation(group_by=(X.col(0, post[0]), X.col(6, post[6]), X.col(7, post[7])),
                        aggs=(X.AggDesc("sum", (revenue,)),), partial=partial)
    return E.DAGRequest((ls, lsel, outer, agg), output_offsets=(0, 1, 2, 3)), (ls, os_, cs)


def q3_run(pkg, **kw):
    lvals, ovals, cvals = q3_values()
    store = pkg.store()
    tables = []
    for tid, vals, cols in ((1, lvals, [1, 2, 3, 4]), (2, ovals, [1, 2, 3, 4]), (3, cvals, [1, 2])):
        rows = [[q3_datum(pkg.T, v) for v in r] for r in vals]
        tables.append(rows)
        for h, r in enumerate(rows):
            store.put_row(tid, h, cols, r, ts=10)
    for frac in (1, 2):
        store.cluster.split(pkg.Codec.encode_row_key(1, frac * 100))
    base, (_ls, os_, cs) = q3_dag(pkg)
    D = pkg.D
    och = D.select(store, D.KVRequest(pkg.E.DAGRequest((os_,), output_offsets=tuple(range(4))),
                                      D.full_table_ranges(2), start_ts=100)).merged()
    cch = D.select(store, D.KVRequest(pkg.E.DAGRequest((cs,), output_offsets=tuple(range(2))),
                                      D.full_table_ranges(3), start_ts=100)).merged()
    top = pkg.E.TopN(order_by=((pkg.X.col(0, base.executors[-1].aggs[0].ft), True),), limit=10)
    dag = pkg.E.DAGRequest(base.executors + (top,), output_offsets=base.output_offsets)
    got = D.execute_root(store, dag, D.full_table_ranges(1), start_ts=100, aux_chunks=[och, cch], **kw)
    return got, dag, tables, store


@pytest.mark.parametrize("tier", ["pool", "batch", "single"])
def test_q3_via_root_executor(tier):
    kw = {"pool": {}, "batch": {"batch_cop": True}, "single": {"concurrency": 1}}[tier]
    jgot, jdag, jtables, _ = q3_run(J, **kw)
    tgot, _, _, tstore = q3_run(P, **kw)
    LFTS, OFTS, CFTS = q3_fts(JT)
    want = j_oracle(jdag, [JC.Chunk.from_rows(f, r) for f, r in zip((LFTS, OFTS, CFTS), jtables)])
    assert len(want) > 0
    # revenue ties may order differently; the revenues in order are equal
    assert [str(r[0].val) for r in tgot.rows()] == [str(r[0].val) for r in jgot.rows()]
    assert unordered(canon(tgot.rows())) == unordered(canon(jgot.rows()))
    assert sorted(str(r[0].val) for r in tgot.rows()) == sorted(str(r[0].val) for r in want)
    st = tstore.stats()
    assert st["oracle_fallbacks"] == st["other_errors"] == st["batch_fallbacks"] == 0


# ---------------------------------------------------------------------------
# low_memory, summary_sink, tracker, tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grouped_agg_split", "scalar_agg_split", "having_after_agg",
                                  "selection_then_agg", "distinct_agg_runs_at_root"])
def test_low_memory_fold_gives_the_normal_rows(name):
    """low_memory=True folds the regions' partial states one region at a
    time (Partial2 over select_stream); a statement with no foldable merge
    point (DISTINCT at the root) takes the normal path."""
    build, size, ordered = CASES[name]
    n, regions = size
    tstore, _ = fill(P, n, regions)
    jstore, _ = fill(J, n, regions)
    normal = TD.execute_root(tstore, build(P), TD.full_table_ranges(TID), start_ts=100)
    folded = TD.execute_root(tstore, build(P), TD.full_table_ranges(TID), start_ts=100, low_memory=True)
    jfolded = JD.execute_root(jstore, build(J), JD.full_table_ranges(TID), start_ts=100, low_memory=True)
    order = (lambda x: x) if ordered else unordered
    assert order(canon(folded.rows())) == order(canon(normal.rows())) == order(canon(jfolded.rows()))
    assert (TD.root._partial2_dag(TD.split_dag(build(P))) is None) == (name == "distinct_agg_runs_at_root")


@pytest.mark.parametrize("tier", ["single", "pool", "batch"])
def test_summary_sink_entries(tier):
    kw = {"single": {"concurrency": 1}, "pool": {}, "batch": {"batch_cop": True}}[tier]
    got = {}
    for pkg in (J, P):
        store, _ = fill(pkg, 200, 4)
        sink = []
        pkg.D.execute_root(store, scalar(pkg), pkg.D.full_table_ranges(TID), start_ts=100, summary_sink=sink,
                           mesh=False, **kw)
        lists = [e for e in sink if isinstance(e, list)]
        dicts = [e for e in sink if isinstance(e, dict)]
        assert len(lists) == 4 and all(len(task) == 2 for task in lists)  # (scan, agg) per region
        got[pkg.name] = ([[s.num_produced_rows for s in task] for task in lists], dicts)
    assert got["torch"] == got["jax"]
    dicts = got["torch"][1]
    if tier == "batch":
        assert dicts == [{"batches": 1, "regions": 4, "launches_saved": 3, "mesh_batches": 0, "mesh_lanes": 0}]
    else:
        assert dicts == []


class Tracker:
    """A memory tracker: bytes consumed, and the peak."""

    def __init__(self):
        self.now = self.peak = 0
        self.calls = 0

    def consume(self, n):
        self.now += n
        self.peak = max(self.peak, self.now)
        self.calls += 1


@pytest.mark.parametrize("low_memory", [False, True])
def test_memory_tracker(low_memory):
    """The tracker sees each region's result bytes. On the normal path it
    returns to 0. The low-memory fold of the JAX package never releases
    its last accumulator, whose bytes stay on the tracker; the port keeps
    that accounting, so both end at the same bytes after the same calls."""
    got = {}
    for pkg in (J, P):
        store, _ = fill(pkg, 260, 4)
        tr = Tracker()
        out = pkg.D.execute_root(store, grouped(pkg), pkg.D.full_table_ranges(TID), start_ts=100, tracker=tr,
                                 low_memory=low_memory, mesh=False)
        assert tr.peak > 0 and tr.calls > 0
        got[pkg.name] = (unordered(canon(out.rows())), tr.now, tr.peak, tr.calls)
    assert got["torch"] == got["jax"]
    _rows, now, peak, _calls = got["torch"]
    if low_memory:
        assert 0 < now < peak
    else:
        assert now == 0


@pytest.mark.parametrize("name", ["grouped_agg_split", "multi_region_topn_reapplied", "distinct_agg_runs_at_root"])
def test_tiers_agree(name):
    build, size, ordered = CASES[name]
    n, regions = size
    store, _ = fill(P, n, regions)
    outs = []
    for kw in ({"concurrency": 1}, {"concurrency": 4}, {"batch_cop": True}):
        store.clear_result_cache()
        outs.append(canon(TD.execute_root(store, build(P), TD.full_table_ranges(TID), start_ts=100, **kw).rows()))
    order = (lambda x: x) if ordered else unordered
    assert all(order(o) == order(outs[0]) for o in outs)
