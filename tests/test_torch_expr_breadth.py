"""The expression families end to end on the CPU: the reference's
device-vs-oracle cases rerun through the port.

From tests/test_expr_breadth.py (upper / lower / trim, concat / substr, the
replace fallback, general_ci compare and GROUP BY, binary collation,
date_add in eight units, month-end clamping, datediff, CI LIKE, substr with
a NULL position) and tests/test_expr.py (casts and math, strings and time,
bit ops): each DAG runs through the port's run_dag_on_chunk(device="cpu"),
the JAX package's run_dag_on_chunk and the port's row oracle
(run_dag_reference). The port's rows must equal the JAX package's exactly
but for reals, which agree to 1e-12 relative (under jit XLA turns the
division of a decimal by 10^scale into a multiplication by its reciprocal,
one ulp from the port's correctly rounded division), and the oracle's as
the reference's own test holds its device: exactly, with reals to 1e-12
relative and, for double -> decimal casts, one unit of the target scale
(the documented deviation of rounding the binary value).

Beyond those: workloads.store_expr_statements through a port
TPUStore(device="cpu") — each statement's push half per region through
batch_coprocessor equals the single path lane by lane with no bucket
fallback (the vmap check), and execute_root in the single and batch tiers
equals the row oracle over the whole table; and types/mytime.py's calendar
helpers on int64 tensors equal the same helpers on Python ints.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tidb_tpu.chunk as JC
import tidb_tpu.exec as JE
import tidb_tpu.expr as JX
import tidb_tpu.types as JT
from tidb_tpu.exec import run_dag_on_chunk as j_run_one

import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.codec as TCodec
import tidb_tpu_torch.distsql as TD
import tidb_tpu_torch.exec as TE
import tidb_tpu_torch.expr as TX
import tidb_tpu_torch.types as TT
from tidb_tpu_torch import workloads as W
from tidb_tpu_torch.exec.executor import datum_group_key, run_dag_on_chunk, run_dag_on_chunks, run_dag_reference
from tidb_tpu_torch.store import CopRequest as TReq
from tidb_tpu_torch.store import TPUStore as TStore
from tidb_tpu_torch.types import mytime

J = SimpleNamespace(T=JT, E=JE, X=JX, C=JC)
P = SimpleNamespace(T=TT, E=TE, X=TX, C=TC)


@pytest.fixture(autouse=True)
def _pallas_off(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_PALLAS", "off")  # JAX on the CPU: its XLA routes


def keyed(rows):
    return [tuple(datum_group_key(d) for d in r) for r in rows]


def same_rows(got, want, rel=1e-12):
    """Keyed rows equal, reals to `rel` relative."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a[1], float) and isinstance(b[1], float):
                assert a[1] == pytest.approx(b[1], rel=rel, abs=1e-9)
            else:
                assert a == b, (g, w)


def parity(case, sort=True):
    """Run case(pkg) -> (dag, chunk) in both packages: the port's device
    rows against the JAX package's device rows and the port's oracle."""
    jdag, jch = case(J)
    tdag, tch = case(P)
    jrows = keyed(j_run_one(jdag, jch).rows())
    dev = run_dag_on_chunk(tdag, tch, device="cpu")
    trows = keyed(dev.rows())
    ref = keyed(run_dag_reference(tdag, [tch]))
    if sort:
        jrows, trows, ref = sorted(jrows, key=repr), sorted(trows, key=repr), sorted(ref, key=repr)
    same_rows(trows, jrows)
    assert trows == ref
    return dev


# ---------------------------------------------------------------------------
# tests/test_expr_breadth.py
# ---------------------------------------------------------------------------

def str_chunk(p, vals):
    T = p.T
    fts = [T.new_longlong(), T.new_varchar(16)]
    rows = [[T.Datum.i64(i), T.Datum.NULL if v is None else T.Datum.string(v)] for i, v in enumerate(vals)]
    return p.C.Chunk.from_rows(fts, rows), fts


def scan2(p, fts):
    return p.E.TableScan(1, (p.E.ColumnInfo(1, fts[0]), p.E.ColumnInfo(2, fts[1])))


def test_upper_lower_trim():
    def case(p):
        ch, fts = str_chunk(p, ["Hello", "  padded  ", "MIXed cASE", "", None, "  x"])
        VC, C1 = p.T.new_varchar(16), p.X.col(1, fts[1])
        proj = p.E.Projection(tuple(p.X.func(op, VC, C1) for op in ("upper", "lower", "trim", "ltrim", "rtrim")))
        return p.E.DAGRequest((scan2(p, fts), proj), output_offsets=(0, 1, 2, 3, 4)), ch

    parity(case, sort=False)


def test_concat_substr():
    def case(p):
        ch, fts = str_chunk(p, ["ab", "xyz", "", None, "long-ish value"])
        T, f, lit, C1 = p.T, p.X.func, p.X.lit, p.X.col(1, fts[1])
        VC, LL = T.new_varchar(16), T.new_longlong()
        proj = p.E.Projection((
            f("concat", T.new_varchar(40), C1, lit("-", T.new_varchar(1)), C1),
            f("substr", VC, C1, lit(2, LL)),
            f("substr", VC, C1, lit(2, LL), lit(3, LL)),
            f("substr", VC, C1, lit(-3, LL)),
        ))
        return p.E.DAGRequest((scan2(p, fts), proj), output_offsets=(0, 1, 2, 3)), ch

    parity(case, sort=False)


def test_replace_falls_back_to_oracle():
    """replace() is host-only in both packages: run_dag_on_chunks answers
    from the oracle."""
    ch, fts = str_chunk(P, ["aXbXc", "nope", None])
    VC = TT.new_varchar(16)
    proj = TE.Projection((TX.func("replace", VC, TX.col(1, fts[1]), TX.lit("X", VC), TX.lit("-", VC)),))
    dag = TE.DAGRequest((scan2(P, fts), proj), output_offsets=(0,))
    with pytest.raises(NotImplementedError):
        run_dag_on_chunk(dag, ch, device="cpu")
    out = run_dag_on_chunks(dag, [ch], device="cpu")
    assert [r[0].val for r in out.rows()] == ["a-b-c", "nope", None]


def ci_chunk(p, vals):
    T = p.T
    ci = T.FieldType(T.TypeCode.Varchar, flen=16, collate=T.Collation.Utf8MB4GeneralCI)
    fts = [T.new_longlong(), ci]
    rows = [[T.Datum.i64(i), T.Datum.string(v)] for i, v in enumerate(vals)]
    return p.C.Chunk.from_rows(fts, rows), fts


def test_ci_compare_and_group():
    words = ["Apple", "APPLE", "apple", "Banana", "banana", "cherry"]

    def select(p):
        ch, fts = ci_chunk(p, words)
        BOOL = p.T.new_longlong(notnull=True)
        sel = p.E.Selection((p.X.func("eq", BOOL, p.X.col(1, fts[1]), p.X.lit("apple", p.T.new_varchar(8))),))
        return p.E.DAGRequest((scan2(p, fts), sel), output_offsets=(0,)), ch

    assert parity(select).num_rows() == 3

    def group(p):
        ch, fts = ci_chunk(p, words)
        agg = p.E.Aggregation(group_by=(p.X.col(1, fts[1]),), aggs=(p.X.AggDesc("count", ()),))
        return p.E.DAGRequest((scan2(p, fts), agg), output_offsets=(0,)), ch

    assert sorted(r[0].val for r in parity(group).rows()) == [1, 2, 3]


def test_binary_collation_stays_sensitive():
    def case(p):
        T = p.T
        fts = [T.new_longlong(), T.new_varchar(8)]
        ch = p.C.Chunk.from_rows(fts, [[T.Datum.i64(i), T.Datum.string(v)] for i, v in enumerate(["a", "A"])])
        BOOL = T.new_longlong(notnull=True)
        sel = p.E.Selection((p.X.func("eq", BOOL, p.X.col(1, fts[1]), p.X.lit("a", T.new_varchar(1))),))
        return p.E.DAGRequest((scan2(p, fts), sel), output_offsets=(0,)), ch

    assert parity(case).num_rows() == 1


def date_chunk(p):
    T = p.T
    fts = [T.new_datetime()]
    dates = [(2020, 1, 31), (2019, 12, 31), (2020, 2, 29), (1999, 6, 15), (2024, 3, 1)]
    return p.C.Chunk.from_rows(fts, [[T.Datum.time(T.MyTime.from_ymd(y, m, d))] for y, m, d in dates]), fts


def date_dag(p, fts, proj):
    return p.E.DAGRequest((p.E.TableScan(1, (p.E.ColumnInfo(1, fts[0]),)), p.E.Projection(proj)), output_offsets=(0,))


def date_add_case(unit, n):
    def case(p):
        ch, fts = date_chunk(p)
        T, f, lit = p.T, p.X.func, p.X.lit
        e = f("date_add", T.new_datetime(), p.X.col(0, fts[0]), lit(n, T.new_longlong()), lit(unit, T.new_varchar(8)))
        return date_dag(p, fts, (e,)), ch

    return case


@pytest.mark.parametrize("unit,n", [("day", 40), ("day", -60), ("month", 1), ("month", -13), ("year", 1),
                                    ("week", 3), ("hour", 30), ("quarter", 5)])
def test_date_add_units(unit, n):
    parity(date_add_case(unit, n), sort=False)


def test_month_end_clamp():
    """'2020-01-31' + 1 month = '2020-02-29' (leap clamp)."""
    dev = parity(date_add_case("month", 1), sort=False)
    assert str(dev.row(0)[0].val).startswith("2020-02-29")


def test_datediff():
    def case(p):
        ch, fts = date_chunk(p)
        T = p.T
        e = p.X.func("datediff", T.new_longlong(), p.X.col(0, fts[0]), p.X.lit("2020-01-01", T.new_datetime()))
        return date_dag(p, fts, (e,)), ch

    assert parity(case, sort=False).row(0)[0].val == 30  # 2020-01-31 vs 2020-01-01


def test_device_like_ci():
    def case(p):
        ch, fts = ci_chunk(p, ["Apple", "apple", "grape"])
        BOOL = p.T.new_longlong(notnull=True)
        sel = p.E.Selection((p.X.func("like", BOOL, p.X.col(1, fts[1]), p.X.lit("app%", p.T.new_varchar(4))),))
        return p.E.DAGRequest((scan2(p, fts), sel), output_offsets=(0,)), ch

    assert parity(case).num_rows() == 2


def test_substr_null_pos():
    def case(p):
        T = p.T
        fts = [T.new_varchar(8), T.new_longlong()]
        rows = [[T.Datum.string("hello"), T.Datum.NULL], [T.Datum.string("hello"), T.Datum.i64(2)]]
        ch = p.C.Chunk.from_rows(fts, rows)
        e = p.X.func("substr", T.new_varchar(16), p.X.col(0, fts[0]), p.X.col(1, fts[1]))
        return p.E.DAGRequest((scan2(p, fts), p.E.Projection((e,))), output_offsets=(0,)), ch

    assert parity(case, sort=False).row(0)[0].is_null()


# ---------------------------------------------------------------------------
# tests/test_expr.py: device vs the row oracle, value by value
# ---------------------------------------------------------------------------

def random_chunk(p, n=96):
    """test_expr.py's random_chunk (seed 7): int a, uint b, double c,
    decimal(12,2) d, varchar e, datetime f, int g (small)."""
    T = p.T
    rng = np.random.default_rng(7)
    fts = [T.new_longlong(), T.new_longlong(unsigned=True), T.new_double(), T.new_decimal(12, 2),
           T.new_varchar(12), T.new_datetime(), T.new_longlong()]
    words = ["apple", "pear", "fig", "kiwi", "banana", "plum", ""]
    D = T.Datum
    rows = []
    for _ in range(n):
        def maybe(d, p_=0.15):
            return D.NULL if rng.random() < p_ else d

        y, m, dd = 1992 + int(rng.integers(8)), 1 + int(rng.integers(12)), 1 + int(rng.integers(28))
        rows.append([
            maybe(D.i64(int(rng.integers(-1000, 1000)))),
            maybe(D.u64(int(rng.integers(0, 2 ** 62)) * 3)),
            maybe(D.f64(float(np.round(rng.normal() * 100, 3)))),
            maybe(D.dec(T.MyDecimal(f"{rng.integers(-99999, 99999) / 100:.2f}"))),
            maybe(D.string(words[int(rng.integers(len(words)))])),
            maybe(D.time(T.MyTime.from_ymd(y, m, dd, int(rng.integers(24)), int(rng.integers(60)),
                                           int(rng.integers(60))))),
            maybe(D.i64(int(rng.integers(-5, 5)))),
        ])
    return p.C.Chunk.from_rows(fts, rows), fts


def casts_and_math(p, C):
    T, f, lit = p.T, p.X.func, p.X.lit
    a, c, d = C(0), C(2), C(3)
    dec, LL, DBL = T.new_decimal, T.new_longlong(), T.new_double()
    return [f("cast", DBL, a), f("cast", dec(20, 3), a), f("cast", DBL, d), f("cast", LL, d), f("cast", dec(20, 2), c),
            f("ceil", LL, d), f("floor", LL, d), f("round", dec(12, 0), d), f("round", DBL, c, lit(1, LL)),
            f("sign", LL, a)]


def strings_and_time(p, C):
    T, f, lit = p.T, p.X.func, p.X.lit
    s, t = C(4), C(5)
    LL, BOOL, VC = T.new_longlong(), T.new_longlong(notnull=True), T.new_varchar
    return [f("length", LL, s), f("strcmp", LL, s, lit("pear", VC(8))), f("like", BOOL, s, lit("p%", VC(4))),
            f("like", BOOL, s, lit("fig", VC(4)))] + [f(op, LL, t) for op in (
                "year", "month", "day", "hour", "minute", "second", "to_days", "weekday")]


def bitops(p, C):
    f, ub = p.X.func, p.T.new_longlong(unsigned=True)
    a, g = C(0), C(6)
    return [f("bitand", ub, a, g), f("bitor", ub, a, g), f("bitxor", ub, a, g), f("bitneg", ub, a)]


def same_value(ft, got, want, dec_ulp: int) -> bool:
    """The reference's check_parity, one value: reals to 1e-12 relative
    (1e-9 absolute), decimals exact or within dec_ulp units of the scale."""
    if want.is_null() or got.is_null():
        return want.is_null() and got.is_null()
    et = ft.eval_type()
    if et == "real":
        return got.val == pytest.approx(float(want.val), abs=1e-9, rel=1e-12)
    if et == "decimal":
        s = max(ft.decimal, 0)
        return abs(got.val.to_scaled_int(s) - want.val.to_scaled_int(s)) <= dec_ulp
    return datum_group_key(got) == datum_group_key(want)


@pytest.mark.parametrize("exprs,dec_ulp", [(casts_and_math, 1), (strings_and_time, 0), (bitops, 0)],
                         ids=["casts_and_math", "strings_and_time", "bitops"])
def test_expr_device_vs_oracle(exprs, dec_ulp):
    def case(p):
        ch, fts = random_chunk(p)
        es = exprs(p, lambda i: p.X.col(i, fts[i]))
        scan = p.E.TableScan(1, tuple(p.E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
        return p.E.DAGRequest((scan, p.E.Projection(tuple(es))), output_offsets=tuple(range(len(es)))), ch

    jdag, jch = case(J)
    tdag, tch = case(P)
    dev = run_dag_on_chunk(tdag, tch, device="cpu")
    same_rows(keyed(dev.rows()), keyed(j_run_one(jdag, jch).rows()))
    fts = tdag.output_fts()
    for got_row, want_row in zip(dev.rows(), run_dag_reference(tdag, [tch]), strict=True):
        for ft, got, want in zip(fts, got_row, want_row, strict=True):
            assert same_value(ft, got, want, dec_ulp), (ft, got, want)


# ---------------------------------------------------------------------------
# the expression statements through a port store
# ---------------------------------------------------------------------------

N_CUST = 1536       # three customer regions of 512 rows
N_LINE = 1536       # three lineitem regions of 512 rows
LINE_FTS = [TT.new_longlong(notnull=True)] + [W._notnull(TT, ft) for ft in (
    TT.new_decimal(15, 2), TT.new_decimal(15, 2), TT.new_datetime(), TT.new_decimal(15, 2))]
LINE_NAMES = ("okey", "price", "disc", "shipdate", "qty")
HINTS = {"q22_cntry": 7, "year": 7}


@pytest.fixture(scope="module")
def store():
    ct, lt = W.store_customer(N_CUST, seed=2), W.store_lineitem(N_LINE, 256, seed=2)
    s = TStore(device="cpu")
    ts = s.next_ts()
    s.bulk_ingest(W.store_items(TCodec, W.store_rows(TT, lt)), ts)
    s.bulk_ingest(W.customer_items(TCodec, W.customer_rows(TT, ct)), ts)
    for tid, n in ((W.LINEITEM_TABLE_ID, N_LINE), (W.CUSTOMER_TABLE_ID, N_CUST)):
        s.cluster.split(TCodec.record_prefix(tid))
        for h in range(n // 3, n, n // 3):
            s.cluster.split(TCodec.encode_row_key(tid, h))
    whole = {
        W.CUSTOMER_TABLE_ID: W.make_chunk(TC, W.customer_fts(TT), W.customer_columns(ct)),
        W.LINEITEM_TABLE_ID: W.make_chunk(TC, LINE_FTS, [W.fixed_col(lt[k]) for k in LINE_NAMES]),
    }
    return s, whole


def table_chunk(whole, dag):
    """The scan's columns of the whole table, as one chunk (for the oracle)."""
    scan = dag.executors[0]
    ch = whole[scan.table_id]
    if scan.table_id == W.CUSTOMER_TABLE_ID:
        idx = [c.col_id - 1 for c in scan.columns]
    else:
        idx = [LINE_NAMES.index(W.LINEITEM_COLUMNS[c.col_id - 1]) for c in scan.columns]
    return TC.Chunk([ch.columns[i] for i in idx])


def table_regions(s, tid):
    (rng,) = TD.full_table_ranges(tid)
    return [r for r in s.cluster.regions() if r.start_key < rng.end and (not r.end_key or r.end_key > rng.start)]


def close_rows(got, want):
    """Rows equal, reals to 1e-9 relative (the merge order fixes a float
    sum), in a fixed order."""
    same_rows(sorted(keyed(got), key=repr), sorted(keyed(want), key=repr), rel=1e-9)


STATEMENTS = ("q22_cntry", "year", "text", "numeric")


@pytest.mark.parametrize("name", STATEMENTS)
def test_push_half_batched_equals_single_lane_by_lane(name, store):
    s, _ = store
    dag = W.store_expr_statements(TE, TX, TT)[name]
    plan = TD.split_dag(dag)
    tid = dag.executors[0].table_id
    ts = s.next_ts()
    ranges = TD.full_table_ranges(tid)
    regions = table_regions(s, tid)
    assert len(regions) == 3
    reqs = [TReq(plan.push_dag, ranges, ts, r.region_id, r.epoch, small_groups=HINTS.get(name)) for r in regions]
    before = s.stats()
    s.clear_result_cache()
    batched = s.batch_coprocessor(reqs)
    s.clear_result_cache()
    single = [s.coprocessor(r) for r in reqs]
    st = s.stats()
    assert st["batch_fallbacks"] == before["batch_fallbacks"]
    assert st["oracle_fallbacks"] == before["oracle_fallbacks"]
    assert all(r.other_error is None and r.batched > 0 for r in batched)
    for b, o in zip(batched, single, strict=True):
        assert o.other_error is None and o.batched == 0
        assert keyed(b.chunk.rows()) == keyed(o.chunk.rows())


@pytest.mark.parametrize("name", STATEMENTS)
def test_statement_through_execute_root_equals_the_oracle(name, store):
    s, whole = store
    dag = W.store_expr_statements(TE, TX, TT)[name]
    want = run_dag_reference(dag, [table_chunk(whole, dag)])
    ranges = TD.full_table_ranges(dag.executors[0].table_id)
    before = s.stats()
    for tier in ({"concurrency": 1}, {"batch_cop": True}):
        s.clear_result_cache()
        got = TD.execute_root(s, dag, ranges, s.next_ts(), small_groups=HINTS.get(name), **tier)
        close_rows(got.rows(), want)
    st = s.stats()
    assert all(st[k] == before[k] for k in ("oracle_fallbacks", "other_errors", "batch_fallbacks"))


# ---------------------------------------------------------------------------
# types/mytime.py on tensors
# ---------------------------------------------------------------------------

def test_mytime_helpers_on_int64_tensors_equal_python_ints():
    """The calendar helpers run on int64 lanes in the date ops and on
    Python ints in the oracle: the same answers, leap years, centuries and
    negative days included."""
    rng = np.random.default_rng(5)
    y = np.concatenate([rng.integers(1, 9999, 200), [1900, 2000, 2100, 2020, 2019, 1970, 1969, 1]])
    m = np.concatenate([rng.integers(1, 13, 200), [2, 2, 2, 2, 2, 1, 12, 1]])
    d = np.concatenate([rng.integers(1, 29, 200), [28, 29, 28, 29, 28, 1, 31, 1]])
    months = rng.integers(-400, 400, len(y))
    ty, tm, td, tk = (torch.tensor(a, dtype=torch.int64) for a in (y, m, d, months))
    days = mytime.days_from_civil(ty, tm, td)
    assert days.dtype == torch.int64
    assert days.tolist() == [mytime.days_from_civil(*v) for v in zip(y.tolist(), m.tolist(), d.tolist())]
    back = mytime.civil_from_days(days)
    assert [x.tolist() for x in back] == [y.tolist(), m.tolist(), d.tolist()]
    assert [tuple(v) for v in zip(*(x.tolist() for x in back))] == [mytime.civil_from_days(v) for v in days.tolist()]
    assert mytime.days_in_month(ty, tm).tolist() == [mytime.days_in_month(*v) for v in zip(y.tolist(), m.tolist())]
    got = mytime.add_months(ty, tm, td + 3, tk)
    want = [mytime.add_months(*v) for v in zip(y.tolist(), m.tolist(), (d + 3).tolist(), months.tolist())]
    assert [tuple(v) for v in zip(*(x.tolist() for x in got))] == want
