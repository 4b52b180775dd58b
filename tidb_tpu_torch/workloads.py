"""TPC-H-shaped coprocessor workloads: the Q6, Q1, scalar-agg, TopN and Q3
DAGs, the join bench's lineitem x orders DAG, a full Sort and a window DAG
over lineitem, and their generated columns (the DAG makers of the JAX
package's bench.py, with its random draws in its order, so both packages
get identical batches). The store workloads at the end put one lineitem
table into a store (TPUStore) as rowcodec rows and scan it from the same
DAGs, with the join build sides travelling as the request's aux chunks;
a TPC-H customer table beside it carries the statements whose expressions
use the math, bit, string and date families (store_expr_statements).

Each DAG builder takes the package's `exec`, `expr` and `types` modules as
arguments, so one definition builds the same DAG in this port and in the
JAX package (the parity tests build both); nothing here imports either
package. Columns are numpy, made from a seed, in the DeviceBatch numpy form
(data, null, length | None) that interop.device_batch_from_numpy takes.
"""

from __future__ import annotations

import numpy as np


def make_tables(n: int, seed: int = 0) -> dict:
    """Columnar TPC-H lineitem-shaped arrays (bench.py _make_tables)."""
    rng = np.random.default_rng(seed)
    year = rng.integers(1992, 1999, n)
    month = rng.integers(1, 13, n)
    day = rng.integers(1, 29, n)
    ymd = (year * 13 + month) << 5 | day
    shipdate = (ymd << 17) << 24  # packed datetime (types/mytime.py layout)
    return {
        "shipdate": shipdate.astype(np.int64),
        "qty": (rng.integers(1, 51, n) * 100).astype(np.int64),  # dec(15,2)
        "price": rng.integers(90000, 9000000, n).astype(np.int64),  # cents
        "disc": rng.integers(0, 11, n).astype(np.int64),  # dec(15,2) 0.00-0.10
        "rflag": rng.integers(0, 3, n).astype(np.uint8),  # A/N/R
        "lstat": rng.integers(0, 2, n).astype(np.uint8),  # O/F
    }


def fixed_col(a: np.ndarray):
    return (a, np.zeros(len(a), bool), None)


def str_col(codes: np.ndarray, alphabet: bytes):
    """One-byte string column: code k -> alphabet[k]."""
    data = np.frombuffer(alphabet, np.uint8)[codes][:, None]
    return (data, np.zeros(len(codes), bool), np.ones(len(codes), np.int32))


def make_chunk(chunk_mod, fts, cols):
    """Host Chunk of the package `chunk_mod` over numpy columns in the
    (data, null, length | None) form; strings take length bytes of data."""
    out = []
    for (data, null, length), ft in zip(cols, fts):
        if length is None:
            out.append(chunk_mod.Column(ft, np.asarray(data), np.asarray(null, bool)))
            continue
        offs = np.zeros(len(length) + 1, np.int64)
        np.cumsum(length, out=offs[1:])
        blob = np.concatenate([data[i, : length[i]] for i in range(len(length))]) if len(length) else np.zeros(0, np.uint8)
        out.append(chunk_mod.Column(ft, None, np.asarray(null, bool), offs, blob.astype(np.uint8)))
    return chunk_mod.Chunk(out)


def scalar_agg_dag(exec_mod, expr_mod, types_mod, threshold: str = "120.00"):
    """SELECT count(*), sum(qty), avg(qty) WHERE qty > threshold (bench.py
    uses 120.00, which no generated row passes)."""
    D15 = types_mod.new_decimal(15, 2)
    BOOL = types_mod.new_longlong(notnull=True)
    scan = exec_mod.TableScan(1, (exec_mod.ColumnInfo(1, D15),))
    c = expr_mod.col(0, D15)
    sel = exec_mod.Selection((expr_mod.func("gt", BOOL, c, expr_mod.lit(threshold, types_mod.new_decimal(6, 2))),))
    AggDesc = expr_mod.AggDesc
    agg = exec_mod.Aggregation(group_by=(), aggs=(AggDesc("count", ()), AggDesc("sum", (c,)), AggDesc("avg", (c,))))
    return exec_mod.DAGRequest((scan, sel, agg), output_offsets=(0, 1, 2)), [D15]


def scalar_agg_columns(t: dict) -> list:
    return [fixed_col(t["qty"])]


def q6_dag(exec_mod, expr_mod, types_mod):
    """TPC-H Q6: fused date/discount/quantity filter + sum(price*disc)."""
    T = types_mod
    BOOL = T.new_longlong(notnull=True)
    DT, D15 = T.new_datetime(), T.new_decimal(15, 2)
    fts = [DT, D15, D15, D15]  # shipdate, qty, price, disc
    func, lit = expr_mod.func, expr_mod.lit
    scan = exec_mod.TableScan(1, tuple(exec_mod.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))

    def C(i):
        return expr_mod.col(i, fts[i])

    pred = func(
        "and", BOOL,
        func("ge", BOOL, C(0), lit("1994-01-01", DT)),
        func(
            "and", BOOL,
            func("lt", BOOL, C(0), lit("1995-01-01", DT)),
            func(
                "and", BOOL,
                func("between", BOOL, C(3), lit("0.05", T.new_decimal(3, 2)), lit("0.07", T.new_decimal(3, 2))),
                func("lt", BOOL, C(1), lit(24, T.new_longlong())),
            ),
        ),
    )
    revenue = func("mul", T.new_decimal(31, 4), C(2), C(3))
    AggDesc = expr_mod.AggDesc
    agg = exec_mod.Aggregation(group_by=(), aggs=(AggDesc("sum", (revenue,)), AggDesc("count", ())))
    return exec_mod.DAGRequest((scan, exec_mod.Selection((pred,)), agg), output_offsets=(0, 1)), fts


def q6_columns(t: dict) -> list:
    return [fixed_col(t["shipdate"]), fixed_col(t["qty"]), fixed_col(t["price"]), fixed_col(t["disc"])]


def q1_dag(exec_mod, expr_mod, types_mod):
    """TPC-H Q1: GROUP BY (returnflag, linestatus), six aggregates."""
    T = types_mod
    BOOL = T.new_longlong(notnull=True)
    DT, D15, V1 = T.new_datetime(), T.new_decimal(15, 2), T.new_varchar(1)
    fts = [V1, V1, D15, D15, D15, DT]  # rflag, lstat, qty, price, disc, shipdate
    func, lit = expr_mod.func, expr_mod.lit
    scan = exec_mod.TableScan(2, tuple(exec_mod.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))

    def C(i):
        return expr_mod.col(i, fts[i])

    sel = exec_mod.Selection((func("le", BOOL, C(5), lit("1998-09-02", DT)),))
    disc_price = func("mul", T.new_decimal(31, 4), C(3), func("minus", T.new_decimal(16, 2), lit(1, T.new_longlong()), C(4)))
    AggDesc = expr_mod.AggDesc
    agg = exec_mod.Aggregation(
        group_by=(C(0), C(1)),
        aggs=(
            AggDesc("sum", (C(2),)),
            AggDesc("sum", (C(3),)),
            AggDesc("sum", (disc_price,)),
            AggDesc("avg", (C(2),)),
            AggDesc("avg", (C(4),)),
            AggDesc("count", ()),
        ),
    )
    return exec_mod.DAGRequest((scan, sel, agg), output_offsets=tuple(range(8))), fts


def q1_columns(t: dict) -> list:
    return [str_col(t["rflag"], b"ANR"), str_col(t["lstat"], b"OF"),
            fixed_col(t["qty"]), fixed_col(t["price"]), fixed_col(t["disc"]), fixed_col(t["shipdate"])]


def _order_by(expr_mod, types_mod):
    """ORDER BY price DESC, shipdate over a (price D15, shipdate DT) scan."""
    D15, DT = types_mod.new_decimal(15, 2), types_mod.new_datetime()
    return ((expr_mod.col(0, D15), True), (expr_mod.col(1, DT), False)), [D15, DT]


def topn_dag(exec_mod, expr_mod, types_mod, limit: int = 100):
    """bench.py's topn config (BASELINE config 4): SELECT price, shipdate
    ORDER BY price DESC, shipdate LIMIT 100, the TopN executor."""
    E = exec_mod
    order_by, fts = _order_by(expr_mod, types_mod)
    scan = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    return E.DAGRequest((scan, E.TopN(order_by=order_by, limit=limit)), output_offsets=(0, 1)), fts


def topn_columns(t: dict) -> list:
    return [fixed_col(t["price"]), fixed_col(t["shipdate"])]


def sort_dag(exec_mod, expr_mod, types_mod):
    """topn_dag's keys with no limit: the Sort executor, every row back in
    ORDER BY order."""
    E = exec_mod
    order_by, fts = _order_by(expr_mod, types_mod)
    scan = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    return E.DAGRequest((scan, E.Sort(order_by=order_by)), output_offsets=(0, 1)), fts


def _notnull(types_mod, ft):
    f = ft.clone()
    f.flag |= types_mod.Flag.NotNull
    return f


def q3_dag(exec_mod, expr_mod, types_mod):
    """TPC-H Q3's join+aggregate core (bench.py q3): lineitem JOIN (orders
    JOIN customer), orders dated before 1995-03-15, customers of segment
    'B', lineitems shipped after 1995-03-15, GROUP BY l_orderkey,
    sum(price * (1 - disc)). Both build sides are primary keys (unique);
    TPC-H declares every column NOT NULL. Returns (dag, [lineitem, orders,
    customer field types]) — the scans in canonical order."""
    T, E = types_mod, exec_mod
    func, lit, col = expr_mod.func, expr_mod.lit, expr_mod.col
    BOOL = T.new_longlong(notnull=True)
    LL = T.new_longlong(notnull=True)
    DT, D15, V1 = T.new_datetime(), T.new_decimal(15, 2), T.new_varchar(1)
    lfts = [LL, _notnull(T, D15), _notnull(T, D15), _notnull(T, DT)]  # okey, price, disc, shipdate
    ofts = [LL, LL, _notnull(T, DT)]                                   # okey, custkey, orderdate
    cfts = [LL, _notnull(T, V1)]                                       # custkey, segment
    ls = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(lfts)))
    os_ = E.TableScan(2, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(ofts)))
    cs = E.TableScan(3, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(cfts)))
    cust_sel = E.Selection((func("eq", BOOL, col(1, cfts[1]), lit("B", V1)),))
    inner = E.Join(build=(cs, cust_sel), probe_keys=(col(1, ofts[1]),), build_keys=(col(0, cfts[0]),),
                   join_type="inner", build_unique=True)
    odate_sel = E.Selection((func("lt", BOOL, col(2, ofts[2]), lit("1995-03-15", DT)),))
    outer = E.Join(build=(os_, odate_sel, inner), probe_keys=(col(0, lfts[0]),), build_keys=(col(0, ofts[0]),),
                   join_type="inner", build_unique=True)
    lsel = E.Selection((func("gt", BOOL, col(3, lfts[3]), lit("1995-03-15", DT)),))
    post = lfts + ofts + cfts
    revenue = func("mul", T.new_decimal(31, 4), col(1, post[1]),
                   func("minus", T.new_decimal(16, 2), lit(1, T.new_longlong()), col(2, post[2])))
    agg = E.Aggregation(group_by=(col(0, post[0]),), aggs=(expr_mod.AggDesc("sum", (revenue,)),))
    return E.DAGRequest((ls, lsel, outer, agg), output_offsets=(0, 1)), [lfts, ofts, cfts]


def q3_columns(n: int, seed: int = 0) -> list:
    """Q3's per-scan column lists (lineitem, orders, customer) at n
    lineitem rows (bench.py q3): n // 8 orders, n // 32 customers,
    l_orderkey uniform over the orders, segment codes into b"BAS"."""
    no, nc = max(n // 8, 16), max(n // 32, 8)
    t = make_tables(n, seed)
    rng = np.random.default_rng(seed + 1)
    okey = rng.integers(0, no, n).astype(np.int64)
    custkey = rng.integers(0, nc, no).astype(np.int64)
    odate = make_tables(no, seed + 2)["shipdate"]
    segment = rng.integers(0, 3, nc)
    return [
        [fixed_col(okey), fixed_col(t["price"]), fixed_col(t["disc"]), fixed_col(t["shipdate"])],
        [fixed_col(np.arange(no, dtype=np.int64)), fixed_col(custkey), fixed_col(odate)],
        [fixed_col(np.arange(nc, dtype=np.int64)), str_col(segment, b"BAS")],
    ]


def join_bench_dag(exec_mod, expr_mod, types_mod, groups: int | None = None, v_ft=None):
    """The join bench's DAG (bench.py BENCH_JOIN): lineitem(okey, v) JOIN
    orders(okey, payload) on okey, unique build, feeding sum(v), count(*) —
    scalar, or grouped by the build payload when `groups` is set. The
    aggregate's arguments are not the probe key, so the join is not fused
    with it. v is a NOT NULL bigint unless `v_ft` says otherwise. Returns
    (dag, [lineitem, orders field types])."""
    E, X = exec_mod, expr_mod
    LL = types_mod.new_longlong(notnull=True)
    VT = v_ft or LL
    ls = E.TableScan(1, (E.ColumnInfo(1, LL), E.ColumnInfo(2, VT)))
    os_ = E.TableScan(2, (E.ColumnInfo(1, LL), E.ColumnInfo(2, LL)))
    join = E.Join(build=(os_,), probe_keys=(X.col(0, LL),), build_keys=(X.col(0, LL),),
                  join_type="inner", build_unique=True)
    aggs = (X.AggDesc("sum", (X.col(1, VT),)), X.AggDesc("count", ()))
    if groups is None:
        agg = E.Aggregation(group_by=(), aggs=aggs)
        offsets = (0, 1)
    else:
        agg = E.Aggregation(group_by=(X.col(3, LL),), aggs=aggs)
        offsets = (0, 1, 2)
    return E.DAGRequest((ls, join, agg), output_offsets=offsets), [[LL, VT], [LL, LL]]


def join_bench_columns(n: int, ratio: int, skewed: bool, groups: int | None = None, seed: int = 7) -> list:
    """The join bench's per-scan column lists (lineitem, orders) (bench.py
    BENCH_JOIN make): n lineitem rows over n // ratio orders; `skewed`
    puts 40% of the probes on one key; the payload takes `groups` values
    (64 when None)."""
    rng = np.random.default_rng(seed)
    nb = max(n // ratio, 16)
    okey = rng.integers(0, nb, n).astype(np.int64)
    if skewed:
        hot = rng.random(n) < 0.4
        okey = np.where(hot, np.int64(nb // 2), okey)
    v = rng.integers(0, 1000, n).astype(np.int64)
    payload = rng.integers(0, groups or 64, nb).astype(np.int64)
    return [[fixed_col(okey), fixed_col(v)],
            [fixed_col(np.arange(nb, dtype=np.int64)), fixed_col(payload)]]


def window_dag(exec_mod, expr_mod, types_mod):
    """Ranking lines within an order (the top-N-per-group shape of TPC-DS's
    rank() OVER queries) over Q3's lineitem columns (okey, price, disc,
    shipdate; q3_columns(n)[0]): PARTITION BY okey ORDER BY price DESC,
    shipdate with row_number, rank, dense_rank, sum(price), count(*),
    max(disc), lag(price, 1) and first_value(price). Output: the four
    input columns, then the eight window columns."""
    T, E, X = types_mod, exec_mod, expr_mod
    LL = T.new_longlong(notnull=True)
    D15, DT = _notnull(T, T.new_decimal(15, 2)), _notnull(T, T.new_datetime())
    fts = [LL, D15, D15, DT]
    scan = E.TableScan(1, tuple(E.ColumnInfo(i + 1, ft) for i, ft in enumerate(fts)))
    okey, price, disc, ship = (X.col(i, ft) for i, ft in enumerate(fts))
    WinDesc = E.dag.WinDesc
    funcs = (
        WinDesc("row_number", (), LL),
        WinDesc("rank", (), LL),
        WinDesc("dense_rank", (), LL),
        WinDesc("sum", (price,), X.AggDesc("sum", (price,)).ft),
        WinDesc("count", (), LL),
        WinDesc("max", (disc,), D15.clone_nullable()),
        WinDesc("lag", (price,), D15.clone_nullable(), 1),
        WinDesc("first_value", (price,), D15.clone_nullable()),
    )
    win = E.dag.Window(partition_by=(okey,), order_by=((price, True), (ship, False)), funcs=funcs)
    return E.DAGRequest((scan, win), output_offsets=tuple(range(len(fts) + len(funcs)))), fts


# ---------------------------------------------------------------------------
# the store's lineitem table
# ---------------------------------------------------------------------------

LINEITEM_TABLE_ID = 10
# every column a store DAG scans, in column-id order (ids 1..7)
LINEITEM_COLUMNS = ("okey", "price", "disc", "shipdate", "qty", "rflag", "lstat")
LINEITEM_COL_IDS = {name: i + 1 for i, name in enumerate(LINEITEM_COLUMNS)}


def store_lineitem(n: int, n_orders: int, seed: int = 0) -> dict:
    """The store table's columns at n rows (row i has handle i):
    make_tables' columns, and l_orderkey uniform over n_orders orders as
    q3_columns and join_bench_columns draw it."""
    t = make_tables(n, seed)
    t["okey"] = np.random.default_rng(seed + 1).integers(0, n_orders, n).astype(np.int64)
    return t


def store_rows(types_mod, t: dict, lo: int = 0, hi: int | None = None):
    """Rows lo..hi of the table as (handle, [Datum per LINEITEM_COLUMNS])
    of the package `types_mod`: okey a bigint, price / disc / qty
    DECIMAL(15,2), shipdate a DATETIME, rflag / lstat one-letter strings."""
    T = types_mod
    hi = len(t["okey"]) if hi is None else hi
    dec = T.MyDecimal.from_scaled_int
    i64, d_dec, d_time, d_str = T.Datum.i64, T.Datum.dec, T.Datum.time, T.Datum.string
    rflag, lstat = "ANR", "OF"
    cols = [t[k][lo:hi].tolist() for k in LINEITEM_COLUMNS]
    for j, (okey, price, disc, ship, qty, rf, ls) in enumerate(zip(*cols)):
        yield lo + j, [i64(okey), d_dec(dec(price, 2)), d_dec(dec(disc, 2)), d_time(T.MyTime(ship, 0)),
                       d_dec(dec(qty, 2)), d_str(rflag[rf]), d_str(lstat[ls])]


def store_items(codec_mod, rows, table_id: int = LINEITEM_TABLE_ID, col_ids=None):
    """(row key, rowcodec value) pairs of `rows` from store_rows (or, with
    the customer table's id and column ids, customer_rows), encoded by the
    package `codec_mod` (for a store's bulk_ingest)."""
    enc = codec_mod.RowEncoder()
    col_ids = [LINEITEM_COL_IDS[k] for k in LINEITEM_COLUMNS] if col_ids is None else list(col_ids)
    return [(codec_mod.encode_row_key(table_id, h), enc.encode(col_ids, datums)) for h, datums in rows]


def store_scan(exec_mod, dag, names, table_id: int = LINEITEM_TABLE_ID):
    """`dag` with its probe TableScan reading the store table: the same
    column types, the table's id and the ids of the columns `names`."""
    import dataclasses

    scan = dag.executors[0]
    cols = tuple(exec_mod.ColumnInfo(LINEITEM_COL_IDS[nm], c.ft) for nm, c in zip(names, scan.columns))
    return dataclasses.replace(dag, executors=(dataclasses.replace(scan, table_id=table_id, columns=cols),)
                               + tuple(dag.executors[1:]))


def store_dags(exec_mod, expr_mod, types_mod, topn_limit: int = 100) -> dict:
    """name -> (DAG over the store table, [field types of each aux scan]):
    Q6, Q1, TopN, Q3 (orders and customer as aux), the join bench (orders
    as aux; v is l_extendedprice), Sort and the window DAG."""
    E, X, T = exec_mod, expr_mod, types_mod
    out = {}
    dag, _ = q6_dag(E, X, T)
    out["q6"] = (store_scan(E, dag, ("shipdate", "qty", "price", "disc")), [])
    dag, _ = q1_dag(E, X, T)
    out["q1"] = (store_scan(E, dag, ("rflag", "lstat", "qty", "price", "disc", "shipdate")), [])
    dag, _ = topn_dag(E, X, T, limit=topn_limit)
    out["topn"] = (store_scan(E, dag, ("price", "shipdate")), [])
    dag, (_l, ofts, cfts) = q3_dag(E, X, T)
    out["q3"] = (store_scan(E, dag, ("okey", "price", "disc", "shipdate")), [ofts, cfts])
    dag, (_l, ofts) = join_bench_dag(E, X, T, v_ft=_notnull(T, T.new_decimal(15, 2)))
    out["join"] = (store_scan(E, dag, ("okey", "price")), [ofts])
    dag, _ = sort_dag(E, X, T)
    out["sort"] = (store_scan(E, dag, ("price", "shipdate")), [])
    dag, _ = window_dag(E, X, T)
    out["window"] = (store_scan(E, dag, ("okey", "price", "disc", "shipdate")), [])
    return out


def store_statements(exec_mod, expr_mod, types_mod) -> dict:
    """name -> a Complete-mode statement over the store table, whose root
    half runs at the root after distsql/root.py split_dag:

      q1, q6           store_dags' Q1 and Q6 (Partial1 on the regions, then a
                       Final merge at the root)
      bit              GROUP BY l_returnflag, l_linestatus: BIT_AND, BIT_OR,
                       BIT_XOR(l_orderkey), COUNT(*) (bit states merged)
      distinct         GROUP BY l_returnflag, l_linestatus: COUNT(DISTINCT
                       l_orderkey), SUM(DISTINCT l_quantity), AVG(DISTINCT
                       l_discount), COUNT(*) (not decomposable: a plain scan
                       on the regions, the whole aggregation at the root)
      distinct_scalar  COUNT(DISTINCT l_orderkey)
      okey             GROUP BY l_orderkey: SUM(l_extendedprice * (1 -
                       l_discount)), COUNT(*) (a Final merge of ~ a group a
                       row)"""
    E, X, T = exec_mod, expr_mod, types_mod
    dags = store_dags(E, X, T)
    LL, D15, V1 = T.new_longlong(notnull=True), T.new_decimal(15, 2), T.new_varchar(1)
    A = X.AggDesc

    def scan(names, fts):
        cols = tuple(E.ColumnInfo(LINEITEM_COL_IDS[nm], ft) for nm, ft in zip(names, fts))
        return E.TableScan(LINEITEM_TABLE_ID, cols), [X.col(i, ft) for i, ft in enumerate(fts)]

    def statement(sc, group_by, aggs):
        agg = E.Aggregation(group_by=tuple(group_by), aggs=tuple(aggs))
        return E.DAGRequest((sc, agg), output_offsets=tuple(range(len(aggs) + len(group_by))))

    out = {"q1": dags["q1"][0], "q6": dags["q6"][0]}
    sc, (rf, ls, okey) = scan(("rflag", "lstat", "okey"), (V1, V1, LL))
    out["bit"] = statement(sc, (rf, ls), (A("bit_and", (okey,)), A("bit_or", (okey,)), A("bit_xor", (okey,)),
                                          A("count", ())))
    sc, (rf, ls, okey, qty, disc) = scan(("rflag", "lstat", "okey", "qty", "disc"), (V1, V1, LL, D15, D15))
    out["distinct"] = statement(sc, (rf, ls), (A("count", (okey,), distinct=True), A("sum", (qty,), distinct=True),
                                               A("avg", (disc,), distinct=True), A("count", ())))
    sc, (okey,) = scan(("okey",), (LL,))
    out["distinct_scalar"] = statement(sc, (), (A("count", (okey,), distinct=True),))
    sc, (okey, price, disc) = scan(("okey", "price", "disc"), (LL, D15, D15))
    one_minus = X.func("minus", T.new_decimal(16, 2), X.lit(1, T.new_longlong()), disc)
    out["okey"] = statement(sc, (okey,), (A("sum", (X.func("mul", T.new_decimal(31, 4), price, one_minus),)),
                                          A("count", ())))
    return out


def store_selection_dag(exec_mod, expr_mod, types_mod):
    """A row-local DAG for paged requests: SELECT okey, price, shipdate
    WHERE shipdate > '1995-03-15' AND disc >= 0.05 over the store table."""
    E, X, T = exec_mod, expr_mod, types_mod
    BOOL = T.new_longlong(notnull=True)
    LL, D15, DT = T.new_longlong(notnull=True), T.new_decimal(15, 2), T.new_datetime()
    scan = E.TableScan(LINEITEM_TABLE_ID, (E.ColumnInfo(LINEITEM_COL_IDS["okey"], LL),
                                           E.ColumnInfo(LINEITEM_COL_IDS["price"], D15),
                                           E.ColumnInfo(LINEITEM_COL_IDS["disc"], D15),
                                           E.ColumnInfo(LINEITEM_COL_IDS["shipdate"], DT)))
    pred = X.func("and", BOOL, X.func("gt", BOOL, X.col(3, DT), X.lit("1995-03-15", DT)),
                  X.func("ge", BOOL, X.col(2, D15), X.lit("0.05", T.new_decimal(3, 2))))
    proj = E.Projection((X.col(0, LL), X.col(1, D15), X.col(3, DT)))
    return E.DAGRequest((scan, E.Selection((pred,)), proj), output_offsets=(0, 1, 2))


def store_q3_build_columns(n_orders: int, n_cust: int, seed: int = 0) -> list:
    """Q3's build sides for the store (orders keyed 0..n_orders-1, with a
    customer and a date each; customers keyed 0..n_cust-1 with a segment
    code into b"BAS"), in q3_columns' form: [orders columns, customer
    columns]."""
    rng = np.random.default_rng(seed + 3)
    custkey = rng.integers(0, n_cust, n_orders).astype(np.int64)
    odate = make_tables(n_orders, seed + 2)["shipdate"]
    segment = rng.integers(0, 3, n_cust)
    return [[fixed_col(np.arange(n_orders, dtype=np.int64)), fixed_col(custkey), fixed_col(odate)],
            [fixed_col(np.arange(n_cust, dtype=np.int64)), str_col(segment, b"BAS")]]


def store_join_build_columns(nb: int, groups: int | None = None, seed: int = 7) -> list:
    """The join bench's build side for the store: orders keyed 0..nb-1 with
    a payload of `groups` values (64 when None), as [orders columns]."""
    payload = np.random.default_rng(seed).integers(0, groups or 64, nb).astype(np.int64)
    return [[fixed_col(np.arange(nb, dtype=np.int64)), fixed_col(payload)]]


# ---------------------------------------------------------------------------
# the store's customer table and the expression statements
# ---------------------------------------------------------------------------

CUSTOMER_TABLE_ID = 11
# TPC-H v3 CUSTOMER (clause 1.4.1), in column-id order (ids 1..8)
CUSTOMER_COLUMNS = ("custkey", "name", "address", "nationkey", "phone", "acctbal", "mktsegment", "comment")
CUSTOMER_COL_IDS = {name: i + 1 for i, name in enumerate(CUSTOMER_COLUMNS)}
CUSTOMER_STRINGS = {"name": 25, "address": 40, "phone": 15, "mktsegment": 10, "comment": 117}
MKT_SEGMENTS = (b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"MACHINERY", b"HOUSEHOLD")
# dbgen's alphanumeric alphabet for random v-strings (clause 4.2.2.7)
_ALPHANUM = b"0123456789abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ,"
# a small vocabulary from dbgen's text grammar (clause 4.2.2.10)
COMMENT_WORDS = (b"furiously", b"carefully", b"quickly", b"slyly", b"blithely", b"final", b"regular",
                 b"express", b"ironic", b"pending", b"special", b"bold", b"even", b"deposits", b"packages",
                 b"accounts", b"requests", b"theodolites", b"instructions", b"foxes", b"ideas", b"pinto",
                 b"beans", b"asymptotes")


def _byte_table(words) -> tuple:
    """(table [len(words), max len] uint8, lengths int64) of byte strings."""
    w = max(len(x) for x in words)
    tab = np.zeros((len(words), w), np.uint8)
    for i, x in enumerate(words):
        tab[i, : len(x)] = np.frombuffer(x, np.uint8)
    return tab, np.array([len(x) for x in words], np.int64)


def _digits(data: np.ndarray, col: int, values: np.ndarray, width: int) -> None:
    """Write `values` as `width` zero-padded ASCII digits at data[:, col:]."""
    for k in range(width):
        data[:, col + k] = 48 + (values // 10 ** (width - 1 - k)) % 10


def store_customer(n: int, seed: int = 0) -> dict:
    """The customer table's columns at n rows (row i has handle i), shaped
    on TPC-H v3 CUSTOMER (clauses 1.4.1 and 4.2.3): c_custkey i + 1;
    c_name "Customer#" and 9 digits; c_address 10-40 random alphanumerics;
    c_nationkey 0-24; c_phone "CC-NNN-NNN-NNNN" with CC = nationkey + 10;
    c_acctbal -999.99..9999.99 (cents); c_mktsegment one of five segments;
    c_comment words of a small vocabulary, 29-116 bytes. Integer columns
    are int64 arrays, c_acctbal int64 cents, each string column a (data
    [n, flen] uint8, length int32) pair."""
    rng = np.random.default_rng(seed + 11)
    custkey = np.arange(1, n + 1, dtype=np.int64)
    name = np.zeros((n, CUSTOMER_STRINGS["name"]), np.uint8)
    name[:, :9] = np.frombuffer(b"Customer#", np.uint8)
    _digits(name, 9, custkey, 9)
    addr_len = rng.integers(10, 41, n).astype(np.int32)
    address = np.frombuffer(_ALPHANUM, np.uint8)[rng.integers(0, len(_ALPHANUM), (n, CUSTOMER_STRINGS["address"]))]
    address = np.where(np.arange(address.shape[1])[None, :] < addr_len[:, None], address, 0).astype(np.uint8)
    nationkey = rng.integers(0, 25, n).astype(np.int64)
    phone = np.full((n, CUSTOMER_STRINGS["phone"]), ord("-"), np.uint8)
    _digits(phone, 0, nationkey + 10, 2)
    _digits(phone, 3, rng.integers(100, 1000, n), 3)
    _digits(phone, 7, rng.integers(100, 1000, n), 3)
    _digits(phone, 11, rng.integers(1000, 10000, n), 4)
    acctbal = rng.integers(-99999, 1000000, n).astype(np.int64)
    seg_tab, seg_len = _byte_table(MKT_SEGMENTS)
    seg = rng.integers(0, len(MKT_SEGMENTS), n)
    mktsegment = seg_tab[seg]
    # the comment: 24 words, each followed by a space (at least 5 bytes a
    # word, so >= 120 bytes), cut to a length of 29-116
    com_len = rng.integers(29, 117, n).astype(np.int32)
    ids = rng.integers(0, len(COMMENT_WORDS), (n, 24))
    word_tab, word_len = _byte_table([w + b" " for w in COMMENT_WORDS])
    cw = CUSTOMER_STRINGS["comment"]
    comment = np.zeros((n, cw), np.uint8)
    for lo in range(0, n, 1 << 16):
        blk = ids[lo : lo + (1 << 16)]
        # the words' bytes in row order, then each row's first cw of them
        flat = word_tab[blk][np.arange(word_tab.shape[1])[None, None, :] < word_len[blk][:, :, None]]
        start = np.concatenate([[0], np.cumsum(word_len[blk].sum(axis=1))[:-1]])
        comment[lo : lo + len(blk)] = flat[start[:, None] + np.arange(cw)[None, :]]
    comment = np.where(np.arange(cw)[None, :] < com_len[:, None], comment, 0).astype(np.uint8)
    return {
        "custkey": custkey, "name": (name, np.full(n, 18, np.int32)), "address": (address, addr_len),
        "nationkey": nationkey, "phone": (phone, np.full(n, 15, np.int32)), "acctbal": acctbal,
        "mktsegment": (mktsegment, seg_len[seg].astype(np.int32)), "comment": (comment, com_len),
    }


def customer_fts(types_mod) -> list:
    """The customer columns' field types (TPC-H declares every column NOT
    NULL; the CHAR(n) columns are VARCHAR(n) holding the bare value, as
    MySQL reads CHAR with its pad spaces removed)."""
    T = types_mod
    LL = T.new_longlong(notnull=True)
    return [LL, _notnull(T, T.new_varchar(25)), _notnull(T, T.new_varchar(40)), LL,
            _notnull(T, T.new_varchar(15)), _notnull(T, T.new_decimal(15, 2)),
            _notnull(T, T.new_varchar(10)), _notnull(T, T.new_varchar(117))]


def customer_columns(t: dict, names=CUSTOMER_COLUMNS) -> list:
    """The columns `names` in the (data, null, length | None) form."""
    out = []
    for k in names:
        v = t[k]
        out.append((v[0], np.zeros(len(v[1]), bool), v[1]) if isinstance(v, tuple) else fixed_col(v))
    return out


def customer_rows(types_mod, t: dict, lo: int = 0, hi: int | None = None):
    """Rows lo..hi of the customer table as (handle, [Datum per
    CUSTOMER_COLUMNS]) of the package `types_mod`."""
    T = types_mod
    hi = len(t["custkey"]) if hi is None else hi
    i64, d_dec, d_str = T.Datum.i64, T.Datum.dec, T.Datum.string
    dec = T.MyDecimal.from_scaled_int

    def strings(k):
        data, length = t[k]
        return [bytes(data[i, : length[i]]).decode() for i in range(lo, hi)]

    name, addr, phone, seg, com = (strings(k) for k in ("name", "address", "phone", "mktsegment", "comment"))
    keys, nations, bal = (t[k][lo:hi].tolist() for k in ("custkey", "nationkey", "acctbal"))
    for j in range(hi - lo):
        yield lo + j, [i64(keys[j]), d_str(name[j]), d_str(addr[j]), i64(nations[j]), d_str(phone[j]),
                       d_dec(dec(bal[j], 2)), d_str(seg[j]), d_str(com[j])]


def customer_items(codec_mod, rows):
    """store_items for customer_rows: the customer table's keys and ids."""
    return store_items(codec_mod, rows, CUSTOMER_TABLE_ID, [CUSTOMER_COL_IDS[k] for k in CUSTOMER_COLUMNS])


def store_expr_statements(exec_mod, expr_mod, types_mod) -> dict:
    """name -> a Complete-mode statement whose expressions use the math,
    bit, string and date families (split by distsql/root.py split_dag, the
    push half on the regions):

      q22_cntry  TPC-H Q22's grouping, without its subqueries, over customer:
                 SELECT SUBSTR(c_phone,1,2) AS cntrycode, COUNT(*),
                 SUM(c_acctbal) WHERE cntrycode IN ('13','31','23','29',
                 '30','18','17') AND c_acctbal > 0.00 GROUP BY cntrycode
                 (seven groups: the small-groups hint 7 takes K1)
      year       TPC-H Q9's grouping over lineitem: EXTRACT(YEAR FROM
                 l_shipdate), SUM(l_extendedprice * (1 - l_discount)),
                 COUNT(*) GROUP BY 1 (seven years: hint 7, K1)
      text       over customer, GROUP BY LOWER(c_mktsegment): COUNT(*), SUM of
                 LENGTH(TRIM / LTRIM / RTRIM(CONCAT('  ', c_name, ' '))),
                 SUM(STRCMP(UPPER(c_address), c_address)), SUM(CAST(SUBSTR(
                 c_phone,1,2) AS DOUBLE)) WHERE (c_mktsegment LIKE 'BUILD%'
                 OR c_comment LIKE 'furiously%' OR c_mktsegment =
                 'MACHINERY') AND SUBSTR(c_phone, 4, 3) (a bare string)
      numeric    over lineitem, one row of scalar aggregates: SUM of CEIL,
                 FLOOR and ROUND of l_extendedprice * (1 - l_discount) and of
                 the negative l_discount - l_extendedprice, SIGN(l_discount -
                 0.05), l_orderkey & 255, | 255, ^ 255, BIT_XOR(~l_orderkey),
                 << 3, >> 2, DATEDIFF(DATE_ADD(l_shipdate, INTERVAL 1 MONTH),
                 l_shipdate), TO_DAYS(DATE_SUB(l_shipdate, INTERVAL 2
                 QUARTER)), MONTH, DAY, HOUR, WEEKDAY(l_shipdate), SQRT, EXP,
                 LN and POW of l_quantity as a double, COUNT(*)"""
    E, X, T = exec_mod, expr_mod, types_mod
    f, lit, A = X.func, X.lit, X.AggDesc
    BOOL, LL, UB, DBL = T.new_longlong(notnull=True), T.new_longlong(), T.new_longlong(unsigned=True), T.new_double()
    VC, DT, dec = T.new_varchar, T.new_datetime(), T.new_decimal
    cfts = customer_fts(T)

    def scan(table_id, col_ids, names, fts):
        ftd = dict(zip(names, fts))
        chosen = [ftd[k] for k in col_ids]
        ids = CUSTOMER_COL_IDS if table_id == CUSTOMER_TABLE_ID else LINEITEM_COL_IDS
        sc = E.TableScan(table_id, tuple(E.ColumnInfo(ids[k], ft) for k, ft in zip(col_ids, chosen)))
        return sc, [X.col(i, ft) for i, ft in enumerate(chosen)]

    def statement(sc, sel, group_by, aggs):
        agg = E.Aggregation(group_by=tuple(group_by), aggs=tuple(aggs))
        execs = (sc,) + ((E.Selection(tuple(sel)),) if sel else ()) + (agg,)
        return E.DAGRequest(execs, output_offsets=tuple(range(len(aggs) + len(group_by))))

    out = {}
    sc, (phone, bal) = scan(CUSTOMER_TABLE_ID, ("phone", "acctbal"), CUSTOMER_COLUMNS, cfts)
    cntry = f("substr", VC(2), phone, lit(1, LL), lit(2, LL))
    codes = [lit(c, VC(2)) for c in ("13", "31", "23", "29", "30", "18", "17")]
    out["q22_cntry"] = statement(sc, (f("in", BOOL, cntry, *codes), f("gt", BOOL, bal, lit("0.00", dec(3, 2)))),
                                 (cntry,), (A("count", ()), A("sum", (bal,))))

    lnames = ("okey", "price", "disc", "shipdate", "qty")
    lfts = (T.new_longlong(notnull=True),) + tuple(_notnull(T, ft) for ft in (dec(15, 2), dec(15, 2), DT, dec(15, 2)))
    sc, (ship, price, disc) = scan(LINEITEM_TABLE_ID, ("shipdate", "price", "disc"), lnames, lfts)
    rev = f("mul", dec(31, 4), price, f("minus", dec(16, 2), lit(1, LL), disc))
    out["year"] = statement(sc, (), (f("extract", LL, lit("YEAR", VC(4)), ship),), (A("sum", (rev,)), A("count", ())))

    sc, (name, addr, phone, seg, com) = scan(CUSTOMER_TABLE_ID, ("name", "address", "phone", "mktsegment", "comment"),
                                             CUSTOMER_COLUMNS, cfts)
    padded = f("concat", VC(28), lit("  ", VC(2)), name, lit(" ", VC(1)))
    where = f("or", BOOL, f("or", BOOL, f("like", BOOL, seg, lit("BUILD%", VC(6))),
                             f("like", BOOL, com, lit("furiously%", VC(10)))),
              f("eq", BOOL, seg, lit("MACHINERY", VC(9))))
    out["text"] = statement(
        sc, (where, f("substr", VC(3), phone, lit(4, LL), lit(3, LL))), (f("lower", VC(10), seg),),
        (A("count", ()),) + tuple(A("sum", (f("length", LL, f(op, VC(28), padded)),)) for op in ("trim", "ltrim", "rtrim"))
        + (A("sum", (f("strcmp", LL, f("upper", VC(40), addr), addr),)),
           A("sum", (f("cast", DBL, f("substr", VC(2), phone, lit(1, LL), lit(2, LL))),))))

    sc, (okey, price, disc, ship, qty) = scan(LINEITEM_TABLE_ID, lnames, lnames, lfts)
    rev = f("mul", dec(31, 4), price, f("minus", dec(16, 2), lit(1, LL), disc))
    neg = f("minus", dec(16, 2), disc, price)
    q = f("cast", DBL, qty)
    bits = [f(op, UB, okey, lit(k, LL)) for op, k in (("bitand", 255), ("bitor", 255), ("bitxor", 255),
                                                      ("shiftleft", 3), ("shiftright", 2))]
    unit = lambda u: lit(u, VC(8))  # noqa: E731
    dates = [f("datediff", LL, f("date_add", DT, ship, lit(1, LL), unit("month")), ship),
             f("to_days", LL, f("date_sub", DT, ship, lit(2, LL), unit("quarter")))]
    dates += [f(op, LL, ship) for op in ("month", "day", "hour", "weekday")]
    reals = [f("sqrt", DBL, q), f("exp", DBL, f("div", DBL, q, lit(10.0, DBL))), f("ln", DBL, q),
             f("pow", DBL, q, lit(1.5, DBL))]
    scalars = [f("ceil", dec(28, 0), rev), f("floor", dec(28, 0), rev), f("round", dec(28, 0), rev),
               f("ceil", dec(15, 0), neg), f("floor", dec(15, 0), neg), f("round", dec(16, 1), neg, lit(1, LL)),
               f("sign", LL, f("minus", dec(16, 2), disc, lit("0.05", dec(3, 2))))] + bits + dates + reals
    aggs = [A("sum", (e,)) for e in scalars] + [A("bit_xor", (f("bitneg", UB, okey),)), A("count", ())]
    out["numeric"] = statement(sc, (), (), aggs)
    return out
