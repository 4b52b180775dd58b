"""TPC-H Q3 (spec 2.4.3): the shipping priority query, exact.

Rows past the tenth may tie with it on (revenue, o_orderdate), where the
spec's ORDER BY leaves the choice open: `compare` accepts any of them.

`scratch` (kept by the caller between statements) holds the orders in
o_orderdate order, lineitem in l_orderkey order and the largest gap
between an order's date and its lines' ship dates, read from the data: a
date then needs only the orders dated within that gap before it."""

from __future__ import annotations

import numpy as np

from .common import as_float, day, dec, float_sum, iso, text_is

LIMIT = 10


def _prepare(tables: dict) -> dict:
    o, li = tables["orders"], tables["lineitem"]
    by_key = np.argsort(o["o_orderkey"], kind="stable")
    pos = by_key[np.searchsorted(o["o_orderkey"], li["l_orderkey"], sorter=by_key)]
    lag = li["l_shipdate"] - o["o_orderdate"][pos]
    by_date = np.argsort(o["o_orderdate"], kind="stable")
    line_order = np.argsort(li["l_orderkey"], kind="stable")
    return {"by_date": by_date, "dates": o["o_orderdate"][by_date], "max_lag": int(lag.max()),
            "line_order": line_order, "line_keys": li["l_orderkey"][line_order]}


def groups(tables: dict, params: dict, precision: str = "exact", scratch: dict | None = None) -> list:
    """Every (l_orderkey, revenue, o_orderdate, o_shippriority) group, in
    the spec's order."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    sc = scratch if scratch is not None else {}
    if "by_date" not in sc:
        sc.update(_prepare(tables))
    cut = day(params["date"])
    seg_keys = c["c_custkey"][text_is(c["c_mktsegment"], params["segment"])]
    # orders dated before the cut by at most the largest order-to-ship gap
    lo = int(np.searchsorted(sc["dates"], cut - sc["max_lag"], side="left"))
    hi = int(np.searchsorted(sc["dates"], cut, side="left"))
    cand = sc["by_date"][lo:hi]
    cand = cand[np.isin(o["o_custkey"][cand], seg_keys)]
    keys = o["o_orderkey"][cand]
    a = np.searchsorted(sc["line_keys"], keys, side="left")
    b = np.searchsorted(sc["line_keys"], keys, side="right")
    n = b - a
    lines = sc["line_order"][np.repeat(a, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)]
    lines = lines[li["l_shipdate"][lines] > cut]
    lk = li["l_orderkey"][lines]
    uniq, inv = np.unique(lk, return_inverse=True)
    order = np.argsort(keys, kind="stable")
    opos = cand[order[np.searchsorted(keys, uniq, sorter=order)]]
    odate, oprio = o["o_orderdate"][opos], o["o_shippriority"][opos]
    if precision != "exact":
        d = as_float(li["l_discount"][lines], 2, precision)
        pf = as_float(li["l_extendedprice"][lines], 2, precision) * (d.dtype.type(1) - d)
        sf = np.zeros(len(uniq), pf.dtype)
        np.add.at(sf, inv, pf)
        revs = [float_sum(sf[i:i + 1], 4) for i in range(len(uniq))]
    else:
        s = np.zeros(len(uniq), np.int64)
        np.add.at(s, inv, li["l_extendedprice"][lines] * (100 - li["l_discount"][lines]))  # scale 4
        revs = [dec(int(v), 4) for v in s]
    rows = [(int(k), r, iso(d), int(p)) for k, r, d, p in zip(uniq, revs, odate, oprio)]
    rows.sort(key=lambda r: (-r[1], r[2]))
    return rows


def answer(tables: dict, params: dict, precision: str = "exact", scratch: dict | None = None) -> list:
    """The groups that may stand in the answer: the first LIMIT and every
    one that ties with the last of them."""
    rows = groups(tables, params, precision, scratch)
    if len(rows) <= LIMIT:
        return rows
    last = (rows[LIMIT - 1][1], rows[LIMIT - 1][2])
    return rows[:LIMIT] + [r for r in rows[LIMIT:] if (r[1], r[2]) == last]


def compare(got: list, want: list) -> bool:
    """The answer's sort keys are the first LIMIT of the reference's, and
    each of its rows is one of the reference's groups."""
    keys = [(r[1], r[2]) for r in want[:LIMIT]]
    return [(r[1], r[2]) for r in got] == keys and all(r in want for r in got)
