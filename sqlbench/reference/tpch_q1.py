"""TPC-H Q1 (spec 2.4.1): the pricing summary report, exact.

Each (returnflag, linestatus) group's rows are put in l_shipdate order once
(in `scratch`, which the caller keeps between statements), with int64
prefix sums of every aggregate's terms: a cutoff is then a binary search.
The controls (float64, float32) sum the selected rows directly."""

from __future__ import annotations

import numpy as np

from .common import as_float, day, dec, float_avg, float_sum
from .frozen import round_div


def _groups(t: dict) -> list:
    """[(flag, status, shipdates sorted, prefix sums of qty, price, disc,
    disc_price, charge)] in the ORDER BY's order."""
    flag = t["l_returnflag"].mat[:, 0]
    stat = t["l_linestatus"].mat[:, 0]
    out = []
    for f in sorted(np.unique(flag).tolist()):
        for s in sorted(np.unique(stat).tolist()):
            idx = np.nonzero((flag == f) & (stat == s))[0]
            if not len(idx):
                continue
            idx = idx[np.argsort(t["l_shipdate"][idx], kind="stable")]
            q, p = t["l_quantity"][idx], t["l_extendedprice"][idx]
            d, x = t["l_discount"][idx], t["l_tax"][idx]
            disc_price = p * (100 - d)  # scale 4
            terms = [np.cumsum(v) for v in (q, p, d, disc_price, disc_price * (100 + x))]
            out.append((chr(f), chr(s), t["l_shipdate"][idx], terms, idx))
    return out


def answer(tables: dict, params: dict, precision: str = "exact", scratch: dict | None = None) -> list:
    t = tables["lineitem"]
    scratch = {} if scratch is None else scratch
    if "groups" not in scratch:
        scratch["groups"] = _groups(t)
    cut = day(params["cutoff"])
    rows = []
    for f, s, ship, terms, idx in scratch["groups"]:
        k = int(np.searchsorted(ship, cut, side="right"))
        if not k:
            continue
        if precision != "exact":
            sel = idx[:k]
            q, p, d, x = (as_float(t[c][sel], 2, precision) for c in
                          ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
            one = q.dtype.type(1)
            sums = [float_sum(q, 2), float_sum(p, 2), float_sum(p * (one - d), 4), float_sum(p * (one - d) * (one + x), 6)]
            avgs = [float_avg(v, 6) for v in (q, p, d)]
        else:
            sq, sp, sd, sdp, sc = (int(v[k - 1]) for v in terms)
            sums = [dec(sq, 2), dec(sp, 2), dec(sdp, 4), dec(sc, 6)]
            avgs = [dec(round_div(v * 10 ** 4, k), 6) for v in (sq, sp, sd)]
        rows.append((f, s, *sums, *avgs, k))
    return rows
