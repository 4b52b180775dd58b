"""SSB flight 1 (Q1.1, Q1.2, Q1.3, O'Neil et al. 2009, section 3.1),
exact: the revenue of lineorders in a date window, discount band and
quantity band."""

from __future__ import annotations

import numpy as np

from .common import int32_sum

# query -> (date predicate over the date table, discount band, quantity band)
FLIGHT = {
    "1.1": (lambda d: d["d_year"] == 1993, (1, 3), (None, 24)),
    "1.2": (lambda d: d["d_yearmonthnum"] == 199401, (4, 6), (26, 35)),
    "1.3": (lambda d: (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994), (5, 7), (26, 35)),
}


def answer(tables: dict, params: dict, precision: str = "exact", scratch: dict | None = None) -> list:
    d, lo = tables["date"], tables["lineorder"]
    date_ok, (dlo, dhi), (qlo, qhi) = FLIGHT[params["query"]]
    keys = d["d_datekey"][date_ok(d)]
    m = np.isin(lo["lo_orderdate"], keys) & (lo["lo_discount"] >= dlo) & (lo["lo_discount"] <= dhi)
    m &= lo["lo_quantity"] <= qhi
    if qlo is not None:
        m &= lo["lo_quantity"] >= qlo
    if not m.any():
        return [(None,)]
    v = lo["lo_extendedprice"][m] * lo["lo_discount"][m]
    if precision == "int32":
        return [(int32_sum(v),)]
    return [(int(v.sum()),)]
