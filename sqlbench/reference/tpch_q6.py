"""TPC-H Q6 (spec 2.4.6): the forecasting revenue change, exact."""

from __future__ import annotations

from decimal import Decimal

from .common import as_float, day, dec, float_sum


def answer(tables: dict, params: dict, precision: str = "exact", scratch: dict | None = None) -> list:
    t = tables["lineitem"]
    lo = int(Decimal(params["disc_lo"]) * 100)
    hi = int(Decimal(params["disc_hi"]) * 100)
    m = ((t["l_shipdate"] >= day(params["date"])) & (t["l_shipdate"] < day(params["date_end"]))
         & (t["l_discount"] >= lo) & (t["l_discount"] <= hi) & (t["l_quantity"] < int(params["quantity"]) * 100))
    if not m.any():
        return [(None,)]
    p, d = t["l_extendedprice"][m], t["l_discount"][m]
    if precision != "exact":
        return [(float_sum(as_float(p, 2, precision) * as_float(d, 2, precision), 4),)]
    return [(dec(int((p * d).sum()), 4),)]
