"""The Star Schema Benchmark's lineorder and date tables (O'Neil, O'Neil,
Chen and Revilak, TPCTC 2009, section 2), generated from a seed in numpy.

lineorder follows TPC-H's orders and lineitem rules as SSB's dbgen does:
sparse order keys, 1 to 7 lines an order, TPC-H's part prices and order
dates; dates are yyyymmdd integers keyed to date.d_datekey. date holds the
2,556 days from 1992-01-01. Prices are integer cents.
"""

from __future__ import annotations

import numpy as np

from . import text
from .tpch import MODES, PRIORITIES, START, END, order_keys, retail_cents

DAYS = 2556
MONTHS = ["January", "February", "March", "April", "May", "June", "July", "August", "September", "October",
          "November", "December"]
WEEKDAYS = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]
SEASONS = ["Winter", "Spring", "Summer", "Fall", "Christmas"]


def ymd(days: np.ndarray):
    d = np.asarray(days, np.int64).astype("datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return y, m, day


def datekey(days: np.ndarray) -> np.ndarray:
    y, m, d = ymd(days)
    return y * 10000 + m * 100 + d


def date_table() -> dict:
    days = START + np.arange(DAYS, dtype=np.int64)
    y, m, d = ymd(days)
    doy = days - (np.asarray(y - 1970, "datetime64[Y]").astype("datetime64[D]").astype(np.int64)) + 1
    dow = (days + 4) % 7  # 1970-01-01 was a Thursday; 0 = Sunday
    nxt_m = ymd(days + 1)[1]
    season = np.select([(m == 12) & (d >= 1), m <= 2, m <= 5, m <= 8], [4, 0, 1, 2], 3)
    holiday = ((m == 1) & (d == 1)) | ((m == 7) & (d == 4)) | ((m == 12) & (d == 25))
    return {
        "d_datekey": y * 10000 + m * 100 + d,
        "d_date": text.table_text([f"{MONTHS[a - 1]} {b}, {c}" for a, b, c in zip(m.tolist(), d.tolist(), y.tolist())],
                                  np.arange(DAYS)),
        "d_dayofweek": text.table_text(WEEKDAYS, dow),
        "d_month": text.table_text(MONTHS, m - 1),
        "d_year": y,
        "d_yearmonthnum": y * 100 + m,
        "d_yearmonth": text.table_text([f"{MONTHS[a - 1][:3]}{c}" for a, c in zip(m.tolist(), y.tolist())],
                                       np.arange(DAYS)),
        "d_daynuminweek": dow + 1,
        "d_daynuminmonth": d,
        "d_daynuminyear": doy,
        "d_monthnuminyear": m,
        "d_weeknuminyear": (doy - 1) // 7 + 1,
        "d_sellingseason": text.table_text(SEASONS, season),
        "d_lastdayinweekfl": text.table_text(["0", "1"], (dow == 6).astype(np.int64)),
        "d_lastdayinmonthfl": text.table_text(["0", "1"], (nxt_m != m).astype(np.int64)),
        "d_holidayfl": text.table_text(["0", "1"], holiday.astype(np.int64)),
        "d_weekdayfl": text.table_text(["0", "1"], ((dow >= 1) & (dow <= 5)).astype(np.int64)),
    }


def lineorder(rng: np.random.Generator, sf: float) -> dict:
    n_orders = int(1_500_000 * sf)
    okey = order_keys(n_orders)
    odate = rng.integers(START, END - 151 + 1, n_orders)
    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    first = np.zeros(n_orders, np.int64)
    np.cumsum(lines[:-1], out=first[1:])
    owner = np.repeat(np.arange(n_orders), lines)
    partkey = rng.integers(1, 200_000 + 1, n)
    qty = rng.integers(1, 51, n)
    retail = retail_cents(partkey)
    price = qty * retail
    disc = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    total = np.zeros(n_orders, np.int64)
    np.add.at(total, owner, price * (100 + tax) * (100 - disc) // 10000)
    prio, _ = text.fixed_choice(rng, n_orders, PRIORITIES)
    cust = rng.integers(1, int(30_000 * sf) + 1, n_orders)
    mode, _ = text.fixed_choice(rng, n, MODES)
    return {
        "lo_orderkey": okey[owner],
        "lo_linenumber": np.arange(n, dtype=np.int64) - first[owner] + 1,
        "lo_custkey": cust[owner],
        "lo_partkey": partkey,
        "lo_suppkey": rng.integers(1, int(2_000 * sf) + 1, n),
        "lo_orderdate": datekey(odate)[owner],
        "lo_orderpriority": prio.take(owner),
        "lo_shippriority": text.table_text(["0"], np.zeros(n, np.int64)),
        "lo_quantity": qty,
        "lo_extendedprice": price,
        "lo_ordtotalprice": total[owner],
        "lo_discount": disc,
        "lo_revenue": price * (100 - disc) // 100,
        "lo_supplycost": 6 * retail // 10,
        "lo_tax": tax,
        "lo_commitdate": datekey(odate[owner] + rng.integers(30, 91, n)),
        "lo_shipmode": mode,
    }


def generate(config: dict, seed: int) -> dict:
    rng = np.random.default_rng([seed, 0x55B])
    return {"date": date_table(), "lineorder": lineorder(rng, float(config["scale_factor"]))}
