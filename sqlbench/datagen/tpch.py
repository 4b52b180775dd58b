"""TPC-H's customer, orders and lineitem, generated from a seed with the
spec's rules (TPC-H spec rev. 3.0.1, 4.2.3), in numpy.

Every column of the three tables is made, at its spec width, because the
port's planner scans whole rows: a narrow table would flatter the decode.
Dates are int64 days since 1970-01-01, decimals int64 in cents, text a
rowv2.Text. Sizes follow the scale factor: customer 150,000 x SF, orders
1,500,000 x SF, lineitem 1 to 7 lines an order.
"""

from __future__ import annotations

import numpy as np

from . import text
from .rowv2 import Text

START = np.datetime64("1992-01-01", "D").astype(np.int64)
CURRENT = np.datetime64("1995-06-17", "D").astype(np.int64)
END = np.datetime64("1998-12-31", "D").astype(np.int64)
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]


def order_keys(n: int) -> np.ndarray:
    """Sparse order keys: the first 8 of every 32 (spec 4.2.3, O_ORDERKEY)."""
    i = np.arange(n, dtype=np.int64)
    return (i // 8) * 32 + i % 8 + 1


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents: (90000 + ((key / 10) mod 20001) + 100 (key mod 1000))."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def customer(rng: np.random.Generator, n: int, pool: np.ndarray) -> dict:
    key = np.arange(1, n + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n)
    phone = np.empty((n, 15), np.uint8)
    cc = nation + 10
    parts = [rng.integers(100, 1000, n), rng.integers(100, 1000, n), rng.integers(1000, 10000, n)]
    digits = [(cc, 2), (parts[0], 3), (parts[1], 3), (parts[2], 4)]
    pos = 0
    for j, (v, w) in enumerate(digits):
        for k in range(w):
            phone[:, pos] = 48 + (v // 10 ** (w - 1 - k)) % 10
            pos += 1
        if j < 3:
            phone[:, pos] = ord("-")
            pos += 1
    seg, _ = text.fixed_choice(rng, n, SEGMENTS)
    return {
        "c_custkey": key,
        "c_name": text.formatted("Customer#", key, 9),
        "c_address": text.v_string(rng, n, 10, 40),
        "c_nationkey": nation,
        "c_phone": Text(phone, np.full(n, 15, np.int64)),
        "c_acctbal": rng.integers(-99999, 999999 + 1, n),
        "c_mktsegment": seg,
        "c_comment": text.pool_text(rng, pool, n, 29, 116),
    }


def orders_and_lineitem(rng: np.random.Generator, n_orders: int, n_cust: int, sf: float, pool: np.ndarray):
    okey = order_keys(n_orders)
    # customers whose key is a multiple of 3 place no orders
    j = rng.integers(0, n_cust - n_cust // 3, n_orders)
    ocust = (j // 2) * 3 + j % 2 + 1
    odate = rng.integers(START, END - 151 + 1, n_orders)
    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    first = np.zeros(n_orders, np.int64)
    np.cumsum(lines[:-1], out=first[1:])
    owner = np.repeat(np.arange(n_orders), lines)
    linenumber = np.arange(n, dtype=np.int64) - first[owner] + 1
    n_part, n_supp = int(200_000 * sf), int(10_000 * sf)
    partkey = rng.integers(1, n_part + 1, n)
    i = rng.integers(0, 4, n)
    suppkey = (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    qty = rng.integers(1, 51, n)
    price = qty * retail_cents(partkey)
    disc = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    l_odate = odate[owner]
    ship = l_odate + rng.integers(1, 122, n)
    commit = l_odate + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    ra = rng.integers(0, 2, n)
    rflag_idx = np.where(receipt <= CURRENT, ra, 2)  # R, A, N
    lstat_idx = (ship > CURRENT).astype(np.int64)  # F, O
    instr, _ = text.fixed_choice(rng, n, INSTRUCTIONS)
    mode, _ = text.fixed_choice(rng, n, MODES)
    lineitem = {
        "l_orderkey": okey[owner],
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": qty * 100,
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": text.table_text(["R", "A", "N"], rflag_idx),
        "l_linestatus": text.table_text(["F", "O"], lstat_idx),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": instr,
        "l_shipmode": mode,
        "l_comment": text.pool_text(rng, pool, n, 10, 43),
    }
    # O_TOTALPRICE = sum(L_EXTENDEDPRICE * (1 + L_TAX) * (1 - L_DISCOUNT)),
    # exact in 1e-6 cents, rounded half up to cents
    line_total = price * (100 + tax) * (100 - disc)
    total = np.zeros(n_orders, np.int64)
    np.add.at(total, owner, line_total)
    total = (total + 5000) // 10000
    n_o = np.bincount(owner, weights=lstat_idx, minlength=n_orders).astype(np.int64)
    status = np.where(n_o == lines, 1, np.where(n_o == 0, 0, 2))  # F, O, P
    prio, _ = text.fixed_choice(rng, n_orders, PRIORITIES)
    clerk = text.formatted("Clerk#", rng.integers(1, max(int(1000 * sf), 1) + 1, n_orders), 9)
    orders = {
        "o_orderkey": okey,
        "o_custkey": ocust,
        "o_orderstatus": text.table_text(["F", "O", "P"], status),
        "o_totalprice": total,
        "o_orderdate": odate,
        "o_orderpriority": prio,
        "o_clerk": clerk,
        "o_shippriority": np.zeros(n_orders, np.int64),
        "o_comment": text.pool_text(rng, pool, n_orders, 19, 78),
    }
    return orders, lineitem


def generate(config: dict, seed: int) -> dict:
    """{table: {column: values}} for the configuration's tables."""
    sf = float(config["scale_factor"])
    rng = np.random.default_rng([seed, 0x7C0])
    pool = text.pool(rng)
    n_cust = int(150_000 * sf)
    n_orders = int(1_500_000 * sf)
    cust = customer(rng, n_cust, pool)
    orders, lineitem = orders_and_lineitem(rng, n_orders, n_cust, sf, pool)
    return {"customer": cust, "orders": orders, "lineitem": lineitem}
