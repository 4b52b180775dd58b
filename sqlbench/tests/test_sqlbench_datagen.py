"""The generators keep to TPC-H's and SSB's rules."""

import numpy as np
from sqlbench_testkit import tiny_tables

from sqlbench.datagen import ssb, tpch


def test_tpch_rules():
    _cfg, d = tiny_tables("tpch_sf05_join", sf=0.01)
    o, li, c = d["orders"], d["lineitem"], d["customer"]
    assert len(c["c_custkey"]) == 1500 and len(o["o_orderkey"]) == 15000
    # sparse order keys: the first 8 of every 32
    assert ((o["o_orderkey"] - 1) % 32 < 8).all() and len(np.unique(o["o_orderkey"])) == 15000
    # 1 to 7 lines an order, numbered from 1
    _, per = np.unique(li["l_orderkey"], return_counts=True)
    assert per.min() == 1 and per.max() == 7 and set(np.unique(li["l_linenumber"])) == set(range(1, 8))
    # customers with a key divisible by 3 place no orders
    assert (o["o_custkey"] % 3 != 0).all() and o["o_custkey"].max() <= 1500
    # returnflag and linestatus against 1995-06-17
    cur = tpch.CURRENT
    flag = li["l_returnflag"].mat[:, 0]
    assert (flag[li["l_receiptdate"] > cur] == ord("N")).all()
    assert np.isin(flag[li["l_receiptdate"] <= cur], [ord("R"), ord("A")]).all()
    stat = li["l_linestatus"].mat[:, 0]
    assert ((stat == ord("O")) == (li["l_shipdate"] > cur)).all()
    # dates, discounts, taxes and quantities in the spec's ranges
    pos = np.searchsorted(o["o_orderkey"], li["l_orderkey"])
    lag = li["l_shipdate"] - o["o_orderdate"][pos]
    assert lag.min() >= 1 and lag.max() <= 121
    assert ((li["l_receiptdate"] - li["l_shipdate"]) >= 1).all() and ((li["l_receiptdate"] - li["l_shipdate"]) <= 30).all()
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 10 and li["l_tax"].max() <= 8
    assert li["l_quantity"].min() >= 100 and li["l_quantity"].max() <= 5000
    assert (li["l_extendedprice"] == li["l_quantity"] // 100 * tpch.retail_cents(li["l_partkey"])).all()
    assert o["o_orderdate"].min() >= tpch.START and o["o_orderdate"].max() <= tpch.END - 151
    # phones: the nation's country code
    cc = (c["c_phone"].mat[:, 0] - 48) * 10 + (c["c_phone"].mat[:, 1] - 48)
    assert (cc == c["c_nationkey"] + 10).all()


def test_same_seed_same_tables():
    _c, a = tiny_tables("tpch_sf05", seed=2**31 + 5)
    _c, b = tiny_tables("tpch_sf05", seed=2**31 + 5)
    assert all(np.array_equal(np.asarray(getattr(a["lineitem"][k], "mat", a["lineitem"][k])),
                              np.asarray(getattr(b["lineitem"][k], "mat", b["lineitem"][k]))) for k in a["lineitem"])


def test_ssb_rules():
    _cfg, d = tiny_tables("ssb_sf05", sf=0.01)
    dt, lo = d["date"], d["lineorder"]
    assert len(dt["d_datekey"]) == ssb.DAYS and dt["d_datekey"][0] == 19920101
    assert np.isin(lo["lo_orderdate"], dt["d_datekey"]).all()
    assert (lo["lo_revenue"] == lo["lo_extendedprice"] * (100 - lo["lo_discount"]) // 100).all()
    assert lo["lo_discount"].max() <= 10 and lo["lo_quantity"].max() <= 50
    assert dt["d_weeknuminyear"].max() == 53 and set(np.unique(dt["d_year"])) == set(range(1992, 1999))
