"""The vectorized row encoder against the port's RowEncoder and against
the bytes the port's own INSERT writes."""

from decimal import Decimal

import numpy as np
import pytest
from sqlbench_testkit import tiny_tables

from sqlbench.datagen import rowv2
from sqlbench.harness import deploy


@pytest.mark.parametrize("config, table", [("tpch_sf05", "lineitem"), ("tpch_sf05_join", "orders"),
                                           ("tpch_sf05_join", "customer"), ("ssb_sf05", "lineorder"),
                                           ("ssb_sf05", "date")])
def test_encoder_matches_row_encoder(config, table):
    from tidb_tpu_torch import codec
    from tidb_tpu_torch import types as T

    cfg, data = tiny_tables(config)
    tab = cfg["tables"][table]
    kinds, cols = deploy.encoder_inputs(tab, data[table])
    col_ids = list(range(1, len(kinds) + 1))
    values = rowv2.encode_table(kinds, cols, col_ids, workers=2)
    n = len(values[1]) - 1
    handles = np.arange(1, n + 1, dtype=np.int64)
    keys = rowv2.row_keys(77, handles)
    enc = codec.RowEncoder()
    for i in range(0, n, max(n // 300, 1)):
        assert values[0][values[1][i]:values[1][i + 1]] == enc.encode(col_ids, deploy.row_datums(T, kinds, cols, i))
        assert keys[0][19 * i:19 * (i + 1)] == codec.encode_row_key(77, int(handles[i]))
    # the set-up's own check passes on the same bytes, and fails on one byte changed
    assert deploy.check_encoder(codec, T, table, 77, col_ids, kinds, cols, handles, keys, values, 3) > 0
    bad = bytearray(values[0])
    bad[values[1][0] + len(bad[values[1][0]:values[1][1]]) - 1] ^= 1
    with pytest.raises(deploy.SetupError):
        deploy.check_encoder(codec, T, table, 77, col_ids, kinds, cols, handles, keys, (bytes(bad), values[1]), 3)


def test_encoder_matches_insert():
    """Rows written by the port's SQL INSERT read back as the same bytes."""
    from tidb_tpu_torch import codec
    from tidb_tpu_torch.sql import Session

    cfg, data = tiny_tables("tpch_sf05_join")
    tab = cfg["tables"]["customer"]
    s = Session(device="cpu")
    s.execute(deploy.ddl("customer", tab))
    meta = s.catalog.table("customer")
    kinds, cols = deploy.encoder_inputs(tab, data["customer"])
    rows = []
    for i in range(40):
        vals = []
        for (col, _t), kind in zip(tab["columns"], kinds):
            v = data["customer"][col]
            if kind == "decimal":
                vals.append(str(Decimal(int(v[i])).scaleb(-2)))
            elif kind == "string":
                vals.append("'" + v.get(i).replace("'", "''") + "'")
            else:
                vals.append(str(int(v[i])))
        rows.append("(" + ", ".join(vals) + ")")
    s.execute("INSERT INTO customer VALUES " + ", ".join(rows))
    values = rowv2.encode_table(kinds, cols, [meta.col(c).col_id for c, _t in tab["columns"]], workers=1)
    got = dict(s.store.kv.scan(codec.record_prefix(meta.table_id), codec.record_prefix(meta.table_id + 1),
                               s.store.next_ts()))
    for i in range(40):
        key = codec.encode_row_key(meta.table_id, int(data["customer"]["c_custkey"][i]))
        assert got[key] == values[0][values[1][i]:values[1][i + 1]]


def test_decimal_edges():
    from tidb_tpu_torch import codec
    from tidb_tpu_torch import types as T

    vals = np.array([0, 1, -1, 5, 99, 100, -99999, 999999, 10 ** 9, -(10 ** 9) - 7, 123456789012, -(10 ** 17),
                     10 ** 17 + 3], np.int64)
    for frac in (0, 2, 4):
        mat, mask = rowv2.column_bytes("decimal", (vals, frac))
        for i, v in enumerate(vals.tolist()):
            want = codec.rowcodec.encode_row_value(deploy.row_datums(T, ["decimal"], [(vals, frac)], i)[0])
            assert bytes(mat[i][mask[i]]) == want, (v, frac)


def test_region_cuts():
    offs = np.arange(0, 101 * 81, 81)  # 100 rows of 81 value bytes (+19 key bytes = 100 a row)
    handles = np.arange(1, 101)
    assert deploy.split_handles(19, offs, handles, 1000) == [11, 21, 31, 41, 51, 61, 71, 81, 91]
    assert deploy.split_handles(19, offs, handles, 10 ** 6) == []
