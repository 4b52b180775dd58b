"""Set-up of one deployment: tables generated from the seed, encoded by
the vectorized encoder (held against the port's RowEncoder on a seeded
sample of rows), loaded with TPUStore.bulk_ingest into regions cut at the
configuration's split size, and described to the planner by LOAD STATS."""

from __future__ import annotations

import json
import os
import tempfile
import time
from decimal import Decimal

import numpy as np

from ..datagen import rowv2
from . import spec

SAMPLE_ROWS = 512  # rows a table the encoder check holds against RowEncoder


class SetupError(RuntimeError):
    """The deployment could not be built as configured."""


def ddl(name: str, table: dict) -> str:
    cols = []
    for col, sql_type in table["columns"]:
        cols.append(f"{col} {sql_type} NOT NULL" + (" PRIMARY KEY" if col == table.get("handle") else ""))
    return f"CREATE TABLE {name} ({', '.join(cols)})"


def encoder_inputs(table: dict, data: dict):
    kinds, columns = [], []
    for col, sql_type in table["columns"]:
        kind, arg = rowv2.kind_of(sql_type)
        kinds.append(kind)
        columns.append((data[col], arg) if kind == "decimal" else data[col])
    return kinds, columns


def row_datums(T, kinds, columns, i: int) -> list:
    """Row i as the Datums the session's INSERT would encode."""
    out = []
    for kind, c in zip(kinds, columns):
        if kind == "int":
            out.append(T.Datum.i64(int(c[i])))
        elif kind == "decimal":
            v, frac = c
            out.append(T.Datum.dec(T.MyDecimal(Decimal(int(v[i])).scaleb(-frac), frac)))
        elif kind == "date":
            out.append(T.Datum.time(T.MyTime(int(rowv2.packed_date(np.array([c[i]]))[0]), 0)))
        else:
            out.append(T.Datum.string(c.get(i)))
    return out


def check_encoder(codec, T, name, table_id, col_ids, kinds, columns, handles, keys, values, seed) -> int:
    """Hold a seeded sample of rows (the first and last among them) against
    the port's RowEncoder and encode_row_key, byte for byte. Returns the
    rows checked; raises SetupError on the first difference."""
    n = len(handles)
    rng = np.random.default_rng([seed, table_id])
    sample = sorted(set(rng.integers(0, n, SAMPLE_ROWS).tolist()) | {0, n - 1})
    enc = codec.RowEncoder()
    kb, kw = keys
    vb, offs = values
    for i in sample:
        want_v = enc.encode(col_ids, row_datums(T, kinds, columns, i))
        want_k = codec.encode_row_key(table_id, int(handles[i]))
        if want_v != vb[offs[i]:offs[i + 1]] or want_k != kb[i * kw:(i + 1) * kw]:
            raise SetupError(f"the encoder differs from RowEncoder on {name} row {i}: "
                             f"{vb[offs[i]:offs[i + 1]].hex()} != {want_v.hex()}")
    return len(sample)


def split_handles(key_width: int, offs: np.ndarray, handles: np.ndarray, split_bytes: int) -> list:
    """The handles at which the table's key range is cut: a region ends
    where its keys and values pass split_bytes."""
    sizes = key_width + np.diff(offs)
    region = (np.cumsum(sizes) - sizes) // split_bytes  # of each row's first byte
    return handles[np.nonzero(np.diff(region))[0] + 1].tolist()


def text_ndv(t: rowv2.Text) -> int:
    """Distinct values of a text column by a 64-bit hash of each, taken
    over its bytes eight at a time (ANALYZE's own NDV is a sketch, too)."""
    n, w = t.mat.shape
    words = -(-w // 8)
    padded = np.zeros((n, 8 * words), np.uint8)
    padded[:, :w] = np.where(np.arange(w)[None, :] < t.lens[:, None], t.mat, 0)
    h = t.lens.astype(np.uint64)
    mult = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for word in padded.view(np.uint64).T:
            h = (h ^ word) * mult
            h ^= h >> np.uint64(29)
    return len(np.unique(h))


def int_ndv(v: np.ndarray) -> int:
    """Distinct values of an integer column (a count table where the range
    is small, a sort otherwise)."""
    lo, hi = int(v.min()), int(v.max())
    if hi - lo < 1 << 24:
        return int(np.count_nonzero(np.bincount(v - lo, minlength=hi - lo + 1)))
    return len(np.unique(v))


def stats_blob(name: str, table: dict, data: dict, n: int) -> dict:
    cols = {}
    for col, _t in table["columns"]:
        v = data[col]
        ndv = text_ndv(v) if isinstance(v, rowv2.Text) else int_ndv(np.asarray(v, np.int64))
        cols[col] = {"null_count": 0, "histogram": {"ndv": int(ndv)}}
    return {"table_name": name, "count": n, "columns": cols}


class Deployment:
    """The store, the catalog and the generated tables of one run."""

    def __init__(self, store, catalog, tables: dict, regions: dict, timings: dict, checked_rows: int):
        self.store, self.catalog, self.tables = store, catalog, tables
        self.regions, self.timings, self.checked_rows = regions, timings, checked_rows


def build(cfg: dict, seed: int, device: str) -> Deployment:
    from tidb_tpu_torch import codec
    from tidb_tpu_torch import types as T
    from tidb_tpu_torch.sql import Session
    from tidb_tpu_torch.store import TPUStore

    timings = {}
    t0 = time.perf_counter()
    data = spec.generator(cfg["generator"])(cfg, seed)
    timings["generate_s"] = time.perf_counter() - t0

    store = TPUStore(device=device)
    store.cluster.set_stores(int(cfg["peers"]))
    boot = Session(store=store, device=device)
    for name, table in cfg["tables"].items():
        boot.execute(ddl(name, table))
    regions, checked = {}, 0
    timings["encode_s"] = timings["ingest_s"] = 0.0
    for name, table in cfg["tables"].items():
        t1 = time.perf_counter()
        meta = boot.catalog.table(name)
        col_ids = [meta.col(c).col_id for c, _t in table["columns"]]
        kinds, columns = encoder_inputs(table, data[name])
        values = rowv2.encode_table(kinds, columns, col_ids, workers=min(8, os.cpu_count() or 1))
        n = len(values[1]) - 1
        handles = (np.asarray(data[name][table["handle"]], np.int64) if table.get("handle")
                   else np.arange(1, n + 1, dtype=np.int64))
        keys = rowv2.row_keys(meta.table_id, handles)
        checked += check_encoder(codec, T, name, meta.table_id, col_ids, kinds, columns, handles, keys, values, seed)
        items = rowv2.items(keys, values)
        cuts = split_handles(keys[1], values[1], handles, int(cfg["region_split_bytes"]))
        t2 = time.perf_counter()
        store.cluster.split(codec.record_prefix(meta.table_id))
        for h in cuts:
            store.cluster.split(codec.encode_row_key(meta.table_id, h))
        store.bulk_ingest(items, store.next_ts())
        del items
        t3 = time.perf_counter()
        timings["encode_s"] += t2 - t1
        timings["ingest_s"] += t3 - t2
        regions[name] = len(cuts) + 1
    t4 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sqlbench-stats-") as tmp:
        for name, table in cfg["tables"].items():
            n = len(data[name][table["columns"][0][0]])
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump(stats_blob(name, table, data[name], n), f)
            boot.execute(f"LOAD STATS '{path}'")
    timings["stats_s"] = time.perf_counter() - t4
    return Deployment(store, boot.catalog, data, regions, timings, checked)
