"""The `m`-prefix schema keyspace — catalog persistence in the store
(ref: pkg/meta/meta.go: TiDB keeps every TableInfo under the `m` prefix in
TiKV and the domain reloads the infoschema from it, domain.go:1131; a
restarted process therefore recovers its whole catalog from bytes).

Layout (all values JSON, written at a fresh TSO like meta txns):

  m\\x00t\\x00{table_id:8 big-endian}   one table's TableInfo record
  m\\x00schema                          {"version", "next_id"}

`m` sorts before the `t`-prefixed row/index keyspace, so meta never
collides with data and BR's full-range scans keep working per-table.

Copy of `tidb_tpu/sql/meta.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import json
import struct

from .catalog import Catalog, ColumnMeta, IndexMeta, TableMeta
from ..types import Collation, Datum, DatumKind, FieldType, Flag, MyDecimal, MyTime, TypeCode

M_TABLE_PREFIX = b"m\x00t\x00"
M_TABLE_END = b"m\x00t\x01"
M_STATE_KEY = b"m\x00schema"


# ---------------------------------------------------------------- dicts
def ft_to_dict(ft: FieldType) -> dict:
    return {"tp": int(ft.tp), "flag": int(ft.flag), "flen": ft.flen,
            "decimal": ft.decimal, "charset": ft.charset, "collate": int(ft.collate),
            "elems": list(ft.elems)}


def ft_from_dict(d: dict) -> FieldType:
    return FieldType(TypeCode(d["tp"]), Flag(d["flag"]), d["flen"], d["decimal"],
                     d.get("charset", "utf8mb4"), Collation(d.get("collate", 0)),
                     tuple(d.get("elems", ())))


def datum_to_dict(d) -> dict | None:
    if d is None:
        return None
    if d.is_null():
        return {"k": "null"}
    if d.kind == DatumKind.MysqlDecimal:
        return {"k": "dec", "v": str(d.val)}
    if d.kind == DatumKind.MysqlTime:
        return {"k": "time", "v": d.val.packed}
    if d.kind in (DatumKind.String, DatumKind.Bytes):
        v = d.val if isinstance(d.val, str) else bytes(d.val).decode("utf-8", "surrogateescape")
        return {"k": "str", "v": v}
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        return {"k": "f64", "v": float(d.val)}
    if d.kind == DatumKind.Uint64:
        return {"k": "u64", "v": int(d.val)}
    return {"k": "i64", "v": int(d.val)}


def datum_from_dict(d: dict | None):
    if d is None:
        return None
    k = d["k"]
    if k == "null":
        return Datum.NULL
    if k == "dec":
        return Datum.dec(MyDecimal(d["v"]))
    if k == "time":
        return Datum.time(MyTime(d["v"]))
    if k == "str":
        return Datum.string(d["v"])
    if k == "f64":
        return Datum.f64(d["v"])
    if k == "u64":
        return Datum.u64(d["v"])
    return Datum.i64(d["v"])


def _default_to_dict(d) -> dict | None:
    """Column DEFAULT serialization: literal datums and the dynamic now()
    form cover every default the session evaluates (_eval_const handles
    Literal | FuncCall('now') | Datum)."""
    from ..parser import ast as A

    if d is None:
        return None
    if isinstance(d, Datum):
        return {"k": "datum", "v": datum_to_dict(d)}
    if isinstance(d, A.FuncCall) and d.name == "now":
        return {"k": "now"}
    if isinstance(d, A.Literal):
        return {"k": "lit", "v": d.value if not isinstance(d.value, bytes) else d.value.decode("utf-8", "surrogateescape"), "t": d.kind}
    if isinstance(d, A.UnaryOp) and d.op == "unaryminus" and isinstance(d.operand, A.Literal):
        return {"k": "neg", "v": d.operand.value, "t": d.operand.kind}
    return {"k": "repr", "v": repr(d)}  # unknown: survives as unusable marker


def _default_from_dict(d: dict | None):
    from ..parser import ast as A

    if d is None:
        return None
    if d["k"] == "datum":
        return datum_from_dict(d["v"])
    if d["k"] == "now":
        return A.FuncCall("now", [])
    if d["k"] == "lit":
        return A.Literal(d["v"], d["t"])
    if d["k"] == "neg":
        return A.UnaryOp("unaryminus", A.Literal(d["v"], d["t"]))
    return None


def table_to_dict(m: TableMeta) -> dict:
    return {
        "name": m.name,
        "table_id": m.table_id,
        "handle_col": m.handle_col,
        "row_count": m.row_count,
        "next_handle": m.peek_handle(),
        "next_col_id": m.next_col_id,
        "columns": [
            {"name": c.name, "col_id": c.col_id, "ft": ft_to_dict(c.ft),
             "origin_default": datum_to_dict(c.origin_default),
             "default": _default_to_dict(c.default),
             "auto_increment": c.auto_increment}
            for c in m.columns
        ],
        "indices": [
            {"name": i.name, "index_id": i.index_id, "col_names": i.col_names,
             "unique": i.unique, "state": i.state}
            for i in m.indices
        ],
        "partition": None if m.partition is None else {
            "method": m.partition.method,
            "col": m.partition.col,
            "parts": [{"name": p.name, "pid": p.pid, "upper": p.upper}
                      for p in m.partition.parts],
        },
    }


def table_from_dict(t: dict) -> TableMeta:
    cols = [
        ColumnMeta(
            c["name"], c["col_id"], ft_from_dict(c["ft"]),
            default=_default_from_dict(c.get("default")),
            auto_increment=c.get("auto_increment", False),
            origin_default=datum_from_dict(c.get("origin_default")),
        )
        for c in t["columns"]
    ]
    idxs = [IndexMeta(i["name"], i["index_id"], list(i["col_names"]), i["unique"],
                      i.get("state", "public")) for i in t["indices"]]
    meta = TableMeta(t["name"], t["table_id"], cols, idxs, t["handle_col"])
    pd = t.get("partition")
    if pd is not None:
        from .catalog import PartitionDef, PartitionInfo

        meta.partition = PartitionInfo(
            pd["method"], pd["col"],
            [PartitionDef(p["name"], p["pid"], p["upper"]) for p in pd["parts"]],
        )
    meta.row_count = t["row_count"]
    meta._next_handle = t["next_handle"]
    if t.get("next_col_id"):
        meta.next_col_id = t["next_col_id"]
    return meta


# ---------------------------------------------------------------- kv io
def _table_key(table_id: int) -> bytes:
    return M_TABLE_PREFIX + struct.pack(">q", table_id)


def persist_catalog(store, catalog: Catalog) -> None:
    """Write the whole catalog into the m keyspace (called after every
    schema-changing statement — the one-process analog of the reference's
    meta txn inside each DDL job)."""
    ts = store.next_ts()
    live = set()
    with catalog._lock:
        names = list(catalog._tables)
    for name in names:
        m = catalog.table(name)
        store.kv.put(_table_key(m.table_id), json.dumps(table_to_dict(m)).encode(), ts)
        live.add(m.table_id)
    # tombstone records of dropped tables
    for k, _ in store.kv.scan(M_TABLE_PREFIX, M_TABLE_END, ts):
        tid = struct.unpack(">q", k[len(M_TABLE_PREFIX):])[0]
        if tid not in live:
            store.kv.put(k, None, ts)
    with catalog._lock:
        next_id = catalog._next_id
        views_snapshot = list(catalog.views.values())
    state = {
        "version": catalog.version,
        "next_id": next_id,
        "databases": sorted(catalog.databases),
        "views": {
            v.name: {"columns": v.columns, "select": v.select_sql}
            for v in views_snapshot
        },
    }
    store.kv.put(M_STATE_KEY, json.dumps(state).encode(), ts)


def _max_row_handle(store, table_id: int) -> int | None:
    """Greatest existing row handle of a table (None when empty): the meta
    record's next_handle snapshot is only as fresh as the last DDL, while
    DML keeps allocating — the reopened allocator must rebase above the
    real keyspace (ref: meta/autoid rebase on bootstrap)."""
    import bisect

    from ..codec import tablecodec

    start = tablecodec.encode_row_key(table_id, -(1 << 63))
    end = tablecodec.encode_row_key(table_id, (1 << 63) - 1) + b"\x00"
    kv = store.kv
    with kv.lock:
        kv._ensure_sorted()
        i = bisect.bisect_left(kv._keys, end) - 1
        if i < 0:
            return None
        k = kv._keys[i]
        if not (start <= k < end):
            return None
        return tablecodec.decode_row_key(k)[1]


def load_catalog(store) -> Catalog | None:
    """Recover a Catalog from the m keyspace; None when the store carries
    no schema (fresh store). The restart analog of the domain's infoschema
    reload (ref: pkg/domain/domain.go:1131)."""
    ts = store.next_ts()
    raw = store.kv.get(M_STATE_KEY, ts)
    if raw is None:
        return None
    state = json.loads(raw)
    cat = Catalog()
    for _, v in store.kv.scan(M_TABLE_PREFIX, M_TABLE_END, ts):
        meta = table_from_dict(json.loads(v))
        for pid in meta.physical_ids():
            mh = _max_row_handle(store, pid)
            if mh is not None:
                meta.observe_handle(mh)
        with cat._lock:
            cat._tables[meta.name] = meta
    with cat._lock:
        cat._next_id = max(state["next_id"], cat._next_id)
    cat.version = state["version"]
    from .catalog import ViewMeta

    for vn, vd in state.get("views", {}).items():
        with cat._lock:
            cat.views[vn] = ViewMeta(vn, vd["columns"], vd["select"])
    cat.databases |= set(state.get("databases", []))
    return cat
