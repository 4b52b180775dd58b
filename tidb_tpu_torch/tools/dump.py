"""Logical export — the Dumpling analog (ref: dumpling/export/dump.go:
one snapshot ts for every table gives a consistent dump; writer.go file
formats). Produces `<table>-schema.sql` plus `<table>.csv` or `<table>.sql`
per table.

Copy of `tidb_tpu/tools/dump.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import os

from ..types import Datum, DatumKind, TypeCode


def _type_sql(ft) -> str:
    if ft.is_int():
        return "BIGINT UNSIGNED" if ft.is_unsigned() else "BIGINT"
    if ft.tp == TypeCode.Double:
        return "DOUBLE"
    if ft.tp == TypeCode.Float:
        return "FLOAT"
    if ft.is_decimal():
        return f"DECIMAL({ft.flen if ft.flen > 0 else 20},{max(ft.decimal, 0)})"
    if ft.is_time():
        return "DATETIME" if max(ft.decimal, 0) == 0 else f"DATETIME({ft.decimal})"
    if ft.is_string():
        return f"VARCHAR({ft.flen if ft.flen > 0 else 255})"
    return "BIGINT"


def schema_sql(meta) -> str:
    cols = []
    for c in meta.columns:
        line = f"  `{c.name}` {_type_sql(c.ft)}"
        if c.name == meta.handle_col:
            line += " PRIMARY KEY"
        elif c.ft.flag & 1:  # NotNull
            line += " NOT NULL"
        cols.append(line)
    for idx in meta.indices:
        kind = "UNIQUE KEY" if idx.unique else "KEY"
        cols.append(f"  {kind} `{idx.name}` ({', '.join('`' + c + '`' for c in idx.col_names)})")
    return f"CREATE TABLE `{meta.name}` (\n" + ",\n".join(cols) + "\n);\n"


def _cell_csv(d: Datum) -> str:
    if d.is_null():
        return "\\N"
    s = str(d.val)
    if any(ch in s for ch in ',"\n\\'):
        return '"' + s.replace('"', '""') + '"'
    return s


def _cell_sql(d: Datum) -> str:
    if d.is_null():
        return "NULL"
    if d.kind in (DatumKind.Int64, DatumKind.Uint64, DatumKind.Float64, DatumKind.Float32):
        return str(d.val)
    if d.kind == DatumKind.MysqlDecimal:
        return str(d.val)
    s = str(d.val).replace("\\", "\\\\").replace("'", "''")
    return f"'{s}'"


def dump_table(session, table: str, out_dir: str, fmt: str = "csv",
               snapshot_ts: int | None = None, batch: int = 256) -> dict:
    """Dump one table at a snapshot. Returns {rows, schema_path, data_path}."""
    os.makedirs(out_dir, exist_ok=True)
    meta = session.catalog.table(table)
    ts = snapshot_ts if snapshot_ts is not None else session.store.next_ts()
    rows = [r for _, r in session._scan_rows_with_handles(meta, None, ts)]
    schema_path = os.path.join(out_dir, f"{meta.name}-schema.sql")
    with open(schema_path, "w") as f:
        f.write(schema_sql(meta))
    data_path = os.path.join(out_dir, f"{meta.name}.{'csv' if fmt == 'csv' else 'sql'}")
    with open(data_path, "w") as f:
        if fmt == "csv":
            f.write(",".join(c.name for c in meta.columns) + "\n")
            for r in rows:
                f.write(",".join(_cell_csv(d) for d in r) + "\n")
        else:
            for i in range(0, len(rows), batch):
                part = rows[i : i + batch]
                vals = ",".join("(" + ",".join(_cell_sql(d) for d in r) + ")" for r in part)
                f.write(f"INSERT INTO `{meta.name}` VALUES {vals};\n")
    return {"rows": len(rows), "schema_path": schema_path, "data_path": data_path}


def dump_all(session, out_dir: str, fmt: str = "csv") -> dict:
    """Every table at ONE snapshot ts (Dumpling's consistency contract)."""
    ts = session.store.next_ts()
    out = {}
    for name in session.catalog.tables():
        if name.startswith("mysql."):
            continue  # system schema excluded (Dumpling's default filter)
        out[name] = dump_table(session, name, out_dir, fmt, snapshot_ts=ts)
    return out
