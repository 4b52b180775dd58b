"""SHOW CREATE TABLE rendering in the reference's exact output shape
(ref: pkg/executor/show.go fetchShowCreateTable / ConstructResultOfShowCreateTable).

The engine normalizes storage types (every int width becomes an int64
lane, every string a packed varchar), so ColumnMeta carries the declared
spelling (`decl`) and this module only has to re-assemble the DDL text:
column lines, generated-column clauses (a minimal AST unparser — the
reference keeps GeneratedExprString verbatim), the clustered PRIMARY KEY
comment, and the InnoDB/charset footer the integration results expect.

Copy of `tidb_tpu/sql/showddl.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from ..parser import ast as A

_BINOP_SQL = {
    "plus": "+", "minus": "-", "mul": "*", "div": "/", "intdiv": "DIV",
    "mod": "%", "eq": "=", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
    "ge": ">=", "nulleq": "<=>", "and": "and", "or": "or", "xor": "xor",
    "bitand": "&", "bitor": "|", "bitxor": "^", "shiftleft": "<<",
    "shiftright": ">>",
}


def expr_sql(e) -> str:
    """Minimal AST -> SQL text (generated columns, CHECK, defaults)."""
    if isinstance(e, A.Literal):
        if e.kind == "null" or e.value is None:
            return "NULL"
        if e.kind in ("str",):
            v = e.value if isinstance(e.value, str) else e.value.decode("utf-8", "replace")
            return "'" + v.replace("'", "''") + "'"
        if e.kind == "bool":
            return "TRUE" if e.value else "FALSE"
        return str(e.value)
    if isinstance(e, A.ColumnName):
        return f"`{e.name}`"
    if isinstance(e, A.BinaryOp):
        return f"{expr_sql(e.left)} {_BINOP_SQL.get(e.op, e.op)} {expr_sql(e.right)}"
    if isinstance(e, A.UnaryOp):
        op = {"not": "not ", "unaryminus": "-", "bitneg": "~"}.get(e.op, e.op)
        return f"{op}{expr_sql(e.operand)}"
    if isinstance(e, A.FuncCall):
        return f"{e.name}({', '.join(expr_sql(a) for a in e.args)})"
    if isinstance(e, A.IsNull):
        return f"{expr_sql(e.expr)} is {'not ' if e.negated else ''}null"
    if isinstance(e, A.Between):
        neg = "not " if e.negated else ""
        return f"{expr_sql(e.expr)} {neg}between {expr_sql(e.low)} and {expr_sql(e.high)}"
    if isinstance(e, A.InList):
        neg = "not " if e.negated else ""
        return f"{expr_sql(e.expr)} {neg}in ({', '.join(expr_sql(a) for a in e.items)})"
    if isinstance(e, A.Case):
        parts = ["case"]
        if e.operand is not None:
            parts.append(expr_sql(e.operand))
        for w, t in e.when_clauses:
            parts.append(f"when {expr_sql(w)} then {expr_sql(t)}")
        if e.else_clause is not None:
            parts.append(f"else {expr_sql(e.else_clause)}")
        parts.append("end")
        return " ".join(parts)
    if isinstance(e, A.Cast):
        ts = e.to_type
        from .catalog import decl_text

        return f"cast({expr_sql(e.expr)} as {decl_text(ts)})"
    if isinstance(e, A.Like):
        neg = "not " if e.negated else ""
        return f"{expr_sql(e.expr)} {neg}like {expr_sql(e.pattern)}"
    return str(e)


def _fallback_decl(ft) -> str:
    et = ft.eval_type()
    if et == "int":
        return "bigint unsigned" if ft.is_unsigned() else "bigint"
    if et == "real":
        return "double"
    if et == "decimal":
        return f"decimal({ft.flen},{max(ft.decimal, 0)})"
    if et == "time":
        return "datetime"
    if et == "json":
        return "json"
    return f"varchar({ft.flen})" if ft.flen > 0 else "text"


def _default_sql(cm) -> str:
    d = cm.default
    if isinstance(d, A.FuncCall) and d.name in ("current_timestamp", "now"):
        return "CURRENT_TIMESTAMP"
    if isinstance(d, A.Literal):
        return expr_sql(d)
    return f"({expr_sql(d)})"


def show_create_table(meta) -> str:
    short = meta.name.rsplit(".", 1)[-1]  # strip any database prefix
    lines = [f"CREATE TABLE `{short}` ("]
    body = []
    from ..types import Flag

    for cm in meta.columns:
        decl = cm.decl or _fallback_decl(cm.ft)
        parts = [f"`{cm.name}`", decl]
        if cm.generated is not None:
            parts.append(f"GENERATED ALWAYS AS ({expr_sql(cm.generated)})")
            parts.append("STORED" if cm.generated_stored else "VIRTUAL")
        notnull = bool(cm.ft.flag & Flag.NotNull) or cm.name == meta.handle_col
        if notnull:
            parts.append("NOT NULL")
        if cm.auto_increment:
            parts.append("AUTO_INCREMENT")
        elif cm.default is not None and cm.generated is None:
            parts.append(f"DEFAULT {_default_sql(cm)}")
        elif not notnull and cm.generated is None:
            parts.append("DEFAULT NULL")
        body.append("  " + " ".join(parts))
    if meta.handle_col is not None:
        body.append(f"  PRIMARY KEY (`{meta.handle_col}`) /*T![clustered_index] CLUSTERED */")
    for idx in meta.indices:
        if idx.state != "public":
            continue
        cols = ",".join(f"`{c}`" for c in idx.col_names)
        if idx.name == "PRIMARY":
            body.append(f"  PRIMARY KEY ({cols}) /*T![clustered_index] NONCLUSTERED */")
            continue
        kind = "UNIQUE KEY" if idx.unique else "KEY"
        body.append(f"  {kind} `{idx.name}` ({cols})")
    for fk in getattr(meta, "foreign_keys", []):
        cols = ",".join(f"`{c}`" for c in fk.cols)
        rcols = ",".join(f"`{c}`" for c in fk.ref_cols)
        rt = fk.ref_table.rsplit(".", 1)[-1]
        line = f"  CONSTRAINT `{fk.name}` FOREIGN KEY ({cols}) REFERENCES `{rt}` ({rcols})"
        if fk.on_delete != "restrict":
            line += f" ON DELETE {fk.on_delete.replace('_', ' ').upper()}"
        if fk.on_update != "restrict":
            line += f" ON UPDATE {fk.on_update.replace('_', ' ').upper()}"
        body.append(line)
    out = lines[0] + "\n" + ",\n".join(body) + "\n"
    out += ") ENGINE=InnoDB DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin"
    return out
