"""Recursive-descent MySQL parser (ref: pkg/parser/parser.y — 16.5k-line
goyacc grammar; this covers the dialect subset the engine executes: full
TPC-H SELECT shape, DML, DDL, txn control, SHOW/SET/EXPLAIN/ANALYZE/ADMIN,
prepared statements, BACKUP/RESTORE).

Expression precedence mirrors MySQL (ref: parser.y precedence decls):
  OR < XOR < AND < NOT < comparison/IS/IN/LIKE/BETWEEN < | < & < shifts
  < +- < */%  < ^ < unary < collate.

Copy of `tidb_tpu/parser/parser.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from . import ast as A
from .lexer import LexError, T, Token, tokenize


class ParseError(ValueError):
    pass


# Keywords that stop an alias from being swallowed.
_RESERVED_AFTER_EXPR = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "JOIN",
    "INNER", "LEFT", "RIGHT", "CROSS", "ON", "USING", "AND", "OR", "XOR",
    "NOT", "AS", "ASC", "DESC", "INTO", "FOR", "SET", "WHEN", "THEN",
    "ELSE", "END", "BETWEEN", "LIKE", "IN", "IS", "EXISTS", "CASE",
    "STRAIGHT_JOIN", "NATURAL", "OFFSET", "LOCK", "VALUES", "WITH",
    "INTERVAL", "REGEXP", "RLIKE", "DIV", "MOD", "COLLATE", "DUPLICATE",
    "EXCEPT", "INTERSECT", "TABLESAMPLE",
    "KEY", "UPDATE", "ALL", "ANY", "SOME", "ESCAPE", "OVER", "WINDOW",
}

_TABLE_OPTION_KWS = {
    "ENGINE", "AUTO_INCREMENT", "CHARSET", "CHARACTER", "COLLATE", "COMMENT",
    "DEFAULT", "TTL", "TTL_ENABLE", "TTL_JOB_INTERVAL", "AUTO_ID_CACHE",
    "AUTO_RANDOM_BASE", "SHARD_ROW_ID_BITS", "PRE_SPLIT_REGIONS",
    "KEY_BLOCK_SIZE", "STATS_PERSISTENT", "STATS_AUTO_RECALC",
    "STATS_SAMPLE_PAGES", "MAX_ROWS", "MIN_ROWS", "AVG_ROW_LENGTH",
    "CHECKSUM", "DELAY_KEY_WRITE", "ROW_FORMAT", "COMPRESSION", "CONNECTION",
    "PACK_KEYS", "STATS_BUCKETS", "STATS_TOPN", "STATS_COL_CHOICE",
    "STATS_COL_LIST", "STATS_SAMPLE_RATE", "INSERT_METHOD",
    "SECONDARY_ENGINE", "PLACEMENT", "AUTOEXTEND_SIZE", "ENCRYPTION",
}

_AGG_FUNCS = {
    "count", "sum", "avg", "min", "max", "group_concat", "bit_and",
    "bit_or", "bit_xor", "std", "stddev", "stddev_pop", "stddev_samp",
    "var_pop", "var_samp", "variance", "approx_count_distinct",
}

_TYPE_NAMES = {
    "tinyint", "smallint", "mediumint", "int", "integer", "bigint",
    "float", "double", "real", "decimal", "numeric", "dec", "fixed",
    "char", "varchar", "binary", "varbinary", "text", "tinytext",
    "mediumtext", "longtext", "blob", "tinyblob", "mediumblob", "longblob",
    "date", "datetime", "timestamp", "time", "year", "bit", "bool",
    "boolean", "enum", "set", "json", "signed", "unsigned",
}


def parse(sql: str) -> list:
    """Parse one or more ;-separated statements."""
    return Parser(sql).parse_statements()


def parse_one(sql: str):
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected one statement, got {len(stmts)}")
    return stmts[0]


def parse_expr(text: str) -> A.ExprNode:
    p = Parser(f"SELECT {text}")
    stmt = p.parse_statements()[0]
    return stmt.fields[0].expr


def _parse_hints(text: str) -> list:
    """/*+ NAME(args), NAME2() */ body -> [(name_lower, [arg strings])]
    (ref: pkg/util/hint hintparser — the subset the planner consumes;
    unknown hints pass through and are ignored there)."""
    import re as _re

    out = []
    for m in _re.finditer(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:\(([^()]*)\))?", text):
        name = m.group(1).lower()
        raw = (m.group(2) or "").strip()
        args = [a.strip().strip("`'\"") for a in _re.split(r"[,\s]+", raw) if a.strip()] if raw else []
        out.append((name, args))
    return out


class Parser:
    def __init__(self, sql: str):
        self._named_window_refs: list = []
        self.sql = sql
        try:
            self.toks = tokenize(sql)
        except LexError as e:
            raise ParseError(str(e)) from e
        self.i = 0
        self.n_params = 0

    # ---- token helpers ----
    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind is not T.EOF:
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind is T.IDENT and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.eat_kw(kw):
            raise ParseError(f"expected {kw} at {self._where()}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind is T.OP and t.text in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str):
        if not self.eat_op(op):
            raise ParseError(f"expected {op!r} at {self._where()}")

    def _where(self) -> str:
        t = self.peek()
        frag = self.sql[max(0, t.pos - 20) : t.pos + 20]
        return f"token {t.text!r} (…{frag}…)"

    def ident(self) -> str:
        t = self.peek()
        if t.kind in (T.IDENT, T.QIDENT):
            self.i += 1
            return t.text
        raise ParseError(f"expected identifier at {self._where()}")

    def expect_number(self) -> int:
        t = self.peek()
        if t.kind is T.NUMBER:
            self.i += 1
            return int(t.text)
        raise ParseError(f"expected number at {self._where()}")

    # ---- statements ----
    def parse_statements(self) -> list:
        out = []
        while self.peek().kind is not T.EOF:
            if self.eat_op(";"):
                continue
            out.append(self.statement())
            if self.peek().kind is not T.EOF:
                self.expect_op(";")
        return out

    def statement(self):
        t = self.peek()
        if t.kind is not T.IDENT:
            if t.kind is T.OP and t.text == "(":
                return self.select_or_union()
            raise ParseError(f"unexpected {self._where()}")
        kw = t.upper
        if kw in ("SELECT", "WITH"):
            return self.select_or_union()
        if kw == "INSERT" or kw == "REPLACE":
            return self.insert_stmt(replace=kw == "REPLACE")
        if kw == "UPDATE":
            return self.update_stmt()
        if kw == "DELETE":
            return self.delete_stmt()
        if kw == "GRANT":
            return self.grant_stmt(revoke=False)
        if kw == "REVOKE":
            return self.grant_stmt(revoke=True)
        if kw == "CREATE":
            return self.create_stmt()
        if kw == "DROP":
            return self.drop_stmt()
        if kw == "ALTER":
            return self.alter_stmt()
        if kw == "RENAME":
            return self.rename_stmt()
        if kw == "TRUNCATE":
            self.next()
            self.eat_kw("TABLE")
            return A.TruncateTableStmt(self.table_name())
        if kw == "SET":
            return self.set_stmt()
        if kw == "USE":
            self.next()
            return A.UseStmt(self.ident())
        if kw == "SHOW":
            return self.show_stmt()
        if kw in ("EXPLAIN", "DESC", "DESCRIBE"):
            return self.explain_stmt()
        if kw == "ANALYZE":
            return self.analyze_stmt()
        if kw in ("BEGIN", "START"):
            self.next()
            self.eat_kw("TRANSACTION")
            self.eat_kw("PESSIMISTIC") or self.eat_kw("OPTIMISTIC")
            if self.eat_kw("WITH"):
                self.expect_kw("CONSISTENT")
                self.expect_kw("SNAPSHOT")
            if self.eat_kw("READ"):
                self.eat_kw("ONLY") or self.eat_kw("WRITE")
                if self.eat_kw("AS"):  # AS OF TIMESTAMP ... (stale read)
                    self.expect_kw("OF")
                    self.expect_kw("TIMESTAMP")
                    self.expr()
            return A.BeginStmt()
        if kw == "SAVEPOINT":
            self.next()
            return A.SavepointStmt("set", self.ident().lower())
        if kw == "RELEASE":
            self.next()
            self.expect_kw("SAVEPOINT")
            return A.SavepointStmt("release", self.ident().lower())
        if kw == "COMMIT":
            self.next()
            return A.CommitStmt()
        if kw == "ROLLBACK":
            self.next()
            if self.eat_kw("TO"):
                self.eat_kw("SAVEPOINT")
                return A.SavepointStmt("rollback", self.ident().lower())
            return A.RollbackStmt()
        if kw == "PREPARE":
            self.next()
            name = self.ident()
            self.expect_kw("FROM")
            s = self.next()
            if s.kind is not T.STRING:
                raise ParseError("PREPARE ... FROM expects a string")
            return A.PrepareStmt(name, s.text)
        if kw == "EXECUTE":
            self.next()
            name = self.ident()
            using = []
            if self.eat_kw("USING"):
                while True:
                    self.expect_op("@")
                    using.append(self.ident())
                    if not self.eat_op(","):
                        break
            return A.ExecuteStmt(name, using)
        if kw == "DEALLOCATE":
            self.next()
            self.eat_kw("PREPARE")
            return A.DeallocateStmt(self.ident())
        if kw == "ADMIN":
            return self.admin_stmt()
        if kw == "KILL":
            # KILL [TIDB] [CONNECTION|QUERY] id (ref: parser.y KillStmt)
            self.next()
            self.eat_kw("TIDB")
            q = self.eat_kw("QUERY")
            if not q:
                self.eat_kw("CONNECTION")
            return A.KillStmt(self.expect_number(), q)
        if kw == "LOAD":
            if self.peek(1).kind is T.IDENT and self.peek(1).upper == "STATS":
                self.next()
                self.next()
                return A.LoadStatsStmt(self.next().text)
            return self.load_data_stmt()
        if kw == "IMPORT":
            self.next()
            self.expect_kw("INTO")
            table = self.table_name()
            cols = []
            if self.at_op("("):
                self.expect_op("(")
                while not self.at_op(")"):
                    cols.append(self.next().text)
                    self.eat_op(",")
                self.expect_op(")")
            self.expect_kw("FROM")
            path = self.next().text
            opts = {}
            if self.eat_kw("FORMAT"):
                opts["format"] = self.next().text
            if self.eat_kw("WITH"):
                while True:
                    k = self.ident()
                    v = True
                    if self.eat_op("="):
                        v = self.next().text
                    opts[k] = v
                    if not self.eat_op(","):
                        break
            return A.ImportIntoStmt(table, cols, path, opts)
        if kw == "BATCH":
            # BATCH [ON col] LIMIT n <dml> (non-transactional DML)
            self.next()
            col_name = ""
            if self.eat_kw("ON"):
                col_name = self.ident()
                while self.eat_op("."):
                    col_name = self.ident()
            self.expect_kw("LIMIT")
            n = self.expect_number()
            return A.BatchStmt(col_name, n, self.statement())
        if kw == "SPLIT":
            return self.split_stmt()
        if kw in ("BACKUP", "RESTORE"):
            return self.brie_stmt(kw.lower())
        if kw == "STOP":
            # STOP BACKUP LOG TO 'file://dir' (ref: `br log
            # stop`): detach the log backup attached at that destination
            self.next()
            self.expect_kw("BACKUP")
            if not self.eat_kw("LOG", "LOGS"):
                raise ParseError(f"expected LOG at {self._where()}")
            self.expect_kw("TO")
            return A.BRIEStmt("stop_backup_log", self.next().text)
        if kw == "TRACE":
            self.next()
            fmt = "row"
            if self.eat_kw("FORMAT"):
                self.eat_op("=")
                fmt = self.next().text.lower()
                if fmt not in ("row", "json"):
                    raise ParseError(f"TRACE FORMAT {fmt!r} not supported (row|json)")
            return A.TraceStmt(self.statement(), fmt)
        if kw in ("PAUSE", "RESUME"):
            # PAUSE/RESUME CHANGEFEED name (ref: TiCDC changefeed
            # pause/resume, SQL-ified like BACKUP/RESTORE)
            self.next()
            self.expect_kw("CHANGEFEED")
            return A.ChangefeedStmt(kw.lower(), self.ident())
        if kw == "FLASHBACK":
            self.next()
            self.expect_kw("TABLE")
            tbl = self.table_name()
            new = ""
            if self.eat_kw("TO"):
                new = self.ident()
            return A.FlashbackStmt(tbl, new)
        raise ParseError(f"unsupported statement start {kw} at {self._where()}")

    # ---- SELECT / UNION ----
    def select_or_union(self):
        ctes = self.with_clause() if self.at_kw("WITH") else []
        paren = self.at_op("(")
        selects = [self.single_select()]
        paren_flags = [paren]
        all_flags = []
        ops = []
        while self.at_kw("UNION", "EXCEPT", "INTERSECT"):
            ops.append(self.next().upper.lower())
            all_flags.append(self.eat_kw("ALL") or (self.eat_kw("DISTINCT") and False))
            paren_flags.append(self.at_op("("))
            selects.append(self.single_select())
        if len(selects) == 1:
            s = selects[0]
            if ctes:
                s.ctes = ctes + getattr(s, "ctes", [])
            # (SELECT ...) ORDER BY ... LIMIT ...: a parenthesized branch does
            # not swallow trailing clauses. If the branch already has its own
            # ORDER/LIMIT the outer ones apply AFTER it (MySQL derived-result
            # semantics) — represent that as a single-branch SetOprStmt so
            # neither clause set is lost.
            if paren_flags[0] and (self.at_kw("ORDER") or self.at_kw("LIMIT")):
                order_by, limit = [], None
                if self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    order_by = self.by_list()
                if self.at_kw("LIMIT"):
                    limit = self.limit_clause()
                if getattr(s, "order_by", None) or getattr(s, "limit", None):
                    return A.SetOprStmt([s], [], order_by, limit, ops=[], ctes=ctes)
                s.order_by, s.limit = order_by, limit
            return s
        order_by, limit = [], None
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.by_list()
        if self.at_kw("LIMIT"):
            limit = self.limit_clause()
        # MySQL binds a trailing ORDER BY/LIMIT to the whole union; the last
        # branch will have swallowed it — hoist it up, but only when the
        # branch was NOT parenthesized (a parenthesized branch's ORDER/LIMIT
        # is branch-local).
        last = selects[-1]
        if not order_by and not limit and not paren_flags[-1] and isinstance(last, A.SelectStmt):
            order_by, limit = last.order_by, last.limit
            last.order_by, last.limit = [], None
        return A.SetOprStmt(selects, all_flags, order_by, limit, ops=ops, ctes=ctes)

    def with_clause(self) -> list:
        """WITH [RECURSIVE] name [(cols)] AS (subquery), ...
        (ref: parser.y WithClause; ast.CommonTableExpression)."""
        self.expect_kw("WITH")
        recursive = self.eat_kw("RECURSIVE")
        ctes = []
        while True:
            name = self.ident()
            cols = []
            if self.eat_op("("):
                while True:
                    cols.append(self.ident())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            self.expect_kw("AS")
            self.expect_op("(")
            sub = self.select_or_union()
            self.expect_op(")")
            ctes.append(A.CTE(name, cols, sub, recursive))
            if not self.eat_op(","):
                break
        return ctes

    def single_select(self) -> A.SelectStmt:
        _win_refs_start = len(self._named_window_refs)
        if self.eat_op("("):
            s = self.select_or_union()
            self.expect_op(")")
            return s
        self.expect_kw("SELECT")
        hints = []
        if self.peek().kind is T.HINT:
            hints = _parse_hints(self.next().text)
        distinct = False
        while True:
            if self.eat_kw("DISTINCT", "DISTINCTROW"):
                distinct = True
            elif self.eat_kw("ALL", "SQL_CALC_FOUND_ROWS", "STRAIGHT_JOIN", "SQL_NO_CACHE", "HIGH_PRIORITY"):
                pass
            else:
                break
        fields = [self.select_field()]
        while self.eat_op(","):
            fields.append(self.select_field())
        frm = None
        if self.eat_kw("FROM"):
            frm = self.table_refs()
        where = self.expr() if self.eat_kw("WHERE") else None
        group_by, having = [], None
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            group_by = self.by_list()
            self.eat_kw("WITH") and self.expect_kw("ROLLUP")
        if self.eat_kw("HAVING"):
            having = self.expr()
        named = {}
        if self.eat_kw("WINDOW"):
            # named windows: WINDOW w AS (spec)[, ...]
            while True:
                wname = self.ident().lower()
                self.expect_kw("AS")
                named[wname] = self.window_spec()
                if not self.eat_op(","):
                    break
        order_by = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.by_list()
        limit = self.limit_clause() if self.at_kw("LIMIT") else None
        # resolve OVER w references only AFTER ORDER BY/LIMIT parse: a
        # window function in ORDER BY may legally name a WINDOW-clause
        # window (MySQL window resolution is per query block, clause order
        # notwithstanding)
        if named:
            # only THIS query block's refs (index >= _win_refs_start):
            # a subquery inside ORDER BY parses while the outer refs are
            # still pending, and windows are block-scoped in MySQL
            mine = self._named_window_refs[_win_refs_start:]
            for wf, ref in mine:
                if ref in named:
                    part, order, frame = named[ref]
                    wf.partition_by, wf.order_by, wf.has_frame = part, order, frame
            self._named_window_refs = self._named_window_refs[:_win_refs_start] + [
                (wf, ref) for wf, ref in mine if ref not in named
            ]
        if len(self._named_window_refs) > _win_refs_start:
            _, missing = self._named_window_refs[-1]
            raise ParseError(f"Window {missing!r} is not defined")
        for_update = False
        if self.eat_kw("FOR"):
            self.expect_kw("UPDATE")
            for_update = True
            if self.eat_kw("OF"):
                self.ident()
            self.eat_kw("NOWAIT") or (self.eat_kw("SKIP") and self.expect_kw("LOCKED"))
        elif self.eat_kw("LOCK"):
            self.expect_kw("IN")
            self.expect_kw("SHARE")
            self.expect_kw("MODE")
        return A.SelectStmt(fields, frm, where, group_by, having, order_by, limit, distinct, for_update, hints=hints)

    def select_field(self):
        if self.at_op("*"):
            self.next()
            return A.SelectField(A.Star(), "")
        # t.* / db.t.*
        if self.peek().kind in (T.IDENT, T.QIDENT):
            j = self.i
            name = self.ident()
            if self.at_op(".") and self.peek(1).kind in (T.IDENT, T.QIDENT) and self.peek(2).kind is T.OP and self.peek(2).text == "." and self.peek(3).kind is T.OP and self.peek(3).text == "*":
                self.next()
                tbl = self.ident()
                self.next()
                self.next()
                return A.SelectField(A.Star(table=tbl, db=name), "")
            if self.at_op(".") and self.peek(1).kind is T.OP and self.peek(1).text == "*":
                self.next()
                self.next()
                return A.SelectField(A.Star(table=name), "")
            self.i = j
        src_start = self.peek().pos
        e = self.expr()
        src_end = self.peek().pos if self.peek().kind is not T.EOF else len(self.sql)
        source = self.sql[src_start:src_end].strip()
        alias = ""
        if self.eat_kw("AS"):
            t = self.next()
            if t.kind in (T.IDENT, T.QIDENT, T.STRING):
                alias = t.text
            else:
                raise ParseError(f"bad alias at {self._where()}")
        elif self.peek().kind in (T.IDENT, T.QIDENT) and self.peek().upper not in _RESERVED_AFTER_EXPR:
            alias = self.next().text
        return A.SelectField(e, alias, source)

    def by_list(self) -> list:
        out = []
        while True:
            e = self.expr()
            desc = False
            if self.eat_kw("DESC"):
                desc = True
            else:
                self.eat_kw("ASC")
            out.append(A.ByItem(e, desc))
            if not self.eat_op(","):
                break
        return out

    def limit_clause(self) -> A.Limit:
        self.expect_kw("LIMIT")
        a = self.simple_limit_value()
        if self.eat_op(","):
            return A.Limit(self.simple_limit_value(), a)
        if self.eat_kw("OFFSET"):
            return A.Limit(a, self.simple_limit_value())
        return A.Limit(a)

    def simple_limit_value(self):
        t = self.peek()
        if t.kind is T.NUMBER:
            self.next()
            return A.Literal(int(t.text), "int", pos=t.pos)
        if t.kind is T.PARAM:
            self.next()
            p = A.ParamMarker(self.n_params, pos=t.pos)
            self.n_params += 1
            return p
        raise ParseError(f"expected LIMIT count at {self._where()}")

    # ---- table refs ----
    def table_refs(self):
        left = self.table_factor()
        while True:
            natural = False
            if self.at_kw("NATURAL"):
                natural = True
                self.next()
            if self.eat_op(","):
                right = self.table_factor()
                left = A.Join(left, right, "cross")
                continue
            if self.eat_kw("STRAIGHT_JOIN"):
                right = self.table_factor()
                on, using = None, []
                if self.eat_kw("ON"):
                    on = self.expr()
                elif self.eat_kw("USING"):
                    self.expect_op("(")
                    while True:
                        using.append(self.ident())
                        if not self.eat_op(","):
                            break
                    self.expect_op(")")
                left = A.Join(left, right, "inner", on, using)
                continue
            kind = None
            if self.at_kw("JOIN", "INNER", "CROSS"):
                if self.eat_kw("INNER") or self.eat_kw("CROSS"):
                    pass
                self.expect_kw("JOIN")
                kind = "inner"
            elif self.at_kw("LEFT", "RIGHT"):
                kind = "left" if self.eat_kw("LEFT") else (self.eat_kw("RIGHT") and "right")
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
            else:
                break
            right = self.table_factor()
            on, using = None, []
            if not natural:
                if self.eat_kw("ON"):
                    on = self.expr()
                elif self.eat_kw("USING"):
                    self.expect_op("(")
                    while True:
                        using.append(self.ident())
                        if not self.eat_op(","):
                            break
                    self.expect_op(")")
            left = A.Join(left, right, kind, on, using)
        return left

    def table_factor(self):
        if self.eat_op("("):
            if self.at_kw("SELECT", "WITH") or self.at_op("("):
                sub = self.select_or_union()
                self.expect_op(")")
                self.eat_kw("AS")
                alias = self.ident()
                return A.SubqueryTable(sub, alias)
            refs = self.table_refs()
            self.expect_op(")")
            return refs
        return self.table_name(allow_alias=True)

    def table_name(self, allow_alias: bool = False) -> A.TableName:
        name = self.ident()
        db = ""
        if self.eat_op("."):
            db, name = name, self.ident()
        alias = ""
        hints = []
        if allow_alias and self.at_kw("PARTITION"):
            self.next()
            self.expect_op("(")
            parts = [self._partition_name()]
            while self.eat_op(","):
                parts.append(self._partition_name())
            self.expect_op(")")
            hints.append(("partition", parts))
        if allow_alias:
            if self.eat_kw("AS"):
                alias = self.ident()
            elif self.peek().kind in (T.IDENT, T.QIDENT) and self.peek().upper not in _RESERVED_AFTER_EXPR and self.peek().upper not in ("USE", "IGNORE", "FORCE", "PARTITION", "TABLESAMPLE"):
                alias = self.next().text
            while self.at_kw("USE", "IGNORE", "FORCE"):
                kind = self.next().upper.lower()
                self.expect_kw("INDEX") if self.at_kw("INDEX") else self.expect_kw("KEY")
                if self.eat_kw("FOR"):
                    if self.eat_kw("ORDER") or self.eat_kw("GROUP"):
                        self.expect_kw("BY")
                    else:
                        self.expect_kw("JOIN")
                self.expect_op("(")
                idxs = []
                if not self.at_op(")"):
                    while True:
                        idxs.append(self.ident())
                        if not self.eat_op(","):
                            break
                self.expect_op(")")
                hints.append((kind, idxs))
            if self.eat_kw("TABLESAMPLE"):
                self.expect_kw("REGIONS")
                self.expect_op("(")
                self.expect_op(")")
                hints.append(("tablesample", ["regions"]))
        return A.TableName(name, db, alias, hints)

    # ---- expressions: precedence climbing ----
    def expr(self) -> A.ExprNode:
        return self.or_expr()

    def or_expr(self):
        left = self.xor_expr()
        while True:
            if self.eat_kw("OR") or self.eat_op("||"):
                left = A.BinaryOp("or", left, self.xor_expr())
            else:
                return left

    def xor_expr(self):
        left = self.and_expr()
        while self.eat_kw("XOR"):
            left = A.BinaryOp("xor", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while True:
            if self.eat_kw("AND") or self.eat_op("&&"):
                left = A.BinaryOp("and", left, self.not_expr())
            else:
                return left

    def not_expr(self):
        if self.eat_kw("NOT"):
            return A.UnaryOp("not", self.not_expr())
        return self.predicate()

    _CMP = {"=": "eq", "<=>": "nulleq", "<": "lt", "<=": "le", ">": "gt", ">=": "ge", "<>": "ne", "!=": "ne"}

    def predicate(self):
        left = self.bit_or_expr()
        while True:
            t = self.peek()
            if t.kind is T.OP and t.text in self._CMP:
                op = self._CMP[self.next().text]
                if self.at_kw("ANY", "SOME", "ALL"):
                    is_all = self.next().upper == "ALL"
                    self.expect_op("(")
                    sub = self.select_or_union()
                    self.expect_op(")")
                    left = A.CompareSubquery(left, op, sub, is_all)
                else:
                    left = A.BinaryOp(op, left, self.bit_or_expr())
                continue
            if self.at_kw("MEMBER"):
                self.next()
                self.expect_kw("OF")
                self.expect_op("(")
                arr = self.expr()
                self.expect_op(")")
                left = A.FuncCall("json_member_of", [left, arr])
                continue
            negated = False
            j = self.i
            if self.at_kw("NOT"):
                if self.peek(1).kind is T.IDENT and self.peek(1).upper in ("IN", "LIKE", "BETWEEN", "REGEXP", "RLIKE"):
                    self.next()
                    negated = True
                else:
                    self.i = j
                    return left
            if self.eat_kw("IS"):
                neg = self.eat_kw("NOT")
                if self.eat_kw("NULL"):
                    left = A.IsNull(left, neg)
                elif self.eat_kw("TRUE"):
                    left = A.IsTruth(left, True, neg)
                elif self.eat_kw("FALSE"):
                    left = A.IsTruth(left, False, neg)
                else:
                    raise ParseError(f"IS what? at {self._where()}")
                continue
            if self.eat_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    sub = self.select_or_union()
                    self.expect_op(")")
                    left = A.InSubquery(left, sub, negated)
                else:
                    items = [self.expr()]
                    while self.eat_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = A.InList(left, items, negated)
                continue
            if self.eat_kw("BETWEEN"):
                lo = self.bit_or_expr()
                self.expect_kw("AND")
                hi = self.bit_or_expr()
                left = A.Between(left, lo, hi, negated)
                continue
            if self.eat_kw("LIKE"):
                pat = self.bit_or_expr()
                esc = "\\"
                if self.eat_kw("ESCAPE"):
                    esc_t = self.next()
                    esc = esc_t.text
                left = A.Like(left, pat, esc, negated)
                continue
            if self.eat_kw("REGEXP", "RLIKE"):
                left = A.Regexp(left, self.bit_or_expr(), negated)
                continue
            return left

    def bit_or_expr(self):
        left = self.bit_and_expr()
        while self.at_op("|") and not self.at_op("||"):
            self.next()
            left = A.BinaryOp("bitor", left, self.bit_and_expr())
        return left

    def bit_and_expr(self):
        left = self.shift_expr()
        while self.at_op("&"):
            self.next()
            left = A.BinaryOp("bitand", left, self.shift_expr())
        return left

    def shift_expr(self):
        left = self.add_expr()
        while self.at_op("<<", ">>"):
            op = "shiftleft" if self.next().text == "<<" else "shiftright"
            left = A.BinaryOp(op, left, self.add_expr())
        return left

    def add_expr(self):
        left = self.mul_expr()
        while True:
            if self.at_op("+"):
                self.next()
                right = self.mul_expr()
                # date + INTERVAL n unit
                if isinstance(right, A.Interval):
                    left = A.FuncCall("date_add", [left, right])
                else:
                    left = A.BinaryOp("plus", left, right)
            elif self.at_op("-"):
                self.next()
                right = self.mul_expr()
                if isinstance(right, A.Interval):
                    left = A.FuncCall("date_sub", [left, right])
                else:
                    left = A.BinaryOp("minus", left, right)
            else:
                return left

    def mul_expr(self):
        left = self.xor_bit_expr()
        while True:
            if self.at_op("*"):
                self.next()
                left = A.BinaryOp("mul", left, self.xor_bit_expr())
            elif self.at_op("/"):
                self.next()
                left = A.BinaryOp("div", left, self.xor_bit_expr())
            elif self.at_op("%") or self.at_kw("MOD"):
                self.next()
                left = A.BinaryOp("mod", left, self.xor_bit_expr())
            elif self.at_kw("DIV"):
                self.next()
                left = A.BinaryOp("intdiv", left, self.xor_bit_expr())
            else:
                return left

    def xor_bit_expr(self):
        left = self.unary_expr()
        while self.at_op("^"):
            self.next()
            left = A.BinaryOp("bitxor", left, self.unary_expr())
        return left

    def unary_expr(self):
        if self.at_op("-"):
            self.next()
            return A.UnaryOp("unaryminus", self.unary_expr())
        if self.at_op("+"):
            self.next()
            return self.unary_expr()
        if self.at_op("~"):
            self.next()
            return A.UnaryOp("bitneg", self.unary_expr())
        if self.at_op("!"):
            # '!' binds at unary precedence (above comparison/IN/LIKE),
            # unlike NOT (ref: parser.y precedence: '!' ~ NEG level)
            self.next()
            return A.UnaryOp("not", self.unary_expr())
        if self.at_kw("BINARY"):
            # BINARY expr — treat as cast to binary string (collation change)
            j = self.i
            self.next()
            if self.peek().kind in (T.IDENT, T.QIDENT, T.STRING, T.NUMBER) or self.at_op("("):
                return A.Cast(self.unary_expr(), A.TypeSpec("binary"))
            self.i = j
        return self._collate_tail(self.primary())

    def _collate_tail(self, node):
        while True:
            if self.eat_kw("COLLATE"):
                node = A.CollateExpr(node, self.ident().lower())
            elif self.at_op("->") or self.at_op("->>"):
                # JSON path operators (ref: parser.y: col->path ==
                # json_extract, ->> wraps json_unquote)
                unq = self.next().text == "->>"
                ptok = self.next()
                if ptok.kind is not T.STRING:
                    raise ParseError(f"expected JSON path string at {self._where()}")
                node = A.FuncCall("json_extract", [node, A.Literal(ptok.text, "str", pos=ptok.pos)])
                if unq:
                    node = A.FuncCall("json_unquote", [node])
            else:
                return node

    def primary(self) -> A.ExprNode:
        t = self.peek()
        if (
            t.kind is T.IDENT
            and t.text.startswith("_")
            and t.text.lower() in ("_utf8", "_utf8mb4", "_binary", "_latin1", "_ascii", "_gbk")
            and self.peek(1).kind is T.STRING
        ):
            self.next()
            s = self.next()
            return A.Literal(s.text, "str", pos=s.pos)
        # hex/bit literals: X'1A2B', B'1010' (ref: parser.y HexLiteral/BitLiteral)
        if t.kind is T.IDENT and t.upper == "N" and self.peek(1).kind is T.STRING:
            self.next()
            s = self.next()
            return A.Literal(s.text, "str", pos=s.pos)
        if (
            t.kind is T.IDENT
            and t.upper in ("X", "B")
            and self.peek(1).kind is T.STRING
        ):
            self.next()
            raw = self.next().text
            try:
                v = int(raw, 16 if t.upper == "X" else 2) if raw else 0
            except ValueError:
                raise ParseError(f"bad {t.upper}-literal at {self._where()}")
            return A.Literal(v, "int", pos=-2)  # value != token text: not slot-bindable
        if t.kind is T.NUMBER:
            self.next()
            if "." in t.text or "e" in t.text.lower():
                kind = "float" if ("e" in t.text.lower()) else "decimal"
                return A.Literal(t.text, kind, pos=t.pos)
            return A.Literal(int(t.text), "int", pos=t.pos)
        if t.kind is T.STRING:
            self.next()
            # adjacent string literal concat 'a' 'b' (a multi-token literal
            # cannot bind by slot position: pos sentinel -2)
            text, pos = t.text, t.pos
            while self.peek().kind is T.STRING:
                text += self.next().text
                pos = -2
            return A.Literal(text, "str", pos=pos)
        if t.kind is T.HEX:
            self.next()
            h = t.text[2:]
            if len(h) % 2:
                h = "0" + h
            return A.Literal(bytes.fromhex(h), "hex")
        if t.kind is T.PARAM:
            self.next()
            p = A.ParamMarker(self.n_params, pos=t.pos)
            self.n_params += 1
            return p
        if t.kind is T.OP and t.text == "(":
            self.next()
            if self.at_kw("SELECT", "WITH"):
                sub = self.select_or_union()
                self.expect_op(")")
                return A.SubqueryExpr(sub)
            e = self.expr()
            if self.eat_op(","):
                items = [e, self.expr()]
                while self.eat_op(","):
                    items.append(self.expr())
                self.expect_op(")")
                return A.RowExpr(items)
            self.expect_op(")")
            return e
        if t.kind is T.OP and t.text == "@":
            self.next()
            if self.eat_op("@"):
                scope = ""
                name = self.ident()
                if name.lower() in ("global", "session") and self.eat_op("."):
                    scope = name.lower()
                    name = self.ident()
                return A.Variable(name.lower(), True, scope)
            return A.Variable(self.ident().lower(), False)
        if t.kind is T.QIDENT:
            return self.column_or_func()
        if t.kind is T.IDENT:
            kw = t.upper
            if kw == "NULL":
                self.next()
                return A.Literal(None, "null")
            if kw == "TRUE":
                self.next()
                return A.Literal(1, "bool")
            if kw == "FALSE":
                self.next()
                return A.Literal(0, "bool")
            if kw == "CASE":
                return self.case_expr()
            if kw == "CAST" or kw == "CONVERT":
                return self.cast_expr(kw)
            if kw == "EXISTS":
                self.next()
                self.expect_op("(")
                sub = self.select_or_union()
                self.expect_op(")")
                return A.Exists(sub)
            if kw == "NOT":
                self.next()
                return A.UnaryOp("not", self.not_expr())
            if kw == "INTERVAL":
                self.next()
                v = self.bit_or_expr()
                unit = self.ident().lower()
                return A.Interval(v, unit)
            if kw == "DEFAULT" and not (self.peek(1).kind is T.OP and self.peek(1).text == "("):
                self.next()
                return A.Default()
            if kw in ("DATE", "TIME", "TIMESTAMP") and self.peek(1).kind is T.STRING:
                self.next()
                s = self.next()
                return A.FuncCall("cast_literal_" + kw.lower(), [A.Literal(s.text, "str", pos=s.pos)])
            return self.column_or_func()
        raise ParseError(f"unexpected {self._where()}")

    def case_expr(self):
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        whens = []
        while self.eat_kw("WHEN"):
            cond = self.expr()
            self.expect_kw("THEN")
            whens.append((cond, self.expr()))
        els = self.expr() if self.eat_kw("ELSE") else None
        self.expect_kw("END")
        return A.Case(operand, whens, els)

    def cast_expr(self, kw: str):
        self.next()
        self.expect_op("(")
        e = self.expr()
        if kw == "CAST":
            self.expect_kw("AS")
            ts = self.type_spec()
        elif self.eat_kw("USING"):  # CONVERT(expr USING charset)
            cs = self.ident().lower()
            self.expect_op(")")
            return A.FuncCall("convert_using", [e, A.Literal(cs, "str")])
        else:  # CONVERT(expr, type)
            self.expect_op(",")
            ts = self.type_spec()
        self.expect_op(")")
        return A.Cast(e, ts)

    _EXTRACT_UNITS = {
        "MICROSECOND", "SECOND", "MINUTE", "HOUR", "DAY", "WEEK", "MONTH",
        "QUARTER", "YEAR", "SECOND_MICROSECOND", "MINUTE_MICROSECOND",
        "MINUTE_SECOND", "HOUR_MICROSECOND", "HOUR_SECOND", "HOUR_MINUTE",
        "DAY_MICROSECOND", "DAY_SECOND", "DAY_MINUTE", "DAY_HOUR",
        "YEAR_MONTH",
    }

    def column_or_func(self) -> A.ExprNode:
        quoted = self.peek().kind is T.QIDENT  # `max`(x) is never a call
        name = self.ident()
        # function call?
        if self.at_op("(") and not quoted:
            lname = name.lower()
            self.next()
            if lname in ("substring", "substr", "mid") and not self.at_op(")"):
                # SUBSTRING(str FROM pos [FOR len]) (ref: parser.y
                # SubstringExpr); the comma form reuses the generic
                # argument loop below
                e = self.expr()
                if self.eat_kw("FROM"):
                    pos = self.expr()
                    args = [e, pos]
                    if self.eat_kw("FOR"):
                        args.append(self.expr())
                    self.expect_op(")")
                    return A.FuncCall("substr", args)
                args = [e]
                while self.eat_op(","):
                    args.append(self.expr())
                self.expect_op(")")
                return A.FuncCall(lname, args)
            if lname == "extract" and self.peek().upper in self._EXTRACT_UNITS:
                # EXTRACT(unit FROM expr) (ref: parser.y ExtractExpr)
                unit = self.next().upper.lower()
                self.expect_kw("FROM")
                e = self.expr()
                self.expect_op(")")
                return A.FuncCall("extract", [A.Literal(unit, "str"), e])
            distinct = False
            if lname in _AGG_FUNCS and self.eat_kw("DISTINCT"):
                distinct = True
            args: list = []
            if self.at_op("*"):
                self.next()
                args = [A.Star()]
            elif not self.at_op(")"):
                args.append(self.func_arg())
                while self.eat_op(","):
                    args.append(self.func_arg())
            gc_order, gc_sep = [], None
            if lname == "group_concat":
                # GROUP_CONCAT(expr [ORDER BY ...] [SEPARATOR str]) — the
                # trailing clauses follow the arg without a comma
                if self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    gc_order = self.by_list()
                if self.eat_kw("SEPARATOR"):
                    gc_sep = self.next().text
            self.expect_op(")")
            if self.at_kw("OVER"):
                self.next()
                if distinct:
                    raise ParseError(f"DISTINCT is not allowed in window function {lname!r}")
                if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                    # OVER w — named window, resolved after the WINDOW clause
                    wf = A.WindowFunc(lname, args, [], [], False)
                    self._named_window_refs.append((wf, self.ident().lower()))
                    return wf
                part, order, frame = self.window_spec()
                return A.WindowFunc(lname, args, part, order, frame)
            if lname in _AGG_FUNCS:
                return A.AggFunc(lname, args, distinct, gc_order, gc_sep)
            return A.FuncCall(lname, args)
        # qualified column
        table = db = ""
        if self.eat_op("."):
            table, name = name, self.ident()
            if self.eat_op("."):
                db, table, name = table, name, self.ident()
        return A.ColumnName(name, table, db)

    def func_arg(self):
        return self.expr()

    def _frame_bound(self):
        if self.eat_kw("UNBOUNDED"):
            self.eat_kw("PRECEDING") or self.eat_kw("FOLLOWING")
        elif self.eat_kw("CURRENT"):
            self.expect_kw("ROW")
        else:
            if self.at_kw("INTERVAL"):
                self.expr()
            else:
                self.next()  # numeric offset
            self.eat_kw("PRECEDING") or self.eat_kw("FOLLOWING")

    def _frame_clause(self):
        """ROWS/RANGE [BETWEEN a AND b | bound] — parsed into the window
        spec; explicit frames route to the oracle (ops/window.py)."""
        self.next()  # ROWS | RANGE
        if self.eat_kw("BETWEEN"):
            self._frame_bound()
            self.expect_kw("AND")
            self._frame_bound()
        else:
            self._frame_bound()

    def window_spec(self):
        """OVER ( [PARTITION BY exprs] [ORDER BY items] [frame] ) —
        explicit ROWS/RANGE frames parse (corpus coverage) and flag the
        WindowFunc; the planner rejects non-default frames at lowering."""
        self.expect_op("(")
        part: list = []
        order: list = []
        frame = False
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            part.append(self.expr())
            while self.eat_op(","):
                part.append(self.expr())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order = self.by_list()
        if self.at_kw("ROWS", "RANGE", "GROUPS"):
            self._frame_clause()
            frame = True
        self.expect_op(")")
        return part, order, frame

    # ---- type spec ----
    def type_spec(self) -> A.TypeSpec:
        name = self.ident().lower()
        if name == "national":
            name = self.ident().lower()
        if name not in _TYPE_NAMES:
            raise ParseError(f"unknown type {name!r} at {self._where()}")
        if name in ("signed", "unsigned"):
            # CAST(x AS UNSIGNED [INT|INTEGER]) — eat the optional keyword
            self.eat_kw("INT", "INTEGER")
        if name in ("integer",):
            name = "int"
        if name in ("numeric", "dec", "fixed"):
            name = "decimal"
        if name in ("bool", "boolean"):
            name = "tinyint"
        if name == "real":
            name = "double"
        length = dec = -1
        if self.eat_op("("):
            if name in ("enum", "set"):
                elems = []
                while True:
                    s = self.next()
                    elems.append(s.text)
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                ts = A.TypeSpec(name, elems=tuple(elems))
                return self._type_attrs(ts)
            length = self.expect_number()
            if self.eat_op(","):
                dec = self.expect_number()
            self.expect_op(")")
        ts = A.TypeSpec(name, length, dec)
        return self._type_attrs(ts)

    def _type_attrs(self, ts: A.TypeSpec) -> A.TypeSpec:
        if self.eat_kw("ARRAY"):
            pass  # CAST(... AS t ARRAY) — multi-valued index form
        while True:
            if self.eat_kw("UNSIGNED"):
                ts.unsigned = True
            elif self.eat_kw("SIGNED"):
                pass
            elif self.eat_kw("ZEROFILL"):
                ts.zerofill = True
            elif self.eat_kw("CHARACTER"):
                self.expect_kw("SET")
                ts.charset = self.ident().lower()
            elif self.eat_kw("CHARSET"):
                ts.charset = self.ident().lower()
            elif self.eat_kw("COLLATE"):
                ts.collate = self.ident().lower()
            else:
                return ts

    # ---- DML ----
    def insert_stmt(self, replace: bool) -> A.InsertStmt:
        self.next()
        self.eat_kw("LOW_PRIORITY") or self.eat_kw("DELAYED") or self.eat_kw("HIGH_PRIORITY")
        ignore = self.eat_kw("IGNORE")
        self.eat_kw("INTO")
        table = self.table_name()
        if self.eat_kw("PARTITION"):
            self.expect_op("(")
            self._partition_name()
            while self.eat_op(","):
                self._partition_name()
            self.expect_op(")")
        columns = []
        if self.at_op("(") and not self._paren_is_select():
            self.next()
            while True:
                columns.append(self.ident())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        values, select = [], None
        if self.eat_kw("VALUES", "VALUE"):
            while True:
                self.expect_op("(")
                row = []
                if not self.at_op(")"):
                    row.append(self.expr())
                    while self.eat_op(","):
                        row.append(self.expr())
                self.expect_op(")")
                values.append(row)
                if not self.eat_op(","):
                    break
        elif self.at_kw("SELECT", "WITH") or self.at_op("("):
            select = self.select_or_union()
        elif self.eat_kw("SET"):
            cols, row = [], []
            while True:
                cols.append(self.ident())
                self.expect_op("=")
                row.append(self.expr())
                if not self.eat_op(","):
                    break
            columns, values = cols, [row]
        on_dup = []
        if self.eat_kw("ON"):
            self.expect_kw("DUPLICATE")
            self.expect_kw("KEY")
            self.expect_kw("UPDATE")
            while True:
                c = self.column_name_simple()
                self.expect_op("=")
                on_dup.append(A.Assignment(c, self.expr()))
                if not self.eat_op(","):
                    break
        return A.InsertStmt(table, columns, values, select, on_dup, replace, ignore)

    def _paren_is_select(self) -> bool:
        return self.at_op("(") and self.peek(1).kind is T.IDENT and self.peek(1).upper in ("SELECT", "WITH")

    def column_name_simple(self) -> A.ColumnName:
        name = self.ident()
        table = db = ""
        if self.eat_op("."):
            table, name = name, self.ident()
            if self.eat_op("."):
                db, table, name = table, name, self.ident()
        return A.ColumnName(name, table, db)

    def update_stmt(self) -> A.UpdateStmt:
        self.next()
        self.eat_kw("IGNORE")
        table = self.table_refs()
        self.expect_kw("SET")
        assigns = []
        while True:
            c = self.column_name_simple()
            self.expect_op("=")
            assigns.append(A.Assignment(c, self.expr()))
            if not self.eat_op(","):
                break
        where = self.expr() if self.eat_kw("WHERE") else None
        order_by = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.by_list()
        limit = self.limit_clause() if self.at_kw("LIMIT") else None
        return A.UpdateStmt(table, assigns, where, order_by, limit)

    def delete_stmt(self) -> A.DeleteStmt:
        self.next()
        self.eat_kw("LOW_PRIORITY")
        self.eat_kw("QUICK")
        self.eat_kw("IGNORE")
        if not self.at_kw("FROM"):
            # multi-table form: DELETE t1, t2 FROM <joined tables> WHERE ..
            # (ref: parser.y DeleteFromStmt multi-table) — parsed; the
            # executor deletes from the FIRST named table
            def target():
                t = self.table_name()
                if self.eat_op("."):
                    self.expect_op("*")
                return t

            targets = [target()]
            while self.eat_op(","):
                targets.append(target())
            self.expect_kw("FROM")
            self.table_refs()
            where = self.expr() if self.eat_kw("WHERE") else None
            return A.DeleteStmt(targets[0], where, [], None, multi_table=True)
        self.expect_kw("FROM")
        table = self.table_name(allow_alias=True)
        if self.eat_op(","):
            # multi-table USING form
            while True:
                self.table_name(allow_alias=True)
                if not self.eat_op(","):
                    break
            if self.eat_kw("USING"):
                self.table_refs()
            where = self.expr() if self.eat_kw("WHERE") else None
            return A.DeleteStmt(table, where, [], None, multi_table=True)
        if self.eat_kw("USING"):
            self.table_refs()
        where = self.expr() if self.eat_kw("WHERE") else None
        order_by = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order_by = self.by_list()
        limit = self.limit_clause() if self.at_kw("LIMIT") else None
        return A.DeleteStmt(table, where, order_by, limit)

    def load_data_stmt(self) -> A.LoadDataStmt:
        self.next()
        self.expect_kw("DATA")
        self.eat_kw("LOCAL")
        self.expect_kw("INFILE")
        path = self.next().text
        self.eat_kw("IGNORE") or self.eat_kw("REPLACE")
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        table = self.table_name()
        stmt = A.LoadDataStmt(path, table)
        if self.eat_kw("FIELDS", "COLUMNS"):
            while True:
                if self.eat_kw("TERMINATED"):
                    self.expect_kw("BY")
                    stmt.fields_terminated = self.next().text
                elif self.eat_kw("ENCLOSED"):
                    self.expect_kw("BY")
                    stmt.fields_enclosed = self.next().text
                elif self.eat_kw("OPTIONALLY"):
                    self.expect_kw("ENCLOSED")
                    self.expect_kw("BY")
                    stmt.fields_enclosed = self.next().text
                elif self.eat_kw("ESCAPED"):
                    self.expect_kw("BY")
                    self.next()
                else:
                    break
        if self.eat_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            stmt.lines_terminated = self.next().text
        if self.eat_kw("IGNORE"):
            stmt.ignore_lines = self.expect_number()
            self.expect_kw("LINES") if self.at_kw("LINES") else self.expect_kw("ROWS")
        if self.eat_op("("):
            while True:
                stmt.columns.append(self.ident())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return stmt

    # ---- DDL ----
    def split_stmt(self) -> A.SplitTableStmt:
        """SPLIT [REGION FOR] TABLE t [INDEX i] BETWEEN (..) AND (..)
        REGIONS n | BY (..)[, (..)] (ref: parser.y SplitRegionStmt)."""
        self.next()
        self.eat_kw("REGION") and self.eat_kw("FOR")
        self.eat_kw("PARTITION")
        self.expect_kw("TABLE")
        table = self.table_name()
        if self.eat_kw("PARTITION"):
            self.expect_op("(")
            while not self.at_op(")"):
                self.next()
            self.expect_op(")")
        index = ""
        if self.eat_kw("INDEX"):
            index = self.ident()
        between = None
        points = []

        def row():
            self.expect_op("(")
            vals = [self.expr()]
            while self.eat_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            return vals

        if self.eat_kw("BETWEEN"):
            lo = row()
            self.expect_kw("AND")
            hi = row()
            self.expect_kw("REGIONS")
            between = (lo, hi, self.expect_number())
        elif self.eat_kw("BY"):
            points.append(row())
            while self.eat_op(","):
                points.append(row())
        return A.SplitTableStmt(table, index, between, points)

    def create_stmt(self):
        self.next()
        or_replace = False
        if self.eat_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        definer = False
        if self.eat_kw("DEFINER"):
            self.expect_op("=")
            self.next()
            if self.eat_op("@"):
                self.next()
            definer = True
        if self.eat_kw("ALGORITHM"):
            self.expect_op("=")
            self.next()
            definer = True
        if self.eat_kw("SQL"):
            self.expect_kw("SECURITY")
            self.next()
            definer = True
        if self.at_kw("VIEW"):
            self.next()
            ine = False
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            name = self.table_name()
            cols = []
            if self.at_op("("):
                self.expect_op("(")
                while not self.at_op(")"):
                    cols.append(self.ident())
                    self.eat_op(",")
                self.expect_op(")")
            self.expect_kw("AS")
            sel_start = self.peek().pos
            sel = self.select_or_union()
            sel_end = self.peek().pos if self.peek().kind is not T.EOF else len(self.sql)
            source = self.sql[sel_start:sel_end].strip().rstrip(";").strip()
            if self.eat_kw("WITH"):
                self.eat_kw("CASCADED") or self.eat_kw("LOCAL")
                self.expect_kw("CHECK")
                self.expect_kw("OPTION")
            return A.CreateViewStmt(name, cols, sel, or_replace, source)
        if self.eat_kw("SEQUENCE"):
            ine = False
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            name = self.table_name()
            opts = {}
            while self.peek().kind in (T.IDENT, T.QIDENT):
                k = self.next().upper.lower()
                if k in ("start", "increment"):
                    self.eat_kw("WITH") or self.eat_kw("BY")
                    self.eat_op("=")
                    t = self.next()
                    neg = t.text == "-"
                    opts[k] = -self.expect_number() if neg else int(t.text)
                elif k in ("minvalue", "maxvalue", "cache"):
                    self.eat_op("=")
                    t = self.next()
                    neg = t.text == "-"
                    opts[k] = -self.expect_number() if neg else int(t.text)
                # nominvalue/nomaxvalue/nocache/cycle/nocycle: flags
            return A.CreateSequenceStmt(name, ine, opts)
        if self.at_kw("GLOBAL", "SESSION") and self.peek(1).upper == "BINDING":
            scope = self.next().upper.lower()
            self.next()
            self.expect_kw("FOR")
            t0 = self.peek().pos
            target = self.statement()
            t1 = self.peek().pos
            self.expect_kw("USING")
            h0 = self.peek().pos
            hinted = self.statement()
            h1 = self.peek().pos if self.peek().kind is not T.EOF else len(self.sql)
            st = A.BindingStmt("create", scope, target, hinted)
            st.target_sql = self.sql[t0:t1].strip().rstrip(";")
            st.hinted_sql = self.sql[h0:h1].strip().rstrip(";")
            return st
        if self.eat_kw("BINDING"):
            self.expect_kw("FOR")
            t0 = self.peek().pos
            target = self.statement()
            t1 = self.peek().pos
            self.expect_kw("USING")
            h0 = self.peek().pos
            hinted = self.statement()
            h1 = self.peek().pos if self.peek().kind is not T.EOF else len(self.sql)
            st = A.BindingStmt("create", "session", target, hinted)
            st.target_sql = self.sql[t0:t1].strip().rstrip(";")
            st.hinted_sql = self.sql[h0:h1].strip().rstrip(";")
            return st
        self.eat_kw("GLOBAL")  # global temporary table
        self.eat_kw("TEMPORARY")
        if self.eat_kw("ROLE"):
            ine = False
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            users = [self.user_spec(with_password=True)]
            while self.eat_op(","):
                users.append(self.user_spec(with_password=True))
            return A.CreateUserStmt(users, ine)
        if self.eat_kw("CHANGEFEED"):
            # CREATE CHANGEFEED name INTO 'sink-uri'
            #   [FOR TABLE t1, t2] [WITH start_ts = N, ...]
            name = self.ident()
            self.expect_kw("INTO")
            uri_tok = self.next()
            if uri_tok.kind is not T.STRING:
                raise ParseError("CREATE CHANGEFEED ... INTO expects a sink-uri string")
            tables = []
            if self.eat_kw("FOR"):
                self.expect_kw("TABLE")
                tables.append(self.table_name())
                while self.eat_op(","):
                    tables.append(self.table_name())
            opts = {}
            if self.eat_kw("WITH"):
                while True:
                    k = self.ident().lower()
                    v = True
                    if self.eat_op("="):
                        t = self.next()
                        # only INTEGRAL numbers coerce; '1.5' stays a
                        # string so the session rejects it with a typed
                        # SQLError instead of a raw int() ValueError
                        v = (int(t.text)
                             if t.kind is T.NUMBER and t.text.lstrip("-").isdigit()
                             else t.text)
                    opts[k] = v
                    if not self.eat_op(","):
                        break
            return A.ChangefeedStmt("create", name, uri_tok.text, tables, opts)
        if self.eat_kw("PLACEMENT"):
            self.expect_kw("POLICY")
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
            self.ident()
            while self.peek().kind in (T.IDENT, T.QIDENT):
                self.next()
                self.eat_op("=")
                self.next()
            return A.SetStmt([])
        if self.eat_kw("RESOURCE"):
            self.expect_kw("GROUP")
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
            self.ident()
            while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER, T.STRING):
                self.next()
            return A.SetStmt([])
        if self.eat_kw("USER"):
            ine = False
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            users = [self.user_spec(with_password=True)]
            while self.eat_op(","):
                users.append(self.user_spec(with_password=True))
            return A.CreateUserStmt(users, ine)
        if self.eat_kw("DATABASE", "SCHEMA"):
            ine = False
            if self.eat_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            name = self.ident()
            while self.at_kw("DEFAULT", "CHARACTER", "CHARSET", "COLLATE"):
                self.eat_kw("DEFAULT")
                if self.eat_kw("CHARACTER"):
                    self.expect_kw("SET")
                    self.eat_op("=")
                    self.ident()
                elif self.eat_kw("CHARSET"):
                    self.eat_op("=")
                    self.ident()
                elif self.eat_kw("COLLATE"):
                    self.eat_op("=")
                    self.ident()
            return A.CreateDatabaseStmt(name, ine)
        if self.eat_kw("UNIQUE"):
            self.expect_kw("INDEX")
            return self._create_index(unique=True)
        if self.eat_kw("INDEX"):
            return self._create_index(unique=False)
        self.expect_kw("TABLE")
        ine = False
        if self.eat_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            ine = True
        table = self.table_name()
        if self.eat_kw("LIKE"):
            return A.CreateTableStmt(table, [], if_not_exists=ine, like=self.table_name())
        columns, indexes, fks = [], [], []
        self.expect_op("(")
        while True:
            if self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                    self.ident()  # MySQL ignores the PK's given name
                idx = A.IndexDef("primary", self._index_cols(), unique=True, primary=True)
                self._index_opts()
                indexes.append(idx)
            elif self.at_kw("CHECK"):
                self.next()
                self.expect_op("(")
                self.expr()  # table CHECK constraint: parsed, not enforced
                self.expect_op(")")
                if self.eat_kw("NOT"):
                    self.expect_kw("ENFORCED")
                else:
                    self.eat_kw("ENFORCED")
            elif self.at_kw("UNIQUE"):
                self.next()
                self.eat_kw("KEY") or self.eat_kw("INDEX")
                name = ""
                if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                    name = self.ident()
                indexes.append(A.IndexDef(name, self._index_cols(), unique=True))
                self._index_opts()
            elif self.at_kw("KEY", "INDEX", "FULLTEXT"):
                if self.eat_kw("FULLTEXT"):
                    self.eat_kw("KEY") or self.eat_kw("INDEX")
                else:
                    self.next()
                name = ""
                if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                    name = self.ident()
                indexes.append(A.IndexDef(name, self._index_cols()))
                self._index_opts()
            elif self.at_kw("CONSTRAINT", "FOREIGN"):
                fk_name = ""
                if self.eat_kw("CONSTRAINT"):
                    if not self.at_kw("FOREIGN", "UNIQUE", "PRIMARY", "CHECK"):
                        fk_name = self.ident()
                if self.at_kw("CHECK"):
                    self.next()
                    self.expect_op("(")
                    self.expr()
                    self.expect_op(")")
                    if self.eat_kw("NOT"):
                        self.expect_kw("ENFORCED")
                    else:
                        self.eat_kw("ENFORCED")
                    if not self.eat_op(","):
                        break
                    continue
                if self.eat_kw("FOREIGN"):
                    self.expect_kw("KEY")
                    if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                        self.ident()
                    cols = self._index_cols()
                    self.expect_kw("REFERENCES")
                    rt = self.table_name()
                    rcols = self._index_cols()
                    on_delete = on_update = "restrict"
                    while self.eat_kw("ON"):
                        which = "delete" if self.eat_kw("DELETE") else ("update" if self.eat_kw("UPDATE") else "")
                        if self.eat_kw("CASCADE"):
                            act = "cascade"
                        elif self.eat_kw("RESTRICT"):
                            act = "restrict"
                        elif self.eat_kw("SET") and self.eat_kw("NULL"):
                            act = "set_null"
                        elif self.eat_kw("NO") and self.eat_kw("ACTION"):
                            act = "no_action"
                        else:
                            act = "restrict"
                        if which == "delete":
                            on_delete = act
                        elif which == "update":
                            on_update = act
                    fks.append(A.ForeignKeyDef(fk_name, [c for c, _ in cols], rt, [c for c, _ in rcols], on_delete, on_update))
                elif self.eat_kw("UNIQUE"):
                    self.eat_kw("KEY") or self.eat_kw("INDEX")
                    name = fk_name
                    if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                        name = self.ident()
                    indexes.append(A.IndexDef(name, self._index_cols(), unique=True))
                elif self.eat_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    indexes.append(A.IndexDef("primary", self._index_cols(), unique=True, primary=True))
                    self._index_opts()
            else:
                columns.append(self.column_def())
            if not self.eat_op(","):
                break
        self.expect_op(")")
        options = self._table_options()
        while self.at_op(",") and self.peek(1).kind is T.IDENT and self.peek(1).upper in _TABLE_OPTION_KWS:
            self.next()  # CREATE TABLE options may be comma-separated
            options.update(self._table_options())
        if self.at_kw("PARTITION"):
            options["partition_by"] = self._partition_clause()
            # trailing options may follow the partition list
            options.update(self._table_options())
        if self.eat_kw("ON"):
            self.expect_kw("COMMIT")
            self.expect_kw("DELETE")
            self.expect_kw("ROWS")
        select = None
        if self.eat_kw("AS") or self.at_kw("SELECT"):
            select = self.select_or_union()
        return A.CreateTableStmt(table, columns, indexes, fks, ine, options, None, select)

    def _create_index(self, unique: bool) -> A.CreateIndexStmt:
        name = self.ident()
        self.expect_kw("ON")
        table = self.table_name()
        cols = self._index_cols()
        return A.CreateIndexStmt(name, table, cols, unique)

    def _index_opts(self):
        """Swallow index tail options: USING BTREE/HASH, COMMENT, invisible,
        clustered attrs (ref: parser.y IndexOptionList)."""
        while True:
            if self.eat_kw("USING"):
                self.ident()
            elif self.eat_kw("COMMENT"):
                self.next()
            elif self.at_kw("VISIBLE", "INVISIBLE", "CLUSTERED", "NONCLUSTERED", "GLOBAL", "LOCAL"):
                self.next()
            elif self.eat_kw("KEY_BLOCK_SIZE"):
                self.eat_op("=")
                self.expect_number()
            else:
                return

    def _partition_name(self) -> str:
        """Partition names may start with a digit (2023p1) — the lexer
        splits that into NUMBER+IDENT; rejoin them."""
        if self.peek().kind is T.NUMBER and self.peek(1).kind is T.IDENT:
            n = self.next().text
            return n + self.next().text
        if self.peek().kind is T.NUMBER:
            return self.next().text
        return self.ident()

    def _partition_clause(self) -> dict:
        """PARTITION BY RANGE/LIST/HASH/KEY ... — parsed into a plan-visible
        dict; execution treats partitioned tables as one keyspace for now
        (ref: parser.y PartitionOpt; rule_partition_processor.go prunes)."""
        self.expect_kw("PARTITION")
        self.expect_kw("BY")
        method = self.next().upper  # RANGE | LIST | HASH | KEY | LINEAR?
        if method == "LINEAR":
            method = self.next().upper
        columns = False
        if self.eat_kw("COLUMNS"):
            columns = True
        exprs = []
        if self.at_op("("):
            self.expect_op("(")
            if not self.at_op(")"):
                while True:
                    exprs.append(self.expr())
                    if not self.eat_op(","):
                        break
            self.expect_op(")")
        n_parts = None
        if self.eat_kw("PARTITIONS"):
            n_parts = self.expect_number()
        parts = []
        part_exprs = exprs
        if self.eat_op("("):
            while True:
                self.expect_kw("PARTITION")
                pname = self.ident()
                pdef = {"name": pname}
                if self.eat_kw("VALUES"):
                    if self.eat_kw("LESS"):
                        self.expect_kw("THAN")
                        if self.eat_kw("MAXVALUE"):
                            pdef["less_than"] = "MAXVALUE"
                        else:
                            self.expect_op("(")
                            vals = []
                            while True:
                                vals.append("MAXVALUE" if self.eat_kw("MAXVALUE") else self.expr())
                                if not self.eat_op(","):
                                    break
                            self.expect_op(")")
                            pdef["less_than"] = vals
                    elif self.eat_kw("IN"):
                        self.expect_op("(")
                        vals = []
                        while True:
                            if self.eat_op("("):
                                row = []
                                while True:
                                    row.append(self.expr())
                                    if not self.eat_op(","):
                                        break
                                self.expect_op(")")
                                vals.append(row)
                            else:
                                vals.append(self.expr())
                            if not self.eat_op(","):
                                break
                        self.expect_op(")")
                        pdef["in"] = vals
                while self.at_kw("COMMENT", "ENGINE", "PLACEMENT", "TABLESPACE",
                                 "MAX_ROWS", "MIN_ROWS", "DATA", "INDEX"):
                    kw2 = self.next().upper
                    if kw2 == "PLACEMENT":
                        self.expect_kw("POLICY")
                    elif kw2 in ("DATA", "INDEX"):
                        self.expect_kw("DIRECTORY")
                    self.eat_op("=")
                    self.next()
                parts.append(pdef)
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return {"method": method, "columns": columns, "n": n_parts, "parts": parts, "exprs": part_exprs}

    def _index_cols(self) -> list:
        self.expect_op("(")
        out = []
        while True:
            if self.at_op("("):
                # expression index element ((expr)): parsed and marked —
                # creation sites drop the element, and a UNIQUE index that
                # lost one must ALSO drop uniqueness (the remaining columns
                # would otherwise enforce a STRICTER constraint). ref:
                # pkg/ddl/index.go buildIndexColumns expression columns
                self.next()
                self.expr()
                self.expect_op(")")
                self.eat_kw("ASC") or self.eat_kw("DESC")
                out.append(("__expr__", -2))
            else:
                c = self.ident()
                plen = -1
                if self.eat_op("("):
                    plen = self.expect_number()
                    self.expect_op(")")
                self.eat_kw("ASC") or self.eat_kw("DESC")
                out.append((c, plen))
            if not self.eat_op(","):
                break
        self.expect_op(")")
        return out

    def column_def(self) -> A.ColumnDef:
        name = self.ident()
        ts = self.type_spec()
        cd = A.ColumnDef(name, ts)
        while True:
            if self.eat_kw("NOT"):
                self.expect_kw("NULL")
                cd.not_null = True
            elif self.eat_kw("NULL"):
                pass
            elif self.eat_kw("DEFAULT"):
                cd.default = self.default_value()
            elif self.eat_kw("AUTO_INCREMENT"):
                cd.auto_increment = True
            elif self.eat_kw("PRIMARY"):
                self.expect_kw("KEY")
                cd.primary_key = True
            elif self.eat_kw("KEY"):
                cd.primary_key = True
            elif self.eat_kw("UNIQUE"):
                self.eat_kw("KEY")
                cd.unique = True
            elif self.eat_kw("COMMENT"):
                cd.comment = self.next().text
            elif self.eat_kw("COLLATE"):
                cd.type.collate = self.ident().lower()
            elif self.eat_kw("CHARACTER"):
                self.expect_kw("SET")
                cd.type.charset = self.ident().lower()
            elif self.eat_kw("ON"):
                self.expect_kw("UPDATE")
                fn = self.ident()
                if self.eat_op("("):
                    if self.peek().kind is T.NUMBER:
                        self.expect_number()
                    self.expect_op(")")
                cd.on_update_now = fn.lower() in ("current_timestamp", "now")
            elif self.eat_kw("REFERENCES"):
                self.table_name()
                self._index_cols()
            elif self.at_kw("GENERATED", "AS"):
                # [GENERATED ALWAYS] AS (expr) [VIRTUAL|STORED]
                if self.eat_kw("GENERATED"):
                    self.expect_kw("ALWAYS")
                self.expect_kw("AS")
                self.expect_op("(")
                cd.generated = self.expr()
                self.expect_op(")")
                if self.eat_kw("STORED"):
                    cd.generated_stored = True
                else:
                    self.eat_kw("VIRTUAL")
            elif self.eat_kw("CHECK") or (self.at_kw("CONSTRAINT") and self.eat_kw("CONSTRAINT")):
                if not self.at_op("("):
                    if not self.at_kw("CHECK"):
                        self.ident()  # constraint name
                    self.eat_kw("CHECK")
                self.expect_op("(")
                cd.check = self.expr()
                self.expect_op(")")
                if self.eat_kw("NOT"):
                    self.expect_kw("ENFORCED")
                else:
                    self.eat_kw("ENFORCED")
            elif self.eat_kw("BINARY"):
                pass  # char(n) BINARY -> binary collation attribute
            elif self.at_kw("CLUSTERED", "NONCLUSTERED"):
                self.next()  # TiDB clustered-index attribute on the PK
            elif self.eat_kw("SERIAL"):
                self.expect_kw("DEFAULT")
                self.expect_kw("VALUE")
                cd.auto_increment = True
            elif self.eat_kw("AUTO_RANDOM"):
                if self.eat_op("("):
                    self.expect_number()
                    self.expect_op(")")
            else:
                return cd

    def default_value(self):
        t = self.peek()
        if t.kind is T.IDENT and t.upper in ("CURRENT_TIMESTAMP", "NOW"):
            self.next()
            if self.eat_op("("):
                if self.peek().kind is T.NUMBER:
                    self.expect_number()  # fsp
                self.expect_op(")")
            return A.FuncCall("now", [])
        if t.kind is T.IDENT and t.upper == "NEXT":
            self.next()
            self.expect_kw("VALUE")
            self.expect_kw("FOR")
            seq = self.table_name()
            return A.FuncCall("nextval", [A.Literal(seq.name, "str")])
        if self.at_op("("):
            self.next()
            e = self.expr()
            self.expect_op(")")
            return e
        return self.unary_expr()

    def _table_options(self) -> dict:
        opts = {}
        while True:
            if self.eat_kw("ENGINE"):
                self.eat_op("=")
                opts["engine"] = self.ident()
            elif self.eat_kw("AUTO_INCREMENT"):
                self.eat_op("=")
                opts["auto_increment"] = self.expect_number()
            elif self.eat_kw("DEFAULT"):
                continue
            elif self.eat_kw("CHARSET"):
                self.eat_op("=")
                opts["charset"] = self.ident().lower()
            elif self.eat_kw("CHARACTER"):
                self.expect_kw("SET")
                self.eat_op("=")
                opts["charset"] = self.ident().lower()
            elif self.eat_kw("COLLATE"):
                self.eat_op("=")
                opts["collate"] = self.ident().lower()
            elif self.eat_kw("COMMENT"):
                self.eat_op("=")
                opts["comment"] = self.next().text
            elif self.eat_kw("TTL"):
                self.eat_op("=")
                opts["ttl"] = self.expr()  # col + INTERVAL n UNIT
            elif self.at_kw(
                "AUTO_ID_CACHE", "AUTO_RANDOM_BASE", "SHARD_ROW_ID_BITS",
                "PRE_SPLIT_REGIONS", "KEY_BLOCK_SIZE", "STATS_PERSISTENT",
                "STATS_AUTO_RECALC", "STATS_SAMPLE_PAGES", "MAX_ROWS",
                "MIN_ROWS", "AVG_ROW_LENGTH", "CHECKSUM", "DELAY_KEY_WRITE",
                "ROW_FORMAT", "COMPRESSION", "CONNECTION", "PACK_KEYS",
                "STATS_BUCKETS", "STATS_TOPN", "STATS_COL_CHOICE",
                "STATS_COL_LIST", "STATS_SAMPLE_RATE", "INSERT_METHOD",
                "SECONDARY_ENGINE", "TTL_ENABLE", "TTL_JOB_INTERVAL",
                "PLACEMENT", "AUTOEXTEND_SIZE", "ENCRYPTION",
            ):
                name = self.next().upper.lower()
                self.eat_kw("POLICY")  # PLACEMENT POLICY [=] x
                self.eat_op("=")
                opts[name] = self.next().text  # number / ident / string
            else:
                return opts

    def drop_stmt(self):
        self.next()
        if self.eat_kw("USER"):
            ie = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            users = [self.user_spec()[:2]]
            while self.eat_op(","):
                users.append(self.user_spec()[:2])
            return A.DropUserStmt(users, ie)
        if self.eat_kw("DATABASE", "SCHEMA"):
            ie = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            return A.DropDatabaseStmt(self.ident(), ie)
        if self.eat_kw("INDEX"):
            name = self.ident()
            self.expect_kw("ON")
            return A.DropIndexStmt(name, self.table_name())
        if self.eat_kw("VIEW"):
            ie = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            names = [self.table_name()]
            while self.eat_op(","):
                names.append(self.table_name())
            return A.DropViewStmt(names, ie)
        if self.eat_kw("ROLE"):
            users = [self.user_spec()[:2]]
            while self.eat_op(","):
                users.append(self.user_spec()[:2])
            return A.DropUserStmt(users, True)
        if self.eat_kw("CHANGEFEED"):
            return A.ChangefeedStmt("drop", self.ident())
        if self.eat_kw("PLACEMENT"):
            self.expect_kw("POLICY")
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
            self.ident()
            return A.SetStmt([])
        if self.eat_kw("RESOURCE"):
            self.expect_kw("GROUP")
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
            self.ident()
            return A.SetStmt([])
        if self.eat_kw("STATS"):
            while self.peek().kind in (T.IDENT, T.QIDENT):
                self.next()
                self.eat_op(",")
            return A.SetStmt([])
        if self.at_kw("GLOBAL", "SESSION") and self.peek(1).upper == "BINDING":
            scope = self.next().upper.lower()
            self.next()
            self.expect_kw("FOR")
            target = self.statement()
            hinted = self.statement() if self.eat_kw("USING") else None
            return A.BindingStmt("drop", scope, target, hinted)
        self.eat_kw("GLOBAL")
        self.eat_kw("TEMPORARY")
        if self.eat_kw("SEQUENCE"):
            ie = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            names = [self.table_name()]
            while self.eat_op(","):
                names.append(self.table_name())
            return A.DropSequenceStmt(names, ie)
        if self.eat_kw("BINDING"):
            self.expect_kw("FOR")
            target = self.statement()
            hinted = self.statement() if self.eat_kw("USING") else None
            return A.BindingStmt("drop", "session", target, hinted)
        self.eat_kw("TEMPORARY")
        self.expect_kw("TABLE")
        ie = False
        if self.eat_kw("IF"):
            self.expect_kw("EXISTS")
            ie = True
        tables = [self.table_name()]
        while self.eat_op(","):
            tables.append(self.table_name())
        return A.DropTableStmt(tables, ie)

    def alter_stmt(self):
        self.next()
        if self.eat_kw("USER"):
            ie = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                ie = True
            users = [self.user_spec(with_password=True)]
            while self.eat_op(","):
                users.append(self.user_spec(with_password=True))
            return A.AlterUserStmt(users, ie)
        if self.eat_kw("SEQUENCE"):
            name = self.table_name()
            while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER):
                self.next()
            return A.CreateSequenceStmt(name, True, {})
        if self.eat_kw("DATABASE", "SCHEMA"):
            if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_kw("DEFAULT", "CHARACTER", "CHARSET", "COLLATE"):
                self.ident()
            while self.at_kw("DEFAULT", "CHARACTER", "CHARSET", "COLLATE"):
                self.eat_kw("DEFAULT")
                if self.eat_kw("CHARACTER"):
                    self.expect_kw("SET")
                elif not (self.eat_kw("CHARSET") or self.eat_kw("COLLATE")):
                    break
                self.eat_op("=")
                self.ident()
            return A.SetStmt([])
        if self.eat_kw("INSTANCE") or self.eat_kw("RANGE"):
            while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER, T.STRING):
                self.next()
            return A.SetStmt([])
        self.expect_kw("TABLE")
        table = self.table_name()
        specs = []
        while True:
            if self.eat_kw("ADD"):
                if self.eat_kw("COLUMN"):
                    cd = self.column_def()
                    pos = ""
                    if self.eat_kw("FIRST"):
                        pos = "first"
                    elif self.eat_kw("AFTER"):
                        pos = "after:" + self.ident()
                    specs.append(A.AlterTableSpec("add_column", column=cd, position=pos))
                elif self.eat_kw("INDEX", "KEY"):
                    name = ""
                    if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                        name = self.ident()
                    specs.append(A.AlterTableSpec("add_index", index=A.IndexDef(name, self._index_cols())))
                elif self.eat_kw("UNIQUE"):
                    self.eat_kw("INDEX") or self.eat_kw("KEY")
                    name = ""
                    if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                        name = self.ident()
                    specs.append(A.AlterTableSpec("add_index", index=A.IndexDef(name, self._index_cols(), unique=True)))
                elif self.eat_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    specs.append(A.AlterTableSpec("add_index", index=A.IndexDef("primary", self._index_cols(), unique=True, primary=True)))
                    self._index_opts()
                elif self.eat_kw("STATS_EXTENDED"):
                    self.ident()
                    self.ident()  # correlation | dependency
                    self._index_cols()
                    specs.append(A.AlterTableSpec("noop_option"))
                elif self.eat_kw("PARTITION"):
                    if self.at_op("("):
                        self._partition_def_list()
                    else:
                        self.eat_kw("PARTITIONS") and self.expect_number()
                    specs.append(A.AlterTableSpec("add_partition"))
                elif self.at_kw("CONSTRAINT", "CHECK", "FOREIGN"):
                    if self.eat_kw("CONSTRAINT"):
                        if not self.at_kw("CHECK", "FOREIGN", "UNIQUE", "PRIMARY"):
                            self.ident()
                    if self.eat_kw("CHECK"):
                        self.expect_op("(")
                        self.expr()
                        self.expect_op(")")
                        if self.eat_kw("NOT"):
                            self.expect_kw("ENFORCED")
                        else:
                            self.eat_kw("ENFORCED")
                        specs.append(A.AlterTableSpec("add_check"))
                    elif self.eat_kw("FOREIGN"):
                        self.expect_kw("KEY")
                        if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                            self.ident()
                        self._index_cols()
                        self.expect_kw("REFERENCES")
                        self.table_name()
                        self._index_cols()
                        while self.eat_kw("ON"):
                            self.eat_kw("DELETE") or self.eat_kw("UPDATE")
                            self.eat_kw("CASCADE") or self.eat_kw("RESTRICT") or (self.eat_kw("SET") and self.eat_kw("NULL")) or (self.eat_kw("NO") and self.eat_kw("ACTION"))
                        specs.append(A.AlterTableSpec("add_foreign_key"))
                    elif self.eat_kw("UNIQUE"):
                        self.eat_kw("INDEX") or self.eat_kw("KEY")
                        name = ""
                        if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_op("("):
                            name = self.ident()
                        specs.append(A.AlterTableSpec("add_index", index=A.IndexDef(name, self._index_cols(), unique=True)))
                    elif self.eat_kw("PRIMARY"):
                        self.expect_kw("KEY")
                        specs.append(A.AlterTableSpec("add_index", index=A.IndexDef("primary", self._index_cols(), unique=True, primary=True)))
                else:
                    cd = self.column_def()
                    pos = ""
                    if self.eat_kw("FIRST"):
                        pos = "first"
                    elif self.eat_kw("AFTER"):
                        pos = "after:" + self.ident()
                    specs.append(A.AlterTableSpec("add_column", column=cd, position=pos))
            elif self.eat_kw("DROP"):
                if self.eat_kw("COLUMN"):
                    specs.append(A.AlterTableSpec("drop_column", name=self.ident()))
                elif self.eat_kw("INDEX", "KEY"):
                    specs.append(A.AlterTableSpec("drop_index", name=self.ident()))
                elif self.eat_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    specs.append(A.AlterTableSpec("drop_index", name="primary"))
                elif self.eat_kw("PARTITION"):
                    self._name_list_or_all()
                    specs.append(A.AlterTableSpec("drop_partition"))
                elif self.eat_kw("FOREIGN"):
                    self.expect_kw("KEY")
                    specs.append(A.AlterTableSpec("drop_foreign_key", name=self.ident()))
                elif self.eat_kw("CHECK") or self.eat_kw("CONSTRAINT"):
                    specs.append(A.AlterTableSpec("drop_check", name=self.ident()))
                else:
                    specs.append(A.AlterTableSpec("drop_column", name=self.ident()))
            elif self.eat_kw("MODIFY"):
                self.eat_kw("COLUMN")
                cd = self.column_def()
                specs.append(A.AlterTableSpec("modify_column", column=cd))
            elif self.eat_kw("CHANGE"):
                self.eat_kw("COLUMN")
                old = self.ident()
                cd = self.column_def()
                specs.append(A.AlterTableSpec("change_column", column=cd, name=old))
            elif self.eat_kw("RENAME"):
                if self.eat_kw("INDEX"):
                    old = self.ident()
                    self.expect_kw("TO")
                    specs.append(A.AlterTableSpec("rename_index", name=old, new_name=self.ident()))
                else:
                    self.eat_kw("TO") or self.eat_kw("AS")
                    specs.append(A.AlterTableSpec("rename", new_name=self.ident()))
            elif self.at_kw("SET"):
                # ALTER TABLE t SET {COLUMNAR | TIFLASH} REPLICA n (ref:
                # TiDB's `SET TIFLASH REPLICA` DDL — ours attaches the
                # changefeed-fed columnar replica tier)
                self.next()
                if not self.eat_kw("COLUMNAR", "TIFLASH"):
                    raise ParseError(f"expected COLUMNAR or TIFLASH after SET at {self._where()}")
                self.expect_kw("REPLICA")
                n = int(self.expect_number())
                specs.append(A.AlterTableSpec("set_columnar_replica", options={"count": n}))
            elif self.at_kw("ATTRIBUTES"):
                self.next()
                self.eat_op("=")
                self.next()
                specs.append(A.AlterTableSpec("noop_option"))
            elif self.at_kw("FIRST", "LAST"):
                # FIRST/LAST PARTITION LESS THAN (...) (TiDB interval mgmt)
                self.next()
                self.expect_kw("PARTITION")
                self.eat_kw("LESS") and self.expect_kw("THAN")
                if self.eat_op("("):
                    self.expr()
                    self.expect_op(")")
                specs.append(A.AlterTableSpec("noop_option"))
            elif self.at_kw("EXCHANGE"):
                self.next()
                self.expect_kw("PARTITION")
                pname = self.ident()
                self.expect_kw("WITH")
                self.expect_kw("TABLE")
                other = self.table_name()
                if self.eat_kw("WITH") or self.eat_kw("WITHOUT"):
                    self.expect_kw("VALIDATION")
                specs.append(A.AlterTableSpec("exchange_partition", name=pname, new_name=other.name))
            elif self.at_kw("REORGANIZE"):
                self.next()
                self.expect_kw("PARTITION")
                while self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_kw("INTO"):
                    self.ident()
                    if not self.eat_op(","):
                        break
                self.expect_kw("INTO")
                self._partition_def_list()
                specs.append(A.AlterTableSpec("reorganize_partition"))
            elif self.at_kw("COALESCE"):
                self.next()
                self.expect_kw("PARTITION")
                self.expect_number()
                specs.append(A.AlterTableSpec("coalesce_partition"))
            elif self.at_kw("TRUNCATE"):
                self.next()
                self.expect_kw("PARTITION")
                self._name_list_or_all()
                specs.append(A.AlterTableSpec("truncate_partition"))
            elif self.at_kw("PARTITION"):
                if self.peek(1).upper == "BY":
                    specs.append(A.AlterTableSpec("repartition", options=self._partition_clause()))
                else:
                    self.next()
                    self._partition_name()
                    while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER, T.STRING):
                        self.next()
                        self.eat_op("=")
                    specs.append(A.AlterTableSpec("noop_option"))
            elif self.at_kw("REMOVE"):
                self.next()
                self.expect_kw("PARTITIONING")
                specs.append(A.AlterTableSpec("remove_partitioning"))
            elif self.at_kw("ALTER"):
                self.next()
                if self.eat_kw("CONSTRAINT"):
                    self.ident()
                    if self.eat_kw("NOT"):
                        self.expect_kw("ENFORCED")
                    else:
                        self.eat_kw("ENFORCED")
                    specs.append(A.AlterTableSpec("alter_constraint"))
                elif self.eat_kw("INDEX"):
                    self.ident()
                    self.next()  # VISIBLE | INVISIBLE
                    specs.append(A.AlterTableSpec("alter_index_visibility"))
                else:
                    self.eat_kw("COLUMN")
                    cname = self.ident()
                    if self.eat_kw("SET"):
                        self.expect_kw("DEFAULT")
                        d = self.default_value()
                        specs.append(A.AlterTableSpec("set_default", name=cname, default=d))
                    else:
                        self.expect_kw("DROP")
                        self.expect_kw("DEFAULT")
                        specs.append(A.AlterTableSpec("set_default", name=cname, default=None))
            elif self.at_kw(
                "ENGINE", "AUTO_INCREMENT", "CHARSET", "CHARACTER", "COLLATE",
                "COMMENT", "DEFAULT", "CONVERT", "TTL", "TTL_ENABLE",
                "AUTO_ID_CACHE", "SHARD_ROW_ID_BITS", "ROW_FORMAT",
                "PLACEMENT", "COMPRESSION", "KEY_BLOCK_SIZE", "REMOVE_TTL",
                "STATS_BUCKETS", "STATS_TOPN", "STATS_COL_CHOICE",
                "STATS_SAMPLE_RATE", "STATS_PERSISTENT", "CACHE", "NOCACHE",
                "FORCE", "ORDER",
            ):
                if self.eat_kw("CONVERT"):
                    self.expect_kw("TO")
                    self.eat_kw("CHARACTER") and self.expect_kw("SET") or self.eat_kw("CHARSET")
                    self.ident()
                    if self.eat_kw("COLLATE"):
                        self.ident()
                    specs.append(A.AlterTableSpec("charset"))
                elif self.eat_kw("CACHE") or self.eat_kw("NOCACHE") or self.eat_kw("FORCE"):
                    specs.append(A.AlterTableSpec("noop_option"))
                elif self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    self.by_list()
                    specs.append(A.AlterTableSpec("noop_option"))
                elif self.eat_kw("REMOVE_TTL"):
                    specs.append(A.AlterTableSpec("table_option", options={"remove_ttl": True}))
                else:
                    o = self._table_options()
                    if not o and not self.at_op(",") and not self.at_kw(";"):
                        raise ParseError(f"unsupported ALTER option at {self._where()}")
                    specs.append(A.AlterTableSpec("table_option", options=o))
            else:
                raise ParseError(f"unsupported ALTER action at {self._where()}")
            if not self.eat_op(","):
                break
        return A.AlterTableStmt(table, specs)

    def _partition_def_list(self):
        self.expect_op("(")
        depth = 1
        while depth and self.peek().kind is not T.EOF:
            if self.at_op("("):
                depth += 1
            elif self.at_op(")"):
                depth -= 1
            self.next()

    def _name_list_or_all(self):
        if self.eat_kw("ALL"):
            return
        while True:
            self.ident()
            if not self.eat_op(","):
                break

    def rename_stmt(self):
        self.next()
        if self.eat_kw("USER"):
            while True:
                self.user_spec()
                self.expect_kw("TO")
                self.user_spec()
                if not self.eat_op(","):
                    break
            return A.SetStmt([])
        self.expect_kw("TABLE")
        pairs = []
        while True:
            old = self.table_name()
            self.expect_kw("TO")
            pairs.append((old, self.table_name()))
            if not self.eat_op(","):
                break
        return A.RenameTableStmt(pairs)

    # ---- SET / SHOW / EXPLAIN / ANALYZE / ADMIN / BRIE ----
    def set_stmt(self) -> A.SetStmt:
        self.next()
        if self.eat_kw("PASSWORD"):
            if self.eat_kw("FOR"):
                self.user_spec()
            self.expect_op("=")
            self.next()
            return A.SetStmt([])
        if self.eat_kw("RESOURCE"):
            self.expect_kw("GROUP")
            self.ident()
            return A.SetStmt([])
        if self.at_kw("ROLE", "DEFAULT"):
            # SET [DEFAULT] ROLE ... TO ...
            while self.peek().kind is not T.EOF and not self.at_op(";"):
                self.next()
            return A.SetStmt([])
        if self.eat_kw("NAMES"):
            cs = self.next().text.lower()
            if cs == "default":
                cs = "utf8mb4"
            coll = ""
            if self.eat_kw("COLLATE"):
                coll = self.next().text.lower()
            # expanded by the session (pkg/executor/set.go setCharset needs
            # @@default_collation_for_utf8mb4, which the parser can't read)
            return A.SetStmt([("session", "__set_names__",
                               A.Literal(f"{cs}|{coll}", "str"))])
        assigns = []
        while True:
            scope = "session"
            if self.eat_kw("GLOBAL"):
                scope = "global"
            elif self.eat_kw("SESSION", "LOCAL"):
                scope = "session"
            if self.at_op("@"):
                self.next()
                if self.eat_op("@"):
                    name = self.ident()
                    if name.lower() in ("global", "session") and self.eat_op("."):
                        scope = name.lower()
                        name = self.ident()
                else:
                    scope = "user"
                    name = self.ident()
            else:
                name = self.ident()
            if not (self.eat_op("=") or self.eat_op(":=")):
                raise ParseError(f"expected = at {self._where()}")
            if self.at_kw("ON", "OFF") and self.peek(1).kind in (T.OP, T.EOF) and (self.peek(1).text in (",", ";", "")):
                v = A.Literal(self.next().text, "str")
            else:
                v = self.expr()
            assigns.append((scope, name.lower(), v))
            if not self.eat_op(","):
                break
        return A.SetStmt(assigns)

    def show_stmt(self) -> A.ShowStmt:
        self.next()
        full = self.eat_kw("FULL")
        glob = self.eat_kw("GLOBAL")
        self.eat_kw("SESSION")
        s = A.ShowStmt("", full=full, global_scope=glob)
        if self.eat_kw("DATABASES", "SCHEMAS"):
            s.kind = "databases"
        elif self.eat_kw("TABLES"):
            s.kind = "tables"
            if self.eat_kw("FROM", "IN"):
                s.db = self.ident()
        elif self.eat_kw("COLUMNS", "FIELDS"):
            s.kind = "columns"
            self.expect_kw("FROM") if self.at_kw("FROM") else self.expect_kw("IN")
            s.table = self.table_name()
        elif self.eat_kw("CREATE"):
            if self.eat_kw("TABLE"):
                s.kind = "create_table"
                s.table = self.table_name()
            elif self.eat_kw("DATABASE"):
                s.kind = "create_database"
                s.db = self.ident()
            elif self.eat_kw("VIEW"):
                s.kind = "create_view"
                s.table = self.table_name()
            elif self.eat_kw("SEQUENCE"):
                s.kind = "create_sequence"
                s.table = self.table_name()
            elif self.eat_kw("USER"):
                s.kind = "create_user"
                self.user_spec()
        elif self.eat_kw("INDEX", "INDEXES", "KEYS"):
            s.kind = "index"
            self.eat_kw("FROM") or self.eat_kw("IN")
            s.table = self.table_name()
        elif self.eat_kw("GRANTS"):
            s.kind = "grants"
            if self.eat_kw("FOR"):
                self.user_spec()
                if self.eat_kw("USING"):
                    self.user_spec()
        elif self.eat_kw("BINDINGS"):
            s.kind = "bindings"
        elif self.eat_kw("VARIABLES"):
            s.kind = "variables"
        elif self.eat_kw("STATUS"):
            s.kind = "status"
        elif self.eat_kw("WARNINGS"):
            s.kind = "warnings"
        elif self.eat_kw("ERRORS"):
            s.kind = "errors"
        elif self.eat_kw("PROCESSLIST"):
            s.kind = "processlist"
        elif self.eat_kw("ENGINES"):
            s.kind = "engines"
        elif self.eat_kw("COLLATION"):
            s.kind = "collation"
        elif self.eat_kw("CHARSET", "CHARACTER"):
            self.eat_kw("SET")
            s.kind = "charset"
        elif self.eat_kw("STATS_META"):
            s.kind = "stats_meta"
        elif self.eat_kw("STATS_HISTOGRAMS"):
            s.kind = "stats_histograms"
        elif self.eat_kw("BACKUP"):
            # SHOW BACKUP LOGS (ref: `br log status`): one row
            # per attached log backup with its durable checkpoint
            if not self.eat_kw("LOGS", "LOG"):
                raise ParseError(f"expected LOGS at {self._where()}")
            s.kind = "backup_logs"
        elif self.eat_kw("CHANGEFEEDS", "CHANGEFEED"):
            # SHOW CHANGEFEEDS (ref: TiCDC `changefeed list`); the
            # singular form with a name filters to exactly that feed —
            # LIKE metacharacters in the name are escaped so `my_feed`
            # never wildcard-matches `myxfeed`
            s.kind = "changefeeds"
            if self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_kw("LIKE", "WHERE"):
                name = self.ident()
                s.pattern = (name.replace("\\", "\\\\")
                             .replace("%", "\\%").replace("_", "\\_"))
        elif self.eat_kw("PLACEMENT"):
            # SHOW PLACEMENT [LABELS] (ref: the reference's SHOW PLACEMENT;
            # ours reports the PD's region->store map + scheduling state)
            self.eat_kw("LABELS")
            s.kind = "placement"
        elif self.eat_kw("COLUMNAR"):
            # SHOW COLUMNAR TABLES (ref: information_schema
            # .tiflash_replica): per-table delta rows, stable chunks, and
            # the applied resolved-ts frontier of the columnar replica
            self.expect_kw("TABLES")
            s.kind = "columnar"
        elif self.eat_kw("TABLE"):
            self.expect_kw("STATUS")
            s.kind = "table_status"
            if self.eat_kw("FROM", "IN"):
                s.db = self.ident()
        elif self.eat_kw("GRANTS"):
            s.kind = "grants"
        elif self.eat_kw("PLUGINS"):
            s.kind = "plugins"
        else:
            # tolerant catch-all (ref: the reference's ~60 SHOW forms):
            # swallow the remaining tokens; execution reports the kind
            words = []
            while self.peek().kind is not T.EOF and not self.at_op(";"):
                words.append(self.next().text)
            s.kind = "other:" + " ".join(words[:4]).lower()
            return s
        if self.eat_kw("LIKE"):
            s.pattern = self.next().text
        elif self.eat_kw("WHERE"):
            s.where = self.expr()
        return s

    def explain_stmt(self):
        self.next()
        analyze = self.eat_kw("ANALYZE")
        fmt = "row"
        if self.eat_kw("FORMAT"):
            self.eat_op("=")
            fmt = self.next().text.lower()  # 'brief' | tidb_json | ...
        # DESC table shorthand
        if not analyze and self.peek().kind in (T.IDENT, T.QIDENT) and self.peek().upper not in (
            "SELECT", "INSERT", "UPDATE", "DELETE", "REPLACE", "WITH",
        ):
            t = self.table_name()
            return A.ShowStmt("columns", table=t)
        return A.ExplainStmt(self.statement(), analyze, fmt)

    def user_spec(self, with_password: bool = False):
        """'name'[@'host'] [IDENTIFIED BY 'pw'] -> (name, host[, password])."""
        t = self.next()
        name = t.text
        host = "%"
        if self.eat_op("@"):
            host = self.next().text
        if not with_password:
            return (name, host, None)
        pw = ""
        while True:
            if self.eat_kw("IDENTIFIED"):
                if self.eat_kw("WITH"):
                    self.next()  # auth plugin name
                    if self.eat_kw("BY") or self.eat_kw("AS"):
                        pw = self.next().text
                else:
                    self.expect_kw("BY")
                    pw = self.next().text
            elif self.eat_kw("RESOURCE"):
                self.expect_kw("GROUP")
                self.ident()
            elif self.eat_kw("REQUIRE"):
                while True:
                    t = self.next().upper  # SSL|X509|NONE|ISSUER|SUBJECT|CIPHER|SAN
                    if t in ("ISSUER", "SUBJECT", "CIPHER", "SAN"):
                        self.next()  # the quoted value
                    if not self.eat_kw("AND"):
                        break
            elif self.eat_kw("ATTRIBUTE"):
                self.next()
            elif self.eat_kw("COMMENT"):
                self.next()
            elif self.eat_kw("ACCOUNT"):
                self.next()  # LOCK | UNLOCK
            elif self.eat_kw("PASSWORD"):
                if self.eat_kw("EXPIRE"):
                    if self.eat_kw("INTERVAL"):
                        self.expect_number()
                        self.next()  # DAY
                    else:
                        self.eat_kw("NEVER") or self.eat_kw("DEFAULT")
                elif self.eat_kw("HISTORY") or self.eat_kw("REUSE"):
                    self.eat_kw("INTERVAL")
                    self.eat_kw("DEFAULT") or (self.expect_number() and self.eat_kw("DAY"))
            elif self.at_kw("FAILED_LOGIN_ATTEMPTS", "PASSWORD_LOCK_TIME"):
                self.next()
                self.eat_kw("UNBOUNDED") or self.expect_number()
            else:
                break
        return (name, host, pw)

    def grant_stmt(self, revoke: bool):
        """GRANT/REVOKE priv[, priv] ON [db.]tbl TO/FROM user[, user]
        (ref: parser.y GrantStmt — the subset privilege checks use)."""
        self.next()
        privs = []
        while True:
            if self.eat_kw("ALL"):
                self.eat_kw("PRIVILEGES")
                privs.append("all")
            else:
                kw = self.next().text.lower()
                # multi-word privileges (ref: mysql/privs): CREATE VIEW,
                # SHOW VIEW, CREATE USER/ROLE, ALTER ROUTINE, SHOW DATABASES,
                # LOCK TABLES, EVENT, REPLICATION SLAVE/CLIENT ...
                while self.peek().kind is T.IDENT and self.peek().upper in (
                    "VIEW", "USER", "ROLE", "ROUTINE", "DATABASES", "TABLES",
                    "TEMPORARY", "SLAVE", "CLIENT", "OPTION", "ADMIN",
                ):
                    kw += "_" + self.next().text.lower()
                privs.append(kw)
            if not self.eat_op(","):
                break
        self.expect_kw("ON")
        db = table = "*"
        if self.at_op("*"):
            self.next()
            if self.eat_op("."):
                self.expect_op("*")
        else:
            first = self.ident()
            if self.eat_op("."):
                db = first
                if self.at_op("*"):
                    self.next()
                else:
                    table = self.ident()
            else:
                table = first
        self.expect_kw("FROM" if revoke else "TO")
        users = [self.user_spec()[:2]]
        while self.eat_op(","):
            users.append(self.user_spec()[:2])
        node = A.RevokeStmt if revoke else A.GrantStmt
        return node(privs, db, table, users)

    def analyze_stmt(self) -> A.AnalyzeTableStmt:
        self.next()
        self.expect_kw("TABLE")
        tables = [self.table_name()]
        while self.eat_op(","):
            tables.append(self.table_name())
        cols = []
        while True:
            if self.eat_kw("ALL"):
                self.expect_kw("COLUMNS")
            elif self.eat_kw("PREDICATE"):
                self.expect_kw("COLUMNS")
            elif self.eat_kw("COLUMNS"):
                while True:
                    cols.append(self.ident())
                    if not self.eat_op(","):
                        break
            elif self.eat_kw("INDEX"):
                while self.peek().kind in (T.IDENT, T.QIDENT) and not self.at_kw("WITH"):
                    self.ident()
                    if not self.eat_op(","):
                        break
            elif self.eat_kw("PARTITION"):
                while True:
                    self.ident()
                    if not self.eat_op(","):
                        break
            elif self.eat_kw("WITH"):
                self.expect_number()
                self.next()  # BUCKETS | TOPN | SAMPLES | CMSKETCH ... 
                if self.eat_kw("WIDTH") or self.eat_kw("DEPTH"):
                    pass
            else:
                break
        return A.AnalyzeTableStmt(tables, cols)

    def admin_stmt(self) -> A.AdminStmt:
        self.next()
        if self.eat_kw("CHECK"):
            if self.eat_kw("INDEX"):
                t = self.table_name()
                self.ident()
                return A.AdminStmt("check_table", [t])
            self.expect_kw("TABLE")
            tables = [self.table_name()]
            while self.eat_op(","):
                tables.append(self.table_name())
            return A.AdminStmt("check_table", tables)
        if self.eat_kw("CHECKSUM"):
            self.expect_kw("TABLE")
            tables = [self.table_name()]
            while self.eat_op(","):
                tables.append(self.table_name())
            return A.AdminStmt("checksum_table", tables)
        if self.eat_kw("SHOW"):
            if self.eat_kw("DDL"):
                if self.eat_kw("JOBS"):
                    if self.at_kw("WHERE"):
                        self.next()
                        self.expr()
                    return A.AdminStmt("show_ddl_jobs")
                return A.AdminStmt("show_ddl")
            # ADMIN SHOW t NEXT_ROW_ID / SLOW / BDR ROLE ...
            while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER) and not self.at_op(";"):
                self.next()
            return A.AdminStmt("show_other")
        if self.eat_kw("CANCEL"):
            self.expect_kw("DDL")
            self.expect_kw("JOBS")
            ids = [self.expect_number()]
            while self.eat_op(","):
                ids.append(self.expect_number())
            return A.AdminStmt("cancel_ddl_jobs", job_ids=ids)
        if self.eat_kw("SET"):
            # ADMIN SET BDR ROLE PRIMARY/SECONDARY ...
            while self.peek().kind in (T.IDENT, T.QIDENT, T.NUMBER, T.STRING):
                self.next()
            return A.AdminStmt("set")
        if self.eat_kw("UNSET"):
            while self.peek().kind in (T.IDENT, T.QIDENT):
                self.next()
            return A.AdminStmt("unset")
        if self.eat_kw("RELOAD") or self.eat_kw("FLUSH"):
            while self.peek().kind in (T.IDENT, T.QIDENT):
                self.next()
            return A.AdminStmt("reload")
        if self.eat_kw("RECOVER") or self.eat_kw("CLEANUP"):
            while self.peek().kind in (T.IDENT, T.QIDENT):
                self.next()
            return A.AdminStmt("cleanup")
        raise ParseError(f"unsupported ADMIN at {self._where()}")

    def brie_stmt(self, kind: str) -> A.BRIEStmt:
        self.next()
        if kind == "backup" and self.eat_kw("LOG", "LOGS"):
            # BACKUP LOG TO 'file://dir' (ref: `br log start`):
            # attach the durable log backup changefeed
            self.expect_kw("TO")
            return A.BRIEStmt("backup_log", self.next().text)
        tables = []
        if self.eat_kw("TABLE"):
            tables.append(self.table_name())
            while self.eat_op(","):
                tables.append(self.table_name())
        elif self.eat_kw("DATABASE", "SCHEMA"):
            if self.eat_op("*"):
                pass  # BACKUP DATABASE * = full backup
            elif not self.at_kw("TO", "FROM"):
                db = self.ident()
                tables.append(A.TableName("*", db))
        if kind == "backup":
            self.expect_kw("TO")
        else:
            self.expect_kw("FROM")
        storage = self.next().text
        until_ts = None
        if kind == "restore" and self.eat_kw("UNTIL"):
            # RESTORE FROM 'file://dir' UNTIL TS = n (PITR —
            # full backup + log replay to exactly ts n)
            self.expect_kw("TS")
            self.eat_op("=")
            until_ts = self.expect_number()
        return A.BRIEStmt(kind, storage, tables, until_ts=until_ts)
