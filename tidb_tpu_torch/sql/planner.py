"""Planner: AST -> DAGRequest (ref: pkg/planner/optimize.go:135 Optimize ->
logical rules -> physical plan -> plan_to_pb.go lowering — collapsed here
into one direct lowering pass, because the engine's only physical form is
the fused coprocessor DAG; the reference's pushdown DECISIONS live in
distsql/root.py split_dag, its EXPRESSION serialization is the ir.Expr tree
itself).

What this pass does (reference rule analogs in parens):
  - name resolution over the FROM tables (expression/column resolution)
  - join planning: probe = largest table by row count, greedy equi-join
    chaining (JoinReOrderSolver's greedy variant); per-table conjuncts push
    into each side's pipeline (PPDSolver)
  - aggregation planning incl. implicit first_row for bare columns and
    DISTINCT -> group-by rewrite (AggregationEliminator family)
  - HAVING/ORDER BY resolution against the agg output schema with alias
    support; ORDER BY+LIMIT -> TopN (PushDownTopNOptimizer's shape)
  - select-list projection / output offsets

Copy of `tidb_tpu/sql/planner.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..exec.dag import Aggregation, ColumnInfo, DAGRequest, IndexScan, Join, Limit, Projection, Selection, Sort, TableScan, TopN
from ..expr.agg import AGG_FUNCS, AggDesc
from ..expr.ir import Expr, col, const, func, lit
from ..parser import ast as A
from ..types import Datum, DatumKind, FieldType, Flag, MyDecimal, MyTime, TypeCode, new_datetime, new_decimal, new_double, new_longlong, new_varchar
from .catalog import Catalog, CatalogError, TableMeta, field_type_from_spec

BOOL = new_longlong()


class PlanError(ValueError):
    pass


@dataclass
class PlannedQuery:
    """A lowered SELECT: the logical DAG plus what the executor needs to
    dispatch it (probe table for region ranges, build tables to broadcast)."""

    dag: DAGRequest
    probe_table: TableMeta
    build_tables: list  # [TableMeta] in canonical scan order (after probe)
    column_names: list  # output column labels
    offset: int = 0  # LIMIT offset — applied by the session on final rows
    ranges: list | None = None  # pruned scan ranges (ranger); None = full table
    access_path: str = "table"  # table | table-range | index(<name>) | index_lookup(<name>)
    # non-covering selective index: (index_id, index key ranges) — the
    # session runs the double-read (index scan -> handles -> table read,
    # ref: pkg/executor/distsql.go IndexLookUpExecutor)
    lookup: tuple | None = None
    # index merge (union): [(index_id, index key ranges), ...] — handles
    # from every member index union before the table read (ref:
    # pkg/executor/index_merge_reader.go IndexMergeReaderExecutor)
    lookup_merge: list | None = None
    # statistics-driven few-groups hint: NDV product of the group-by
    # columns when ANALYZE stats promise a small group count — routes the
    # aggregation onto the sort-free dense kernel (ops/aggregate.py);
    # a wrong promise overflows and falls back, never corrupts
    small_groups: int | None = None
    # how the scan ranges were derived — the plan cache's re-bind RECIPE
    #: ("full",) | ("handle", col) | ("index", index_id, col) |
    # ("lookup", index_id, col) | ("partition",) | ("index_merge",).
    # On a dag-tier hit, ranger re-runs over the bound conjuncts for the
    # named column — TiDB's rebuildRange-at-EXECUTE analog.
    range_src: tuple = ("full",)


# --------------------------------------------------------------------------
# scopes
# --------------------------------------------------------------------------

@dataclass
class _TableRef:
    meta: TableMeta
    alias: str
    offset: int  # column offset of this table in the combined schema


class _Scope:
    """Combined-schema name resolution (ref: expression resolver)."""

    def __init__(self, tables: list):
        self.tables = tables  # [_TableRef]

    def resolve(self, c: A.ColumnName):
        name = c.name.lower()
        tbl = c.table.lower()
        hits = []
        for tr in self.tables:
            if tbl and tr.alias != tbl and tr.meta.name != tbl:
                continue
            for i, cm in enumerate(tr.meta.columns):
                if cm.name == name:
                    hits.append((tr.offset + i, cm.ft))
        if not hits:
            raise PlanError(f"unknown column {c}")
        if len(hits) > 1:
            raise PlanError(f"ambiguous column {c}")
        return hits[0]

    def tables_of(self, node: A.ExprNode) -> set:
        """Aliases of tables referenced under `node`; ambiguous unqualified
        columns raise (MySQL ER_NON_UNIQ_ERROR), mirroring resolve()."""
        out: set = set()

        def walk(n):
            if isinstance(n, A.ColumnName):
                name, tbl = n.name.lower(), n.table.lower()
                hits = [
                    tr.alias
                    for tr in self.tables
                    if (not tbl or tr.alias == tbl or tr.meta.name == tbl)
                    and any(cm.name == name for cm in tr.meta.columns)
                ]
                if not hits:
                    raise PlanError(f"unknown column {n}")
                if len(hits) > 1:
                    raise PlanError(f"ambiguous column {n}")
                out.add(hits[0])
                return
            for c in _ast_children(n):
                walk(c)

        walk(node)
        return out


# --------------------------------------------------------------------------
# expression lowering
# --------------------------------------------------------------------------

def _ast_children(n):
    """Child ExprNodes of an AST node (one walker for every traversal —
    covers ExprNode fields, lists, and tuple entries like Case clauses)."""
    for f_ in getattr(n, "__dataclass_fields__", {}):
        v = getattr(n, f_)
        if isinstance(v, A.ExprNode):
            yield v
        elif isinstance(v, list):
            for it in v:
                if isinstance(it, A.ExprNode):
                    yield it
                elif isinstance(it, tuple):
                    for x in it:
                        if isinstance(x, A.ExprNode):
                            yield x


_CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "nulleq"}
_LOGIC_OPS = {"and", "or", "xor"}
_BIT_OPS = {"bitand", "bitor", "bitxor", "shiftleft", "shiftright"}


def _dec_scale(ft: FieldType) -> int:
    return max(ft.decimal, 0)


def _unify_fts(fts: list) -> FieldType:
    """Result type of branch-valued expressions (IF/CASE/COALESCE)."""
    ets = [ft.eval_type() for ft in fts]
    if "string" in ets:
        return new_varchar(max((ft.flen if ft.flen > 0 else 255) for ft in fts))
    if "real" in ets:
        return new_double()
    if "decimal" in ets:
        s = max(_dec_scale(ft) for ft in fts)
        return new_decimal(30, s)
    if "time" in ets:
        return new_datetime()
    return new_longlong()


def _arith_ft(op: str, lft: FieldType, rft: FieldType) -> FieldType:
    le, re = lft.eval_type(), rft.eval_type()
    if op in _BIT_OPS:
        return new_longlong(unsigned=True)
    if op == "intdiv":
        return new_longlong()
    if "real" in (le, re):
        return new_double()
    if op == "div":
        # decimal division: scale + 4 (ref: types DivFracIncr)
        s = max(_dec_scale(lft), _dec_scale(rft)) + 4
        return new_decimal(30, min(s, 30))
    if "decimal" in (le, re):
        s1, s2 = _dec_scale(lft), _dec_scale(rft)
        if op == "mul":
            return new_decimal(30, min(s1 + s2, 30))
        if op == "mod":
            return new_decimal(30, max(s1, s2))
        return new_decimal(30, max(s1, s2))  # plus/minus
    unsigned = lft.is_unsigned() or rft.is_unsigned()
    return new_longlong(unsigned=unsigned and op in ("plus", "mul"))


_FUNC_FTS = {
    "abs": "same", "ceil": "int_of", "ceiling": "int_of", "floor": "int_of",
    "sqrt": "real", "exp": "real", "ln": "real", "log": "real", "pow": "real",
    "power": "real", "sign": "int", "length": "int", "strcmp": "int",
    "year": "int", "month": "int", "day": "int", "dayofmonth": "int",
    "hour": "int", "minute": "int", "second": "int", "weekday": "int",
    "to_days": "int",
}

_FUNC_RENAME = {"ceiling": "ceil", "power": "pow", "dayofmonth": "day", "substring": "substr", "log": "ln"}


def _expand_row_cmp(n: A.BinaryOp) -> A.ExprNode:
    """Row-value comparison -> component expansion with SQL's own
    three-valued AND/OR semantics (ref: expression_rewriter.go
    constructBinaryOpFunction row decomposition):
      (a,b) =  (c,d)  ->  a=c AND b=d
      (a,b) <> (c,d)  ->  a<>c OR b<>d
      (a,b) <  (c,d)  ->  a<c OR (a=c AND b<d)     (lexicographic)
    """
    lt = n.left.items if isinstance(n.left, A.RowExpr) else [n.left]
    rt = n.right.items if isinstance(n.right, A.RowExpr) else [n.right]
    if len(lt) != len(rt):
        raise PlanError(f"Operand should contain {len(lt)} column(s)")
    import copy as _c

    def conj(op):
        out = None
        for a, b in zip(lt, rt):
            e = A.BinaryOp(op, _c.deepcopy(a), _c.deepcopy(b))
            out = e if out is None else A.BinaryOp("and", out, e)
        return out

    if n.op in ("eq", "nulleq"):
        return conj(n.op)
    if n.op == "ne":
        out = None
        for a, b in zip(lt, rt):
            e = A.BinaryOp("ne", _c.deepcopy(a), _c.deepcopy(b))
            out = e if out is None else A.BinaryOp("or", out, e)
        return out
    if n.op in ("lt", "le", "gt", "ge"):
        strict = {"lt": "lt", "le": "lt", "gt": "gt", "ge": "gt"}[n.op]
        out = None
        for i in range(len(lt)):
            last = i == len(lt) - 1
            op_i = n.op if last else strict
            e = A.BinaryOp(op_i, _c.deepcopy(lt[i]), _c.deepcopy(rt[i]))
            for j in range(i):
                e = A.BinaryOp("and", A.BinaryOp("eq", _c.deepcopy(lt[j]), _c.deepcopy(rt[j])), e)
            out = e if out is None else A.BinaryOp("or", out, e)
        return out
    raise PlanError(f"row-value comparison {n.op!r} not supported")


class _Lowerer:
    """AST expression -> ir.Expr against a base scope, optionally through an
    aggregation output schema (agg scope)."""

    def __init__(self, scope: _Scope, aliases: dict | None = None):
        self.scope = scope
        self.aliases = aliases or {}
        # agg context (installed by the SELECT planner when aggregating)
        self.group_asts: list = []
        self.agg_descs: list = []  # [AggDesc] in output order
        self.agg_asts: list = []  # matching AST nodes
        self.n_agg_cols = 0
        self.in_agg_ctx = False
        # window slots: id(A.WindowFunc node) -> ColumnRef into the Window
        # executor's appended output columns (installed by plan_select)
        self.window_slots: dict = {}

    def _expand_alias(self, name: str) -> Expr:
        """Lower an alias's defining expression with the alias itself masked
        out (SELECT salary*2 AS salary must not recurse forever)."""
        target = self.aliases.pop(name)
        try:
            return self.lower(target)
        finally:
            self.aliases[name] = target

    # -- agg scope helpers --------------------------------------------------
    def _group_index(self, node) -> int | None:
        for i, g in enumerate(self.group_asts):
            if g == node:
                return i
        return None

    def _agg_ref(self, desc: AggDesc, ast_node) -> Expr:
        for i, (d, a) in enumerate(zip(self.agg_descs, self.agg_asts)):
            if a == ast_node:
                return col(i, d.ft)
        self.agg_descs.append(desc)
        self.agg_asts.append(ast_node)
        return col(len(self.agg_descs) - 1, desc.ft)

    def lower_agg_func(self, n: A.AggFunc) -> Expr:
        name = n.name
        if name in ("std", "stddev", "stddev_pop"):
            name = "stddev_pop"
        if name in ("variance", "var_pop"):
            name = "var_pop"
        if name not in AGG_FUNCS:
            raise PlanError(f"aggregate {n.name!r} not supported yet")
        if name == "count" and len(n.args) == 1 and isinstance(n.args[0], A.Star):
            args = ()
        else:
            args = tuple(self.lower_base(a) for a in n.args)
        extra = None
        if name == "group_concat":
            if n.order_by:
                raise PlanError("GROUP_CONCAT(... ORDER BY) not supported yet")
            extra = n.separator if n.separator is not None else ","
        desc = AggDesc(name, args, distinct=n.distinct, extra=extra)
        return self._agg_ref(desc, n)

    # -- entry points ---------------------------------------------------------
    def lower(self, n: A.ExprNode) -> Expr:
        """Lower in the current context (agg-aware when in_agg_ctx)."""
        if self.in_agg_ctx:
            return self.lower_in_agg(n)
        return self.lower_base(n)

    def lower_in_agg(self, n: A.ExprNode) -> Expr:
        """Lower against the aggregation OUTPUT schema: agg funcs and
        group-by expressions become column refs; bare columns outside both
        get an implicit first_row (MySQL loose group-by)."""
        gi = self._group_index(n)
        if gi is not None:
            # group key columns sit after the agg columns
            g_expr = self.lower_base(self.group_asts[gi])
            return _DeferredGroupRef(gi, g_expr.ft)
        if isinstance(n, A.AggFunc):
            return self.lower_agg_func(n)
        if isinstance(n, A.ColumnName):
            if not n.table and n.name.lower() in self.aliases:
                return self._expand_alias(n.name.lower())
            fr = AggDesc("first_row", (self.lower_base(n),))
            return self._agg_ref(fr, n)
        if isinstance(n, A.Literal):
            return self.lower_base(n)
        # recurse structurally: rebuild the node with lowered children
        return self._structural(n, self.lower_in_agg)

    def _structural(self, n, rec):
        """Lower a compound node by dispatching on type with `rec` for
        children (shared between base and agg contexts)."""
        if isinstance(n, A.WindowFunc):
            slot = self.window_slots.get(id(n))
            if slot is None:
                raise PlanError(
                    f"window function {n.name!r} is only supported in the select "
                    "list and ORDER BY"
                )
            return slot
        if isinstance(n, A.BinaryOp):
            if isinstance(n.left, A.RowExpr) or isinstance(n.right, A.RowExpr):
                return rec(_expand_row_cmp(n))
            l, r = rec(n.left), rec(n.right)
            return self._binary(n.op, l, r)
        if isinstance(n, A.UnaryOp):
            a = rec(n.operand)
            if n.op == "not":
                return func("not", BOOL, a)
            if n.op == "unaryminus":
                ft = a.ft if a.ft.eval_type() in ("decimal",) else (new_double() if a.ft.eval_type() == "real" else new_longlong())
                return func("unaryminus", ft, a)
            if n.op == "bitneg":
                return func("bitneg", new_longlong(unsigned=True), a)
            raise PlanError(f"unary op {n.op}")
        if isinstance(n, A.IsNull):
            e = func("isnull", BOOL, rec(n.expr))
            return func("not", BOOL, e) if n.negated else e
        if isinstance(n, A.Between):
            x = rec(n.expr)
            lo, hi = self._coerce_const(x, rec(n.low), "lt"), self._coerce_const(x, rec(n.high), "lt")
            e = func("between", BOOL, x, lo, hi)
            return func("not", BOOL, e) if n.negated else e
        if isinstance(n, A.InList):
            if isinstance(n.expr, A.RowExpr) or any(
                isinstance(i, A.RowExpr) for i in n.items
            ):
                # (a,b) IN ((1,2),(3,4)) -> OR of row equalities, each a
                # component conjunction — SQL three-valued logic keeps the
                # NULL semantics exact (ref: expression_rewriter.go
                # buildRowExpr / the NAAJ decomposition)
                disj = None
                for i in n.items:
                    e = _expand_row_cmp(A.BinaryOp("eq", n.expr, i))
                    disj = e if disj is None else A.BinaryOp("or", disj, e)
                if n.negated:
                    disj = A.UnaryOp("not", disj)
                return rec(disj)
            x = rec(n.expr)
            items = [self._coerce_const(x, rec(i), "in") for i in n.items]
            e = func("in", BOOL, x, *items)
            return func("not", BOOL, e) if n.negated else e
        if isinstance(n, A.Like):
            e = func("like", BOOL, rec(n.expr), rec(n.pattern))
            return func("not", BOOL, e) if n.negated else e
        if isinstance(n, A.Case):
            whens = n.when_clauses
            args = []
            for cond, res in whens:
                c = self._binary("eq", rec(n.operand), rec(cond)) if n.operand is not None else rec(cond)
                args.append((c, rec(res)))
            else_e = rec(n.else_clause) if n.else_clause is not None else None
            branch_fts = [r.ft for _, r in args] + ([else_e.ft] if else_e is not None else [])
            ft = _unify_fts(branch_fts)
            flat = []
            for c, r in args:
                flat.extend((c, r))
            if else_e is not None:
                flat.append(else_e)
            return func("case", ft, *flat)
        if isinstance(n, A.Cast):
            ft = field_type_from_spec(n.to_type)
            if getattr(n.to_type, "name", "") == "date":
                # field_type_from_spec folds DATE into DATETIME storage;
                # the CAST result type keeps the DATE kind so the oracle
                # truncates the time part (ref: builtin_cast.go
                # castStringAsTime with tp mysql.TypeDate)
                ft = ft.clone()
                ft.tp = TypeCode.Date
            if n.to_type.name == "signed":
                ft = new_longlong()
            elif n.to_type.name == "unsigned":
                ft = new_longlong(unsigned=True)
            return func("cast", ft, rec(n.expr))
        if isinstance(n, A.FuncCall):
            return self._func_call(n, rec)
        if isinstance(n, A.CollateExpr):
            # expr COLLATE c: same value, comparisons use the named
            # collation (ref: expression.BuildCollationFunction) — only the
            # ci-ness matters to this engine's compare kernels
            e = rec(n.expr)
            ft = e.ft.clone()
            from ..types import Collation

            ft.collate = (
                Collation.Utf8MB4GeneralCI
                if n.collation.endswith(("_general_ci", "_0900_ai_ci", "_ci"))
                else Collation.Utf8MB4Bin
            )
            import dataclasses

            return dataclasses.replace(e, ft=ft)
        if isinstance(n, A.Regexp):
            l, r = rec(n.expr), rec(n.pattern)
            out = func("regexp", BOOL, l, r)
            return func("not", BOOL, out) if n.negated else out
        raise PlanError(f"unsupported expression {type(n).__name__}")

    _JSON_FUNCS = {
        "json_extract": "json", "json_unquote": "varchar", "json_type": "varchar",
        "json_valid": "bool", "json_length": "int", "json_keys": "json",
        "json_contains": "bool", "json_member_of": "bool", "json_array": "json",
        "json_object": "json", "json_quote": "varchar",
    }

    def _func_call(self, n: A.FuncCall, rec):
        name = _FUNC_RENAME.get(n.name, n.name)
        if name in self._JSON_FUNCS:
            from ..types import new_json

            args = [rec(a) for a in n.args]
            kind = self._JSON_FUNCS[name]
            ft = (
                new_json() if kind == "json"
                else new_varchar() if kind == "varchar"
                else new_longlong() if kind == "int"
                else BOOL
            )
            return func(name, ft, *args)
        if name in ("regexp_like",):
            return func("regexp_like", BOOL, *[rec(a) for a in n.args])
        if name in ("now", "current_timestamp", "sysdate", "current_date", "curdate", "localtime", "localtimestamp"):
            # statement-time constant (MySQL: now() is fixed per statement;
            # ref: builtin_time.go evalNowWithFsp) — volatile on host, a
            # Const by the time anything reaches the device
            import datetime as _dt

            from ..expr.ir import Const

            t = _dt.datetime.now()
            if name in ("current_date", "curdate"):
                mt = MyTime.from_ymd(t.year, t.month, t.day)
            else:
                mt = MyTime.from_ymd(t.year, t.month, t.day, t.hour, t.minute, t.second)
            return Const(Datum.time(mt), new_datetime())
        if name in ("date_add", "date_sub", "adddate", "subdate"):
            name = "date_add" if name in ("date_add", "adddate") else "date_sub"
            d = rec(n.args[0])
            iv = n.args[1]
            if not isinstance(iv, A.Interval):
                raise PlanError(f"{name} expects an INTERVAL argument")
            unit = iv.unit.lower()
            if unit not in ("second", "minute", "hour", "day", "week", "month", "quarter", "year"):
                raise PlanError(f"interval unit {unit!r} not supported")
            nexpr = rec(iv.value)
            if not d.ft.is_time():
                d = func("cast", new_datetime(), d)
            return func(name, d.ft.clone(), d, nexpr, lit(unit, new_varchar(8)))
        args = [rec(a) for a in n.args]
        if name == "extract":
            # EXTRACT(unit FROM e): simple units ride as a const string arg
            # (compile.py / eval_ref.py _op_extract dispatch); composite
            # units decompose into arithmetic over the simple ones (ref:
            # types.ExtractDatetimeNum, builtin_time.go extract)
            d = args[1]
            if not d.ft.is_time():
                d = func("cast", new_datetime(), d)
            unit = str(n.args[0].value).lower()
            LL = new_longlong()

            def part(u):
                return func(u, LL, d)

            composite = {
                "year_month": [("year", 100), ("month", 1)],
                "day_hour": [("day", 100), ("hour", 1)],
                "day_minute": [("day", 10000), ("hour", 100), ("minute", 1)],
                "day_second": [("day", 1000000), ("hour", 10000), ("minute", 100), ("second", 1)],
                "hour_minute": [("hour", 100), ("minute", 1)],
                "hour_second": [("hour", 10000), ("minute", 100), ("second", 1)],
                "minute_second": [("minute", 100), ("second", 1)],
            }
            simple = {"year", "month", "day", "hour", "minute", "second"}
            if unit not in composite and unit not in simple:
                # WEEK/QUARTER/MICROSECOND and *_MICROSECOND composites:
                # the packed kernels carry no microsecond/week machinery —
                # a clean error beats the raw unknown-scalar-op crash
                raise PlanError(f"EXTRACT unit {unit!r} not supported yet")
            if unit in composite:
                out = None
                for u, scale in composite[unit]:
                    t = part(u) if scale == 1 else func(
                        "mul", LL, part(u), lit(scale, LL)
                    )
                    out = t if out is None else func("plus", LL, out, t)
                return out
            return func("extract", new_longlong(), args[0], d)
        if name == "convert_using":
            # CONVERT(expr USING cs): value re-encoded into cs at eval time
            # (ref: pkg/expression/builtin_string.go builtinConvertSig);
            # the result type carries the target charset so downstream
            # byte-semantics functions (HEX, LENGTH, MD5...) see cs bytes
            cs = n.args[1].value if hasattr(n.args[1], "value") else "binary"
            a = args[0]
            flen = a.ft.flen if a.ft.flen and a.ft.flen > 0 else 255
            ft = new_varchar(flen)
            ft.charset = str(cs)
            if str(cs) == "binary":
                from ..types import Collation, Flag

                ft.collate = Collation.Binary
                ft.flag |= Flag.Binary
            return func("convert_using", ft, *args)
        if name == "datediff":
            a, b = args
            # string-literal dates re-parse as datetime consts (either side)
            a2 = self._coerce_const(b if b.ft.is_time() else lit("", new_datetime()), a)
            b2 = self._coerce_const(a2 if a2.ft.is_time() else lit("", new_datetime()), b)
            for x in (a2, b2):
                if not x.ft.is_time():
                    raise PlanError("datediff expects date/datetime arguments")
            return func("datediff", new_longlong(), a2, b2)
        if name in ("concat", "upper", "ucase", "lower", "lcase", "trim", "ltrim", "rtrim", "replace"):
            name = {"ucase": "upper", "lcase": "lower"}.get(name, name)
            flen = sum(max(a.ft.flen, 0) or 255 for a in args) if name == "concat" else (args[0].ft.flen if args[0].ft.flen > 0 else 255)
            return func(name, new_varchar(max(flen, 1)), *args)
        if name == "if":
            ft = _unify_fts([args[1].ft, args[2].ft])
            return func("if", ft, *args)
        if name == "ifnull":
            return func("ifnull", _unify_fts([a.ft for a in args]), *args)
        if name == "coalesce":
            return func("coalesce", _unify_fts([a.ft for a in args]), *args)
        if name == "round":
            a = args[0]
            if a.ft.eval_type() == "decimal":
                d = 0
                if len(args) > 1:
                    d = _const_int(args[1])
                return func("round", new_decimal(30, max(d, 0)), *args)
            ft = new_double() if a.ft.eval_type() == "real" else new_longlong()
            return func("round", ft, *args)
        if name == "substr":
            return func("substr", args[0].ft.clone(), *args)
        if name in _FUNC_FTS:
            kind = _FUNC_FTS[name]
            a = args[0]
            if kind == "same":
                ft = a.ft.clone()
            elif kind == "real":
                ft = new_double()
            elif kind == "int_of":
                ft = new_longlong() if a.ft.eval_type() != "real" else new_double()
            else:
                ft = new_longlong()
            return func(name, ft, *args)
        from .extension import EXTENSIONS

        cf = EXTENSIONS.functions.get(name)
        if cf is not None:
            # custom host function: lowered like a builtin, pinned to the
            # root side by the DAG splitter (extension.py module doc)
            return func(name, cf.ft, *args)
        raise PlanError(f"function {n.name!r} not supported yet")

    # -- base lowering --------------------------------------------------------
    def lower_base(self, n: A.ExprNode) -> Expr:
        if isinstance(n, A.Literal):
            return _lower_literal(n)
        if isinstance(n, A.ColumnName):
            # real columns shadow select aliases (MySQL resolution order for
            # WHERE); aliases only cover names with no underlying column
            try:
                idx, ft = self.scope.resolve(n)
                return col(idx, ft)
            except PlanError:
                if not n.table and n.name.lower() in self.aliases:
                    return self._expand_alias(n.name.lower())
                raise
        if isinstance(n, A.AggFunc):
            raise PlanError(f"aggregate {n.name} in a non-aggregated context")
        return self._structural(n, self.lower_base)

    def _binary(self, op: str, l: Expr, r: Expr) -> Expr:
        if op in _CMP_OPS:
            l, r = self._coerce_pair(l, r, op)
            return func(op, BOOL, l, r)
        if op in _LOGIC_OPS:
            return func(op, BOOL, l, r)
        ft = _arith_ft(op, l.ft, r.ft)
        return func(op, ft, l, r)

    def _coerce_pair(self, l: Expr, r: Expr, op: str = "eq"):
        return self._coerce_const(r, l, op), self._coerce_const(l, r, op)

    @staticmethod
    def _coerce_const(target: Expr, e: Expr, op: str = "eq") -> Expr:
        """String literals compared with time columns re-parse as datetime
        consts; with ENUM/SET columns they become member numbers (MySQL
        implicit coercion; ref: types/enum.go ParseEnumName)."""
        from ..expr.ir import Const

        if (
            isinstance(e, Const)
            and target.ft.is_time()
            and e.ft.is_string()
            and e.datum.val is not None
        ):
            return lit(str(e.datum.val), new_datetime())
        if (
            isinstance(e, Const)
            and target.ft.tp in (TypeCode.Enum, TypeCode.Set)
            and e.ft.is_string()
            and e.datum.val is not None
        ):
            try:
                d = _coerce_datum(e.datum, target.ft)
            except PlanError:
                # non-member literal: the -1 sentinel is match-nothing only
                # under (in)equality (member numbers are >= 1, so eq/in
                # never match and ne matches every non-NULL row); ordering
                # against it would invert range predicates, so raise there
                if op in ("eq", "ne", "nulleq", "in"):
                    return Const(Datum.i64(-1), new_longlong())
                raise PlanError(
                    f"cannot order {target.ft.tp.name} column against "
                    f"non-member literal {e.datum.val!r}"
                ) from None
            return Const(Datum.u64(int(d.val)), new_longlong(unsigned=True))
        return e


class _DeferredGroupRef(Expr):
    """Placeholder for a group-key column whose final index depends on the
    number of agg output columns (resolved by the SELECT planner)."""

    __slots__ = ("gi", "ft")

    def __init__(self, gi: int, ft: FieldType):
        self.gi = gi
        self.ft = ft

    def fingerprint(self):
        raise AssertionError("deferred ref must be resolved before use")


def _resolve_deferred(e: Expr, n_aggs: int) -> Expr:
    if isinstance(e, _DeferredGroupRef):
        return col(n_aggs + e.gi, e.ft)
    from ..expr.ir import ScalarFunc

    if isinstance(e, ScalarFunc):
        return func(e.op, e.ft, *(_resolve_deferred(a, n_aggs) for a in e.args))
    return e


def _const_int(e: Expr) -> int:
    from ..expr.ir import Const

    if isinstance(e, Const) and e.datum.val is not None:
        return int(e.datum.val)
    raise PlanError("constant integer expected")


def _coerce_datum(d: Datum, ft: FieldType) -> Datum:
    """Datum -> column type (insert/update path; ref: table.CastValue)."""
    if d.is_null():
        return d
    if ft.tp == TypeCode.Enum:
        if d.kind == DatumKind.MysqlEnum:
            return d
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            name = d.val if isinstance(d.val, str) else bytes(d.val).decode()
            low = [e.lower() for e in ft.elems]
            if name.lower() not in low:
                raise PlanError(f"invalid enum value {name!r}")
            return Datum.enum_from(ft.elems, low.index(name.lower()) + 1)
        n = int(d.val)
        if not 0 < n <= len(ft.elems):
            raise PlanError(f"invalid enum number {n}")
        return Datum.enum_from(ft.elems, n)
    if ft.tp == TypeCode.Set:
        if d.kind == DatumKind.MysqlSet:
            return d
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            raw = d.val if isinstance(d.val, str) else bytes(d.val).decode()
            low = [e.lower() for e in ft.elems]
            mask = 0
            for part in ([] if raw == "" else raw.split(",")):
                if part.lower() not in low:
                    raise PlanError(f"invalid set member {part!r}")
                mask |= 1 << low.index(part.lower())
            return Datum.set_from(ft.elems, mask)
        mask = int(d.val)
        return Datum.set_from(ft.elems, mask)
    et = ft.eval_type()
    if d.kind == DatumKind.MysqlJSON and et != "json":
        # JSON scalar -> SQL value (generated columns over JSON_EXTRACT,
        # CAST(json AS ...); ref: pkg/expression/builtin_cast.go json paths)
        from ..types import json_binary as _jb

        v = _jb.decode(bytes(d.val))
        if v is None:
            return Datum.NULL
        if isinstance(v, bool):
            d = Datum.i64(1 if v else 0)
        elif isinstance(v, (int, float)):
            d = Datum.i64(v) if isinstance(v, int) else Datum.f64(v)
        elif isinstance(v, str):
            d = Datum.string(v)
        else:
            d = Datum.string(_jb.to_text(v))
    if et == "decimal":
        if d.kind == DatumKind.MysqlDecimal:
            return Datum.dec(d.val.round(max(ft.decimal, 0)))
        return Datum.dec(MyDecimal(str(d.val)).round(max(ft.decimal, 0)))
    if et == "real":
        return Datum.f64(float(d.val.to_float() if d.kind == DatumKind.MysqlDecimal else d.val))
    if et == "int":
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            from ..expr.eval_ref import str_prefix_f64

            return Datum.i64(int(round(str_prefix_f64(d.val))))
        if d.kind == DatumKind.MysqlDecimal:
            return Datum.i64(int(d.val.round(0).to_int()))
        if ft.is_unsigned():
            return Datum.u64(int(d.val))
        return Datum.i64(int(d.val))
    if et == "time":
        if d.kind == DatumKind.MysqlTime:
            return d
        return Datum.time(MyTime.parse(str(d.val), max(ft.decimal, 0)))
    if et == "string":
        if ft.tp == TypeCode.String and ft.charset == "binary" and ft.flen > 0:
            # BINARY(n) stores zero-padded to the declared width (ref:
            # pkg/table/column.go CastValue -> ProduceStrWithSpecifiedTp)
            b = d.val if isinstance(d.val, (bytes, bytearray)) else str(d.val).encode("utf-8")
            b = bytes(b)
            if len(b) > ft.flen:
                raise PlanError(f"Data too long for column (max {ft.flen})")
            return Datum.bytes_(b.ljust(ft.flen, b"\0"))
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            return d
        return Datum.string(str(d.val))
    if et == "json":
        from ..types import json_binary as _jb

        if d.kind == DatumKind.MysqlJSON:
            return d
        if d.kind in (DatumKind.String, DatumKind.Bytes):
            txt = d.val if isinstance(d.val, str) else bytes(d.val).decode("utf-8", "surrogateescape")
            try:
                return Datum.json(_jb.encode(_jb.parse_text(txt)))
            except ValueError as exc:
                raise PlanError(f"invalid JSON text: {exc}") from exc
        if d.kind in (DatumKind.Int64, DatumKind.Uint64):
            return Datum.json(_jb.encode(int(d.val)))
        if d.kind in (DatumKind.Float32, DatumKind.Float64):
            return Datum.json(_jb.encode(float(d.val)))
        raise PlanError(f"cannot cast {d.kind.name} to JSON")
    return d


def datum_ft(d: Datum) -> FieldType:
    """Natural FieldType of a materialized datum (subquery results carry
    Datums back into expression trees as `kind="datum"` literals)."""
    if d.kind == DatumKind.Int64:
        return new_longlong()
    if d.kind == DatumKind.Uint64:
        return new_longlong(unsigned=True)
    if d.kind in (DatumKind.Float32, DatumKind.Float64):
        return new_double()
    if d.kind == DatumKind.MysqlDecimal:
        return new_decimal(max(len(str(d.val)), 1), d.val.scale)
    if d.kind == DatumKind.MysqlTime:
        return new_datetime()
    if d.kind in (DatumKind.String, DatumKind.Bytes):
        return new_varchar(max(len(str(d.val)), 1))
    return new_longlong()


def _lower_literal(n: A.Literal) -> Expr:
    if n.kind == "null":
        return lit(None, new_longlong())
    if n.kind == "datum":
        from ..expr.ir import Const

        d: Datum = n.value
        if d.is_null():
            return lit(None, new_longlong())
        return Const(d, datum_ft(d))
    if n.kind in ("int", "bool"):
        # keep int subclasses intact: the plan cache's slot-tagged
        # literals (plancache.SlotInt) must survive lowering so the
        # install-time audit can find every re-bindable Const
        v = n.value if (isinstance(n.value, int)
                        and not isinstance(n.value, bool)) else int(n.value)
        if -(1 << 63) <= v < (1 << 63):
            return lit(v, new_longlong())
        return lit(int(v), new_longlong(unsigned=True))
    if n.kind == "decimal":
        text = str(n.value)
        scale = len(text.split(".", 1)[1]) if "." in text else 0
        e = lit(None, new_decimal(max(len(text), 1), scale))
        from ..expr.ir import Const

        return Const(Datum.dec(MyDecimal(text)), e.ft)
    if n.kind == "float":
        return lit(float(str(n.value)), new_double())
    if n.kind == "str":
        v = n.value if isinstance(n.value, str) else str(n.value)
        return lit(v, new_varchar(max(len(v), 1)))
    if n.kind == "hex":
        # hex literals are VARBINARY values (ref: pkg/parser/ast/expressions.go
        # hexadecimal literal -> binary collation), NOT latin1 text: byte
        # semantics must survive into comparisons, CONCAT and INSERT targets
        from ..types import Collation, Flag

        ft = new_varchar(max(len(n.value), 1))
        ft.charset = "binary"
        ft.collate = Collation.Binary
        ft.flag |= Flag.Binary
        return const(Datum.bytes_(bytes(n.value)), ft)
    raise PlanError(f"literal kind {n.kind}")


# --------------------------------------------------------------------------
# FROM / join planning
# --------------------------------------------------------------------------

def _resolve_table(name: str, catalog: Catalog, mat: dict | None, db: str = "") -> TableMeta:
    """Materialized (CTE/derived) tables shadow catalog tables. A db
    qualifier resolves ONLY the db-scoped binding (information_schema
    memtables register under "information_schema.<name>", never shadowing
    same-named user tables)."""
    if db and db not in ("test",):
        if mat:
            m = mat.get(f"{db.lower()}.{name.lower()}")
            if m is not None:
                return m
        raise PlanError(f"unknown table {db}.{name}")
    if mat:
        m = mat.get(name.lower())
        if m is not None:
            return m
    return catalog.table(name)


def _flatten_from(node, catalog: Catalog, mat: dict | None = None) -> list:
    """FROM tree -> [(TableMeta, alias, kind, on_expr)] left-deep order.
    JOIN ... USING(cols) desugars to ON equality conjuncts."""
    if isinstance(node, A.TableName):
        meta = _resolve_table(node.name, catalog, mat, getattr(node, "db", ""))
        # an unaliased multi-db table is qualified by its SHORT name
        # (MySQL: the db prefix is not part of the column qualifier)
        return [(meta, (node.alias or node.name.rsplit(".", 1)[-1]).lower(), "inner", None)]
    if isinstance(node, A.Join):
        left = _flatten_from(node.left, catalog, mat)
        right = _flatten_from(node.right, catalog, mat)
        if len(right) != 1:
            raise PlanError("right-nested joins not supported")
        meta, alias, _, _ = right[0]
        kind = {"inner": "inner", "cross": "inner", "left": "left"}.get(node.kind)
        if kind is None:
            raise PlanError(f"join kind {node.kind!r} not supported")
        on = node.on
        if node.using:
            for cname in node.using:
                cn = cname.lower() if isinstance(cname, str) else cname.name.lower()
                lt = next((la for lm, la, _, _ in left if any(c.name == cn for c in lm.columns)), None)
                if lt is None:
                    raise PlanError(f"USING column {cn!r} not found on the left side")
                eq = A.BinaryOp("eq", A.ColumnName(cn, lt), A.ColumnName(cn, alias))
                on = eq if on is None else A.BinaryOp("and", on, eq)
        return left + [(meta, alias, kind, on)]
    raise PlanError(f"unsupported FROM clause {type(node).__name__}")


def _split_conjuncts(e: A.ExprNode | None) -> list:
    if e is None:
        return []
    if isinstance(e, A.BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _equi_sides(e: A.ExprNode):
    if isinstance(e, A.BinaryOp) and e.op == "eq":
        return e.left, e.right
    return None


def _has_agg(n) -> bool:
    if isinstance(n, A.AggFunc):
        return True
    return any(_has_agg(c) for c in _ast_children(n))


def _has_window(n) -> bool:
    if isinstance(n, A.WindowFunc):
        return True
    return any(_has_window(c) for c in _ast_children(n))


_WIN_NO_ARG = frozenset({"row_number", "rank", "dense_rank", "percent_rank", "cume_dist"})


def _plan_windows(win_nodes: list, low: "_Lowerer", executors: list) -> None:
    """Group the collected A.WindowFunc nodes by (partition, order) spec,
    append one Window executor per spec, and register column slots so the
    select-list lowering sees plain ColumnRefs (ref: buildWindowFunctions
    grouping same-spec functions into one Window operator)."""
    from ..exec.dag import Window as WindowExec
    from ..exec.dag import WinDesc, current_schema_fts
    from ..ops.window import WINDOW_FUNCS

    cursor = len(current_schema_fts(executors))
    specs: dict = {}
    order_keys: list = []
    for n in win_nodes:
        if getattr(n, "has_frame", False):
            raise PlanError(
                "explicit window frames (ROWS/RANGE) are not supported yet "
                "(default frames only)"
            )
        p_exprs = tuple(low.lower_base(e) for e in n.partition_by)
        o_items = tuple((low.lower_base(b.expr), b.desc) for b in n.order_by)
        key = tuple(p.fingerprint() for p in p_exprs) + ("|",) + tuple(
            (e.fingerprint(), d) for e, d in o_items
        )
        if key not in specs:
            specs[key] = (p_exprs, o_items, [])
            order_keys.append(key)
        specs[key][2].append(n)

    for key in order_keys:
        p_exprs, o_items, nodes = specs[key]
        descs = []
        for n in nodes:
            name = n.name.lower()
            if name not in WINDOW_FUNCS:
                raise PlanError(f"window function {name!r} not supported")
            args: tuple = ()
            offset, default = 1, None
            if name in _WIN_NO_ARG:
                if n.args:
                    raise PlanError(f"{name}() takes no arguments")
            elif name == "ntile":
                if len(n.args) != 1:
                    raise PlanError("ntile(n) takes one argument")
                offset = _const_int(low.lower_base(n.args[0]))
                if offset < 1:
                    raise PlanError("ntile argument must be >= 1")
            elif name in ("lead", "lag"):
                if not (1 <= len(n.args) <= 3):
                    raise PlanError(f"{name}(expr[, offset[, default]])")
                args = (low.lower_base(n.args[0]),)
                if len(n.args) > 1:
                    offset = _const_int(low.lower_base(n.args[1]))
                if len(n.args) > 2:
                    default = low.lower_base(n.args[2])
                    # value and default unify to one result type (MySQL
                    # unifies them; the device kernel mixes their lanes)
                    uft = _unify_fts([args[0].ft, default.ft])
                    if args[0].ft.eval_type() != uft.eval_type() or _dec_scale(args[0].ft) != _dec_scale(uft):
                        args = (func("cast", uft, args[0]),)
                    if default.ft.eval_type() != uft.eval_type() or _dec_scale(default.ft) != _dec_scale(uft):
                        default = func("cast", uft, default)
            elif name == "nth_value":
                if len(n.args) != 2:
                    raise PlanError("nth_value(expr, n) takes two arguments")
                args = (low.lower_base(n.args[0]),)
                offset = _const_int(low.lower_base(n.args[1]))
                if offset < 1:
                    raise PlanError("nth_value position must be >= 1")
            elif name == "count" and len(n.args) == 1 and isinstance(n.args[0], A.Star):
                args = ()
            else:
                if len(n.args) != 1:
                    raise PlanError(f"window {name}() takes one argument")
                args = (low.lower_base(n.args[0]),)
            descs.append(WinDesc(name, args, _win_ft(name, args), offset, default))
            low.window_slots[id(n)] = col(cursor, descs[-1].ft)
            cursor += 1
        executors.append(WindowExec(p_exprs, o_items, tuple(descs)))


def _win_ft(name: str, args: tuple) -> FieldType:
    """Window result type (ref: aggfuncs type inference per function)."""
    if name in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return new_longlong(notnull=True)
    if name in ("percent_rank", "cume_dist"):
        return new_double()
    if name in ("sum", "avg"):
        return AggDesc(name, args).ft
    return args[0].ft.clone_nullable()


def _referenced_columns(stmt: A.SelectStmt, meta: TableMeta) -> set:
    """All column names a single-table SELECT touches (star = every
    column) — the covering-index eligibility set."""
    names: set = set()
    star = [False]

    def walk(n):
        if isinstance(n, A.Star):
            star[0] = True
            return
        if isinstance(n, A.ColumnName):
            names.add(n.name.lower())
            return
        if isinstance(n, A.AggFunc):
            # count(*) references no columns — its Star is not select-star
            for a in n.args:
                if not isinstance(a, A.Star):
                    walk(a)
            for b in n.order_by:
                walk(b.expr)
            return
        for c in _ast_children(n):
            walk(c)

    for f in stmt.fields:
        walk(f.expr if isinstance(f, A.SelectField) else f)
    if stmt.where is not None:
        walk(stmt.where)
    for b in stmt.group_by:
        walk(b.expr)
    if stmt.having is not None:
        walk(stmt.having)
    for b in stmt.order_by:
        walk(b.expr)
    if star[0]:
        names |= {c.name for c in meta.columns}
    return names


def _field_label(f: A.SelectField) -> str:
    """MySQL column titles: alias > column name as written (unqualified,
    quotes stripped) > the expression's verbatim source text (ref: field
    name derivation in the reference's buildProjectionField)."""
    if f.alias:
        return f.alias
    src = getattr(f, "source", "") or ""
    if isinstance(f.expr, A.ColumnName):
        if src and "(" not in src:
            if "`" in src:
                # backquoted identifiers may CONTAIN dots: take the last
                # quoted segment verbatim (`t`.`a.b` titles as a.b)
                import re as _re

                parts = _re.findall(r"`((?:[^`]|``)*)`", src)
                if parts:
                    return parts[-1].replace("``", "`")
            return src.split(".")[-1].strip().strip("`") or f.expr.name
        return f.expr.name
    if isinstance(f.expr, A.Literal) and f.expr.kind == "str" and src[:1] in ("'", '"'):
        # MySQL titles a bare string literal with its VALUE, quotes gone
        return str(f.expr.value)
    if src:
        # MySQL folds no-op unary + out of titles ('+1' -> '1',
        # '+ "x"' -> 'x') but keeps mixed-sign prefixes ('+ - 1', '+-+1')
        rest = src
        while rest[:1] == "+":
            rest = rest[1:].lstrip()
        if rest != src and rest[:1] != "-":
            if rest[:1] in ("'", '"') and len(rest) >= 2 and rest[-1] == rest[0]:
                return rest[1:-1]
            return rest
        return src
    if isinstance(f.expr, A.AggFunc):
        return f"{f.expr.name}(...)"
    return "expr"


def _build_keys_unique(meta, build_keys) -> bool:
    """True when the build-side join keys are provably unique per build row
    — the table's integer PK handle or a unique index covering exactly the
    key columns. The kernel then skips the join fan-out expansion (dag.py
    Join.build_unique; ref: hash_join_v2.go one-row-per-key row table).
    Build pipelines here are scan[+selection], so key ColumnRef indexes map
    straight onto meta.columns; filtering only removes rows, never breaks
    uniqueness. Conservative: any non-bare-column key disqualifies."""
    from ..expr.ir import ColumnRef

    names = set()
    for k in build_keys:
        if not isinstance(k, ColumnRef) or k.index >= len(meta.columns):
            return False
        names.add(meta.columns[k.index].name)
    if meta.handle_col is not None and names == {meta.handle_col}:
        return True
    return any(im.unique and set(im.col_names) == names for im in meta.indices)


def _unify_join_key(pk: Expr, bk: Expr):
    """Bring both key sides to one eval class/scale (ref: hash join key
    unification in the planner — casts inserted so the kernel's normalized
    key words agree)."""
    pe, be = pk.ft.eval_type(), bk.ft.eval_type()
    if pe == be:
        if pe == "decimal" and _dec_scale(pk.ft) != _dec_scale(bk.ft):
            s = max(_dec_scale(pk.ft), _dec_scale(bk.ft))
            tgt = new_decimal(30, s)
            return func("cast", tgt, pk), func("cast", tgt, bk)
        if pe == "int" and pk.ft.is_unsigned() != bk.ft.is_unsigned():
            tgt = new_longlong(unsigned=False)
            return func("cast", tgt, pk), func("cast", tgt, bk)
        return pk, bk
    classes = {pe, be}
    if "real" in classes:
        tgt = new_double()
    elif "decimal" in classes and classes <= {"decimal", "int"}:
        s = max(_dec_scale(pk.ft), _dec_scale(bk.ft))
        tgt = new_decimal(30, s)
    elif classes <= {"int", "time"}:
        tgt = new_longlong()
    else:
        raise PlanError(f"cannot join keys of classes {pe} and {be}")

    def cast(e):
        return e if e.ft.eval_type() == tgt.eval_type() and _dec_scale(e.ft) == _dec_scale(tgt) else func("cast", tgt, e)

    return cast(pk), cast(bk)


def range_const_of(ft: FieldType):
    """Literal -> Datum of the column's type for range building. When the
    coercion is LOSSY (1.5 rounded to 2 for an int column) the original
    bound semantics would prune matching rows — decline, the conjunct stays
    as a plain filter (ref: ranger's points conversion refuses inexact
    casts)."""
    from ..expr.eval_ref import compare

    numeric = (DatumKind.Int64, DatumKind.Uint64, DatumKind.Float32, DatumKind.Float64, DatumKind.MysqlDecimal)

    def ev(lit_ast):
        d = _lower_literal(lit_ast).datum
        cd = _coerce_datum(d, ft)
        if d.kind in numeric and cd.kind in numeric and compare(d, cd) != 0:
            return None
        return cd

    return ev


def estimate_table_rows(meta: TableMeta, conjuncts: list, catalog: Catalog) -> float:
    """Filtered-cardinality estimate for one table: ANALYZE histograms when
    available (ref: pkg/statistics Selectivity), else the raw row count.
    Per-column interval selectivities multiply (independence assumption,
    as the reference's default without column groups)."""
    from .ranger import intervals_for_column
    from .stats import est_selectivity

    tstats = catalog.stats.get(meta.table_id)
    base = float(tstats.row_count if tstats is not None else meta.row_count)
    if tstats is None or not conjuncts:
        return base
    sel = 1.0
    for cm in meta.columns:
        cs = tstats.columns.get(cm.name)
        if cs is None:
            continue
        ivs = intervals_for_column(conjuncts, cm.name, range_const_of(cm.ft))
        if ivs is None:
            continue
        if not ivs:
            return 0.0
        sel *= est_selectivity(cs, ivs)
    return base * sel


class _HintSet:
    """Parsed /*+ ... */ hints the planner consumes (ref: pkg/util/hint
    TableHintInfo): USE_INDEX / FORCE_INDEX / IGNORE_INDEX,
    HASH_JOIN_PROBE / HASH_JOIN_BUILD. Unknown hints are ignored, like the
    reference's warning-only handling."""

    def __init__(self, raw):
        self.use_index: dict = {}
        self.ignore_index: dict = {}
        self._probe: list = []
        self._build: list = []
        self.use_index_merge = False
        self.no_index_merge = False
        for name, args in raw or []:
            if name in ("use_index", "force_index") and args:
                self.use_index.setdefault(args[0].lower(), set()).update(a.lower() for a in args[1:])
            elif name == "ignore_index" and args:
                self.ignore_index.setdefault(args[0].lower(), set()).update(a.lower() for a in args[1:])
            elif name in ("hash_join_probe", "hash_join") and args:
                self._probe.append(args[0].lower())
            elif name == "hash_join_build" and args:
                self._build.append(args[0].lower())
            elif name == "use_index_merge":
                self.use_index_merge = True
            elif name == "no_index_merge":
                self.no_index_merge = True

    def index_allowed(self, alias: str, idx_name: str) -> bool:
        if idx_name.lower() in self.ignore_index.get(alias, ()):  # noqa: SIM103
            return False
        use = self.use_index.get(alias)
        if use is not None and use and idx_name.lower() not in use:
            return False
        return True

    def index_forced(self, alias: str, idx_name: str) -> bool:
        return idx_name.lower() in self.use_index.get(alias, set())

    def probe_alias(self, aliases):
        for a in self._probe:
            if a in aliases:
                return a
        return None

    def build_alias(self, aliases):
        for a in self._build:
            if a in aliases:
                return a
        return None


def _split_disjuncts(e):
    out = []

    def walk(x):
        if isinstance(x, A.BinaryOp) and x.op == "or":
            walk(x.left)
            walk(x.right)
        else:
            out.append(x)

    walk(e)
    return out


def plan_select(stmt: A.SelectStmt, catalog: Catalog, mat: dict | None = None, enable_index_merge: bool = False) -> PlannedQuery:
    """Span-instrumented entry (ref: the optimizer trace hooks in
    pkg/planner/optimize.go); _plan_select does the work."""
    from ..util import tracing

    with tracing.span("planner.plan") as sp:
        plan = _plan_select(stmt, catalog, mat, enable_index_merge)
        if sp is not None:
            sp.set("access_path", plan.access_path)
            sp.set("probe_table", plan.probe_table.name)
        return plan


def _plan_select(stmt: A.SelectStmt, catalog: Catalog, mat: dict | None = None, enable_index_merge: bool = False) -> PlannedQuery:
    if (isinstance(stmt.from_clause, A.TableName)
            and stmt.from_clause.name.lower() == "dual"
            and not getattr(stmt.from_clause, "db", "")):
        # FROM DUAL is the no-table SELECT (ref: parser.y TableRefsClause
        # DUAL production; MySQL compat)
        stmt.from_clause = None
    if stmt.from_clause is None:
        raise PlanError("SELECT without FROM is evaluated by the session")
    if stmt.ctes:
        raise PlanError("CTEs are materialized by the session before planning")
    flat = _flatten_from(stmt.from_clause, catalog, mat)
    hints = _HintSet(getattr(stmt, "hints", []))

    # ---- join order: probe = largest table (row-count stat); LEFT JOIN
    # pins the textual order (outer semantics are order-sensitive)
    textual_order = [(meta, alias) for meta, alias, _, _ in flat]  # for SELECT *
    has_left = any(kind == "left" for _, _, kind, _ in flat)
    if not has_left and len(flat) > 1:
        # probe = table with the LARGEST estimated post-filter cardinality
        # (build sides broadcast; ref: physical optimizer's row-count-driven
        # build/probe selection, exhaust_physical_plans.go)
        tmp_refs, off0 = [], 0
        for m_, a_, _, _ in flat:
            tmp_refs.append(_TableRef(m_, a_, off0))
            off0 += len(m_.columns)
        tmp_scope = _Scope(tmp_refs)
        per_alias: dict = {a_: [] for _, a_, _, _ in flat}
        for c in _split_conjuncts(stmt.where):
            if isinstance(c, A.SemiJoinCond):
                continue
            try:
                tabs = tmp_scope.tables_of(c)
            except PlanError:
                continue
            if len(tabs) == 1:
                per_alias[next(iter(tabs))].append(c)
        est = [
            estimate_table_rows(m_, per_alias[a_], catalog)
            for m_, a_, _, _ in flat
        ]
        probe_i = max(range(len(flat)), key=lambda i: est[i])
        # /*+ HASH_JOIN_PROBE(t) / HASH_JOIN_BUILD(t) */ override the
        # cardinality choice (ref: pkg/util/hint HintHJProbe/HintHJBuild
        # consumed in exhaust_physical_plans)
        aliases_flat = [a_ for _, a_, _, _ in flat]
        hp = hints.probe_alias(aliases_flat)
        if hp is not None:
            probe_i = aliases_flat.index(hp)
        else:
            hb = hints.build_alias(aliases_flat)
            if hb is not None and len(flat) > 1:
                others = [i for i in range(len(flat)) if aliases_flat[i] != hb]
                probe_i = max(others, key=lambda i: est[i])
        flat = [flat[probe_i]] + flat[:probe_i] + flat[probe_i + 1 :]

    # ---- scope over the combined schema in placement order
    trefs = []
    off = 0
    for meta, alias, _, _ in flat:
        trefs.append(_TableRef(meta, alias, off))
        off += len(meta.columns)
    scope = _Scope(trefs)
    aliases = {f.alias.lower(): f.expr for f in stmt.fields if isinstance(f, A.SelectField) and f.alias}
    low = _Lowerer(scope, aliases)

    # ---- conjunct classification (PPDSolver analog)
    where_conj = _split_conjuncts(stmt.where)
    # decorrelated-subquery markers become semi/anti join steps after the
    # regular joins (ref: rule_decorrelate.go producing semi LogicalJoins)
    semi_conds = [c for c in where_conj if isinstance(c, A.SemiJoinCond)]
    where_conj = [c for c in where_conj if not isinstance(c, A.SemiJoinCond)]
    on_conj_per_join: dict[int, list] = {}
    for i, (_, _, kind, on) in enumerate(flat):
        if on is None:
            continue
        if kind == "left":
            on_conj_per_join[i] = _split_conjuncts(on)
        else:
            where_conj.extend(_split_conjuncts(on))  # inner: ON == WHERE

    # WHERE conjuncts on a LEFT JOIN's null-supplied side must run AFTER
    # null extension (post-join residual), never inside the build pipeline
    left_build_aliases = {trefs[i].alias for i in range(1, len(trefs)) if flat[i][2] == "left"}
    local: dict[str, list] = {tr.alias: [] for tr in trefs}
    equi: list = []  # (tables frozenset, lhs_ast, rhs_ast)
    residual: list = []
    for c in where_conj:
        tabs = scope.tables_of(c)
        if len(tabs) <= 1:
            alias1 = next(iter(tabs)) if tabs else None
            if alias1 is not None and alias1 not in left_build_aliases:
                local[alias1].append(c)
            else:
                residual.append(c)  # const condition / left-side filter
            continue
        sides = _equi_sides(c)
        if sides is not None and len(tabs) == 2:
            lt, rt = scope.tables_of(sides[0]), scope.tables_of(sides[1])
            if len(lt) == 1 and len(rt) == 1 and lt != rt:
                equi.append((tabs, sides[0], sides[1]))
                continue
        residual.append(c)

    # ---- access path (ranger): covering index scan / PK handle pruning
    from .ranger import handle_ranges_from_intervals, index_ranges_from_intervals, intervals_for_column

    probe_meta, probe_alias = trefs[0].meta, trefs[0].alias
    scan_ranges = None
    access_path = "table"
    range_src = ("full",)
    probe_scan = TableScan(probe_meta.table_id, probe_meta.scan_columns())

    if len(trefs) == 1 and probe_meta.indices:
        # covering index: every referenced column lives in the index (or is
        # the handle) AND its first column is range-constrained
        # (ref: physical access-path selection, find_best_task.go)
        from .catalog import ColumnMeta

        referenced = _referenced_columns(stmt, probe_meta)
        for idx in probe_meta.indices:
            if idx.state != "public":
                continue  # building indexes are invisible to readers (F1)
            if not hints.index_allowed(probe_alias, idx.name):
                continue
            covered = set(idx.col_names) | ({probe_meta.handle_col} if probe_meta.handle_col else set())
            if not referenced <= covered:
                continue
            first = probe_meta.col(idx.col_names[0])
            ivs = intervals_for_column(local[probe_alias], first.name, range_const_of(first.ft))
            if ivs is None:
                continue
            # entry layout = [index cols..., handle]; the resolution schema
            # must align slot for slot with the IndexScan output
            vcols = [probe_meta.col(cn) for cn in idx.col_names]
            vmetas = [ColumnMeta(c.name, c.col_id, c.ft) for c in vcols]
            handle_ft = new_longlong(notnull=True)
            if probe_meta.handle_col and probe_meta.handle_col not in idx.col_names:
                vmetas.append(ColumnMeta(probe_meta.handle_col, -1, handle_ft))
            else:
                vmetas.append(ColumnMeta("_tidb_rowid", -1, handle_ft))
            virtual = TableMeta(probe_meta.name, probe_meta.table_id, vmetas, [], probe_meta.handle_col)
            icols = tuple(ColumnInfo(c.col_id, c.ft) for c in vmetas)
            probe_scan = IndexScan(probe_meta.table_id, idx.index_id, icols)
            scan_ranges = index_ranges_from_intervals(probe_meta.table_id, idx.index_id, ivs)
            access_path = f"index({idx.name})"
            range_src = ("index", idx.index_id, first.name)
            # rebind resolution to the index entry schema
            trefs = [_TableRef(virtual, probe_alias, 0)]
            scope = _Scope(trefs)
            low = _Lowerer(scope, aliases)
            break
    if access_path == "table" and probe_meta.handle_col is not None and probe_meta.partition is None:
        hcol = probe_meta.col(probe_meta.handle_col)
        ivs = intervals_for_column(local[probe_alias], hcol.name, range_const_of(hcol.ft))
        if ivs is not None:
            scan_ranges = handle_ranges_from_intervals(probe_meta.table_id, ivs)
            access_path = "table-range"
            range_src = ("handle", hcol.name)

    if probe_meta.partition is not None and access_path in ("table", "table-range"):
        # partition pruning (ref: rule_partition_processor.go): intervals
        # on the partition column choose the physical partitions to scan;
        # each pruned partition contributes its own key-space ranges (and
        # its handle ranges when the PK is the partition column)
        from ..distsql.dispatch import full_table_ranges

        pcm = probe_meta.col(probe_meta.partition.col)
        pivs = intervals_for_column(local[probe_alias], pcm.name, range_const_of(pcm.ft))
        pruned = probe_meta.partition.prune(pivs)
        if pivs is not None and probe_meta.handle_col == probe_meta.partition.col:
            scan_ranges = [
                r for p in pruned for r in handle_ranges_from_intervals(p.pid, pivs)
            ]
        else:
            scan_ranges = [r for p in pruned for r in full_table_ranges(p.pid)]
        access_path += f" partitions({','.join(p.name for p in pruned)})"
        range_src = ("partition",)

    lookup = None
    if access_path == "table" and len(trefs) == 1 and probe_meta.indices:
        # non-covering index with a range-constrained first column AND a
        # selective predicate: the index-lookup double-read reads o(table)
        # rows (ref: IndexLookUpExecutor pkg/executor/distsql.go; the
        # cost-based choice mirrors find_best_task's row-count comparison)
        from .stats import est_selectivity

        tstats = catalog.stats.get(probe_meta.table_id)
        best = None
        for idx in probe_meta.indices:
            if idx.state != "public":
                continue  # building indexes are invisible to readers (F1)
            if not hints.index_allowed(probe_alias, idx.name):
                continue
            first = probe_meta.col(idx.col_names[0])
            ivs = intervals_for_column(local[probe_alias], first.name, range_const_of(first.ft))
            if ivs is None:
                continue
            if hints.index_forced(probe_alias, idx.name):
                best = (-1.0, idx, ivs)  # forced: beats any selectivity
                break
            cs = tstats.columns.get(first.name) if tstats is not None else None
            if cs is not None:
                sel = est_selectivity(cs, ivs) if ivs else 0.0
            else:
                # no stats: assume point intervals are selective, ranges not
                from ..expr.eval_ref import compare as _cmp

                point = all(
                    iv.low is not None and iv.high is not None and _cmp(iv.low, iv.high) == 0
                    for iv in ivs
                )
                sel = 0.1 if point else 1.0
            if best is None or sel < best[0]:
                best = (sel, idx, ivs)
        # double-read pays a per-row point cost: require clear selectivity
        if best is not None and best[0] < 0.3:
            _, idx, ivs = best
            lookup = (idx.index_id, index_ranges_from_intervals(probe_meta.table_id, idx.index_id, ivs))
            access_path = f"index_lookup({idx.name})"
            range_src = ("lookup", idx.index_id, probe_meta.col(idx.col_names[0]).name)

    lookup_merge = None
    if (
        access_path == "table" and len(trefs) == 1 and probe_meta.indices
        and (enable_index_merge or hints.use_index_merge) and not hints.no_index_merge
    ):
        # index merge (UNION): one top-level OR-disjunction whose every
        # disjunct range-constrains some index's first column — handles
        # union before the table read; the retained Selection re-applies
        # the full predicate, so the union is a safe over-approximation
        # (ref: planner index-merge path generation + index_merge_reader.go)
        for c in local[probe_alias]:
            disj = _split_disjuncts(c)
            if len(disj) < 2:
                continue
            parts = []
            for d in disj:
                found = None
                for idx in probe_meta.indices:
                    if idx.state != "public":
                        continue
                    if not hints.index_allowed(probe_alias, idx.name):
                        continue
                    first = probe_meta.col(idx.col_names[0])
                    ivs = intervals_for_column([d], first.name, range_const_of(first.ft))
                    if ivs is not None:
                        found = (idx, ivs)
                        break
                if found is None:
                    parts = None
                    break
                parts.append(found)
            if parts:
                lookup_merge = [
                    (i.index_id, index_ranges_from_intervals(probe_meta.table_id, i.index_id, iv))
                    for i, iv in parts
                ]
                names_ = ",".join(i.name for i, _ in parts)
                access_path = f"index_merge(union:{names_})"
                range_src = ("index_merge",)
                break

    # ---- probe pipeline
    executors: list = [probe_scan]
    if local[probe_alias]:
        executors.append(Selection(tuple(low.lower_base(c) for c in local[probe_alias])))

    # ---- joins (left-deep, broadcast build sides)
    placed = {probe_alias}
    build_tables = []
    for i in range(1, len(trefs)):
        tr = trefs[i]
        meta, alias, kind = flat[i][0], tr.alias, flat[i][2]
        local_scope = _Scope([_TableRef(meta, alias, 0)])
        local_low = _Lowerer(local_scope)
        build_execs: list = [TableScan(meta.table_id, meta.scan_columns())]

        join_preds = []
        pool = equi
        if kind == "left":
            # ON conjuncts: build-local filters go inside the build
            # pipeline; equi preds become keys; anything else is unsupported
            pool = []
            for c in on_conj_per_join.get(i, []):
                tabs = scope.tables_of(c)
                if tabs == {alias}:
                    local[alias].append(c)
                    continue
                sides = _equi_sides(c)
                if sides is not None and len(tabs) == 2:
                    pool.append((tabs, sides[0], sides[1]))
                    continue
                raise PlanError("LEFT JOIN ON supports equi conditions and build-side filters only")
        if local[alias]:
            build_execs.append(Selection(tuple(local_low.lower_base(c) for c in local[alias])))

        probe_keys, build_keys = [], []
        remaining = []
        for tabs, l_ast, r_ast in pool:
            if alias in tabs and tabs - {alias} <= placed:
                l_tabs = scope.tables_of(l_ast)
                b_ast, p_ast = (l_ast, r_ast) if l_tabs == {alias} else (r_ast, l_ast)
                pk = low.lower_base(p_ast)
                bk = local_low.lower_base(b_ast)
                pk, bk = _unify_join_key(pk, bk)
                probe_keys.append(pk)
                build_keys.append(bk)
            else:
                remaining.append((tabs, l_ast, r_ast))
        if kind != "left":
            equi = remaining
        if not probe_keys:
            # cartesian product: constant keys (every row matches)
            probe_keys = [lit(1, new_longlong(notnull=True))]
            build_keys = [lit(1, new_longlong(notnull=True))]
        executors.append(
            Join(
                build=tuple(build_execs),
                probe_keys=tuple(probe_keys),
                build_keys=tuple(build_keys),
                join_type="left_outer" if kind == "left" else "inner",
                build_unique=_build_keys_unique(meta, build_keys),
            )
        )
        placed.add(alias)
        build_tables.append(meta)

    # ---- decorrelated semi/anti joins (schema unchanged: probe rows only)
    for sc in semi_conds:
        smeta = _resolve_table(sc.table, catalog, mat)
        s_scope = _Scope([_TableRef(smeta, smeta.name, 0)])
        s_low = _Lowerer(s_scope)
        build_execs = (TableScan(smeta.table_id, smeta.scan_columns()),)
        probe_keys, build_keys = [], []
        for pe, bc in zip(sc.probe_exprs, sc.build_cols):
            pk = low.lower_base(pe)
            if sc.anti and sc.require_notnull_probe and not (pk.ft.flag & Flag.NotNull):
                raise PlanError(
                    "NOT IN over a correlated subquery requires a NOT NULL left operand "
                    "(NULL-valued operands would change the three-valued result)"
                )
            bk = s_low.lower_base(A.ColumnName(bc))
            pk, bk = _unify_join_key(pk, bk)
            probe_keys.append(pk)
            build_keys.append(bk)
        executors.append(
            Join(
                build=build_execs,
                probe_keys=tuple(probe_keys),
                build_keys=tuple(build_keys),
                join_type="anti" if sc.anti else "semi",
            )
        )
        build_tables.append(smeta)
    if equi:
        # equi preds that never matched a join step (e.g. cycles) filter post-join
        for tabs, l_ast, r_ast in equi:
            residual.append(A.BinaryOp("eq", l_ast, r_ast))
    if residual:
        executors.append(Selection(tuple(low.lower_base(c) for c in residual)))

    # ---- select list: expand * / t.* first — in TEXTUAL FROM order (the
    # probe reorder must not change the user-visible column order)
    fields: list = []
    for f in stmt.fields:
        e = f.expr if isinstance(f, A.SelectField) else f
        if isinstance(e, A.Star):
            for meta, alias in textual_order:
                if e.table and alias != e.table.lower() and meta.name != e.table.lower():
                    continue
                for cm in meta.columns:
                    fields.append(A.SelectField(A.ColumnName(cm.name, alias), cm.name))
        else:
            fields.append(f)

    def positional(e):
        """ORDER BY 1 / GROUP BY 2 = select-list position (MySQL)."""
        if isinstance(e, A.Literal) and e.kind == "int":
            i = int(e.value)
            if not (1 <= i <= len(fields)):
                raise PlanError(f"ORDER/GROUP BY position {i} out of range")
            return fields[i - 1].expr
        return e

    # ---- window functions (ref: logical_plan_builder buildWindowFunctions;
    # exhaust_physical_plans window enforcement; plan_to_pb.go:663)
    win_nodes: list = []

    def collect_wins(x):
        if isinstance(x, A.WindowFunc):
            win_nodes.append(x)
            return
        for c in _ast_children(x):
            collect_wins(c)

    for f in fields:
        collect_wins(f.expr)
    for b in stmt.order_by:
        collect_wins(b.expr)
    if stmt.having is not None and _has_window(stmt.having):
        raise PlanError("window functions are not allowed in HAVING")
    if win_nodes:
        if stmt.group_by or any(_has_agg(f.expr) for f in fields) or (
            stmt.having is not None and _has_agg(stmt.having)
        ):
            raise PlanError("mixing window functions with GROUP BY/aggregates not supported yet")
        _plan_windows(win_nodes, low, executors)

    # ---- aggregation
    def group_key(e):
        """A GROUP BY item as the AST it groups by: a position is its
        select field, and a bare name that is no column of the FROM clause
        but a select alias is the alias's expression (MySQL searches the
        FROM clause first for GROUP BY, then the select list), so the
        select field of that expression reads the group key."""
        e = positional(e)
        if isinstance(e, A.ColumnName) and not e.table and e.name.lower() in aliases:
            try:
                scope.resolve(e)
            except PlanError:
                return aliases[e.name.lower()]
        return e

    group_asts = [group_key(b.expr) for b in stmt.group_by]
    need_agg = bool(group_asts) or any(_has_agg(f.expr) for f in fields) or (
        stmt.having is not None and _has_agg(stmt.having)
    )
    if stmt.distinct and not need_agg:
        # SELECT DISTINCT a, b == GROUP BY a, b (AggregationEliminator dual)
        group_asts = [f.expr for f in fields]
        need_agg = True

    names = [_field_label(f) for f in fields]

    if need_agg:
        low.group_asts = group_asts
        low.in_agg_ctx = True
        out_exprs = [low.lower_in_agg(f.expr) for f in fields]
        having_e = low.lower_in_agg(stmt.having) if stmt.having is not None else None
        order_items = [(low.lower_in_agg(positional(b.expr)), b.desc) for b in stmt.order_by]
        n_aggs = len(low.agg_descs)
        out_exprs = [_resolve_deferred(e, n_aggs) for e in out_exprs]
        having_e = _resolve_deferred(having_e, n_aggs) if having_e is not None else None
        order_items = [(_resolve_deferred(e, n_aggs), d) for e, d in order_items]
        groups = tuple(low.lower_base(g) for g in group_asts)
        # StreamAgg: a covering IndexScan yields rows in index-key order,
        # so a GROUP BY on a prefix of the index columns (bare ColumnRefs,
        # in order) is already sorted — the boundary-scan kernel applies
        # (ref: agg_stream_executor.go; physical prop enforcement in
        # find_best_task choosing StreamAgg over sorted sources)
        stream = False
        from ..expr.ir import ColumnRef as _CRef

        if (
            isinstance(probe_scan, IndexScan)
            and groups
            and not any(d.distinct for d in low.agg_descs)
            and all(isinstance(g, _CRef) for g in groups)
            and [g.index for g in groups] == list(range(len(groups)))
        ):
            stream = True
        executors.append(Aggregation(group_by=groups, aggs=tuple(low.agg_descs), stream=stream))
        if having_e is not None:
            executors.append(Selection((having_e,)))
    else:
        out_exprs = [low.lower_base(f.expr) for f in fields]
        order_items = [(low.lower_base(positional(b.expr)), b.desc) for b in stmt.order_by]

    # ---- order / limit
    def limit_val(e):
        if e is None:
            return None
        if isinstance(e, A.Literal) and e.kind in ("int", "bool"):
            return int(e.value)
        if isinstance(e, int):
            return e
        raise PlanError("LIMIT expects integer literals")

    limit_n = offset_n = None
    if stmt.limit is not None:
        limit_n = limit_val(stmt.limit.count)
        offset_n = limit_val(stmt.limit.offset) or 0
    if order_items:
        if limit_n is not None:
            executors.append(TopN(order_by=tuple(order_items), limit=limit_n + offset_n))
        else:
            # ORDER BY without LIMIT: a REAL full sort — every row comes
            # back in order (the r2 2^20 TopN truncation trap is gone;
            # ref: sortexec/sort.go)
            executors.append(Sort(order_by=tuple(order_items)))
    elif limit_n is not None:
        executors.append(Limit(limit_n + offset_n))

    # ---- projection / offsets
    from ..expr.ir import ColumnRef

    if all(isinstance(e, ColumnRef) for e in out_exprs):
        offsets = tuple(e.index for e in out_exprs)
    else:
        executors.append(Projection(tuple(out_exprs)))
        offsets = tuple(range(len(out_exprs)))

    dag = DAGRequest(tuple(executors), output_offsets=offsets)
    return PlannedQuery(
        dag, probe_meta, build_tables, names,
        offset=offset_n or 0, ranges=scan_ranges, access_path=access_path,
        range_src=range_src,
        lookup=lookup,
        lookup_merge=lookup_merge,
        small_groups=_ndv_group_hint(dag, trefs, catalog),
    )


def _ndv_group_hint(dag: DAGRequest, trefs: list, catalog: Catalog, cap: int = 512) -> int | None:
    """NDV-product few-groups hint (ref: the reference's stats-driven agg
    mode choice; cmsketch.go/histogram NDV feeding cardinality): when every
    GROUP BY key is a bare column with ANALYZE stats, the product of the
    column NDVs bounds the group count."""
    from ..expr.ir import ColumnRef

    agg = dag.executors[-1] if dag.executors else None
    if not isinstance(agg, Aggregation) or not agg.group_by:
        return None
    product = 1
    for g in agg.group_by:
        if not isinstance(g, ColumnRef):
            return None
        cm = None
        for tr in trefs:
            if tr.offset <= g.index < tr.offset + len(tr.meta.columns):
                cm = tr.meta.columns[g.index - tr.offset]
                tstats = catalog.stats.get(tr.meta.table_id)
                break
        else:
            return None
        cs = tstats.columns.get(cm.name) if tstats is not None else None
        if cs is None or cs.ndv <= 0:
            return None
        product *= cs.ndv + (1 if cs.null_count else 0)
        if product > cap:
            return None
    c = 16
    while c < product:
        c *= 2
    return c
