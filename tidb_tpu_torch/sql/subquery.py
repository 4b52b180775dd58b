"""Subquery materialization + decorrelation — the session-side rewrite pass
that removes every subquery construct from a SELECT before planning.

The reference splits this between the expression rewriter (uncorrelated
subqueries evaluate during plan building, pkg/planner/core/expression_rewriter.go)
and the decorrelation rule (correlated IN/EXISTS become semi/anti
LogicalJoins, correlated scalar aggregates become outer joins over a
re-grouped inner — pkg/planner/core/rule_decorrelate.go). Here both shapes
land on the same mechanism: the inner query is *materialized* into an
in-memory table (`MatRegistry`) that the planner sees through its `mat`
namespace, and the outer AST is rewritten to reference it:

  uncorrelated scalar          -> datum literal
  uncorrelated EXISTS          -> 0/1 literal (inner runs with LIMIT 1)
  uncorrelated IN, small       -> InList of datum literals (exact 3VL)
  uncorrelated IN, large       -> SemiJoinCond against the materialized rows
  cmp ANY/ALL (uncorrelated)   -> min/max comparison with empty/NULL guards
  correlated [NOT] IN / EXISTS -> SemiJoinCond (semi/anti join in the DAG)
  correlated scalar (agg)      -> LEFT JOIN of the inner re-grouped by its
                                  correlation keys + column reference
  anything decorrelation can't -> Apply fallback: a host-evaluated function
                                  re-executes the subquery per outer row
                                  with the outer references bound — the
                                  analog of the LogicalApply operator the
                                  reference keeps when pull-up fails
                                  (rule_decorrelate.go); exact 3VL for
                                  (NOT) IN incl. row-value probes (the
                                  null-aware anti-join semantics,
                                  ref: pkg/planner/core/exhaust_physical_plans.go NAAJ)

CTEs (including recursive ones) materialize here too and shadow catalog
tables by name (ref: pkg/planner/core/logical_plan_builder.go buildWith).

Copy of `tidb_tpu/sql/subquery.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import copy
import itertools

from ..chunk import Chunk
from ..exec.executor import datum_group_key
from ..expr.eval_ref import compare
from ..parser import ast as A
from ..types import Datum
from .catalog import Catalog, ColumnMeta, TableMeta

# IN-lists up to this size inline as literals (one fused compare chain on
# device); larger sets become semi joins against the materialized rows
MAX_IN_LITERALS = 64


def _probe_items(expr) -> list:
    """IN-probe component expressions: (a, b) row values flatten."""
    return list(expr.items) if isinstance(expr, A.RowExpr) else [expr]


class SubqueryError(ValueError):
    pass


def _dlit(d: Datum) -> A.Literal:
    return A.Literal(d, "datum")


TRUE_LIT = lambda: A.Literal(1, "int")  # noqa: E731
FALSE_LIT = lambda: A.Literal(0, "int")  # noqa: E731
NULL_LIT = lambda: A.Literal(None, "null")  # noqa: E731


from .planner import _split_conjuncts  # shared conjunct splitting


def _and_all(conjs):
    out = None
    for c in conjs:
        out = c if out is None else A.BinaryOp("and", out, c)
    return out


class MatRegistry:
    """Materialized result sets, keyed by generated storage names ("#m<n>",
    never valid SQL identifiers). Negative table ids never collide with
    catalog tables and are assigned in registration order, so two statements
    with the same shape share the compiled-program cache (the DAG
    fingerprint includes the id). User-visible CTE names bind per rewriter
    scope (SubqueryRewriter.bindings), NOT here — a CTE inside a subquery
    must not shadow tables in the outer query."""

    def __init__(self):
        self.metas: dict[str, TableMeta] = {}
        self.chunks: dict[str, Chunk] = {}
        self._ids = itertools.count(1)

    def register(self, names, fts, rows) -> TableMeta:
        storage = f"#m{next(self._ids)}"
        used: set = set()
        cols = []
        for i, (n, ft) in enumerate(zip(names, fts)):
            base = (n or f"c{i}").lower()
            nm, k = base, 2
            while nm in used:
                nm, k = f"{base}_{k}", k + 1
            used.add(nm)
            cols.append(ColumnMeta(nm, i + 1, ft))
        meta = TableMeta(storage, -next(self._ids), cols, [], None)
        meta.row_count = len(rows)
        self.metas[storage] = meta
        self.chunks[storage] = Chunk.from_rows(list(fts), rows)
        return meta

    def update_rows(self, meta: TableMeta, rows) -> None:
        """Replace a registered table's rows (recursive-CTE iteration)."""
        meta.row_count = len(rows)
        self.chunks[meta.name] = Chunk.from_rows([c.ft for c in meta.columns], rows)


class SubqueryRewriter:
    """One statement's rewrite pass. `exec_query` runs a nested
    SelectStmt/SetOprStmt to (names, fts, rows) — the session wires it to
    its own executor with this rewriter as the parent so nested queries see
    enclosing CTE bindings (scoped, innermost wins) while materialized
    storage is shared."""

    def __init__(self, catalog: Catalog, registry: MatRegistry | None = None, max_recursion: int = 1000,
                 parent: "SubqueryRewriter | None" = None):
        self.catalog = catalog
        self.registry = registry or MatRegistry()
        self.max_recursion = max_recursion
        self.parent = parent
        self.bindings: dict[str, TableMeta] = {}  # CTE name -> meta (this scope)
        self.exec_query = None  # set by the session after construction

    def mat_dict(self) -> dict:
        """The planner's `mat` namespace for this scope: every storage
        entry (referenced by generated '#m…' names) plus the CTE bindings
        visible here (enclosing scopes first, this scope overriding)."""
        out = dict(self.parent.mat_dict()) if self.parent is not None else {}
        out.update(self.registry.metas)
        out.update(self.bindings)
        return out

    # ------------------------------------------------------------- schema
    def _table_cols(self, name: str) -> list | None:
        m = self.mat_dict().get(name.lower())
        if m is None:
            try:
                m = self.catalog.table(name)
            except Exception:
                return None
        return [c.name for c in m.columns]

    def _from_schema(self, node) -> list:
        """FROM tree -> [(alias, [colnames])]; None for unknown tables (the
        planner reports those with a proper error later)."""
        if node is None:
            return []
        if isinstance(node, A.TableName):
            cols = self._table_cols(node.name) or []
            return [((node.alias or node.name.rsplit(".", 1)[-1]).lower(), cols)]
        if isinstance(node, A.SubqueryTable):
            sel = node.subquery
            labels = []
            inner = sel.selects[0] if isinstance(sel, A.SetOprStmt) else sel
            fields = inner.fields
            inner_schema = None
            for f in fields:
                e = f.expr if isinstance(f, A.SelectField) else f
                if isinstance(e, A.Star):
                    # expand the star against the subquery's own FROM so the
                    # derived table's schema is complete for correlation checks
                    if inner_schema is None:
                        inner_schema = self._from_schema(inner.from_clause)
                    for alias, cols in inner_schema:
                        if e.table and alias != e.table.lower():
                            continue
                        labels.extend(cols)
                    continue
                if isinstance(f, A.SelectField) and f.alias:
                    labels.append(f.alias.lower())
                elif isinstance(e, A.ColumnName):
                    labels.append(e.name.lower())
            return [(node.alias.lower(), labels)]
        if isinstance(node, A.Join):
            return self._from_schema(node.left) + self._from_schema(node.right)
        return []

    @staticmethod
    def _resolves(c: A.ColumnName, schema: list) -> bool:
        if c.table:
            t = c.table.lower()
            return any(alias == t for alias, _ in schema)
        return any(c.name.lower() in cols for _, cols in schema)

    def _refs_outer(self, node, inner_schema: list, outer_scopes: list) -> bool:
        """Does any column under `node` resolve only in an enclosing scope?
        Nested subqueries extend the scope stack with their own FROM."""
        found = [False]

        def walk(n, schemas):
            if found[0] or not hasattr(n, "__dataclass_fields__"):
                return
            if isinstance(n, A.ColumnName):
                if not self._resolves(n, schemas[-1]) and any(self._resolves(n, s) for s in schemas[:-1]):
                    found[0] = True
                return
            sub = getattr(n, "subquery", None)
            if sub is not None and not isinstance(n, A.SubqueryTable):
                inner_sel = sub.selects[0] if isinstance(sub, A.SetOprStmt) else sub
                walk_stmt(inner_sel, schemas + [self._from_schema(inner_sel.from_clause)])
                # DON'T return: sibling fields (InSubquery.expr,
                # CompareSubquery.expr) can carry outer references of their
                # own (early return misclassified the enclosing
                # subquery as uncorrelated)
            for f_ in n.__dataclass_fields__:
                if f_ == "subquery":
                    continue  # handled above with the extended scope
                v = getattr(n, f_)
                for it in v if isinstance(v, (list, tuple)) else [v]:
                    if isinstance(it, tuple):
                        for x in it:
                            walk(x, schemas)
                    elif hasattr(it, "__dataclass_fields__"):
                        walk(it, schemas)

        def walk_stmt(sel, schemas):
            for f in sel.fields:
                walk(f, schemas)
            for part in (sel.where, sel.having):
                if part is not None:
                    walk(part, schemas)
            for b in list(sel.group_by) + list(sel.order_by):
                walk(b.expr, schemas)

        schemas = outer_scopes + [inner_schema]
        if isinstance(node, A.SelectStmt):
            walk_stmt(node, schemas)
            # join ON conditions can carry correlation too
            def walk_from(fr):
                if isinstance(fr, A.Join):
                    walk_from(fr.left)
                    walk_from(fr.right)
                    if fr.on is not None:
                        walk(fr.on, schemas)
            walk_from(node.from_clause)
        else:
            walk(node, schemas)
        return found[0]

    # ------------------------------------------------------- entry points
    def process_ctes(self, ctes: list) -> None:
        for cte in ctes:
            if cte.recursive and isinstance(cte.subquery, A.SetOprStmt):
                self._recursive_cte(cte)
                continue
            names, fts, rows = self.exec_query(cte.subquery)
            if cte.columns:
                names = list(cte.columns) + list(names[len(cte.columns):])
            self.bindings[cte.name.lower()] = self.registry.register(names, fts, rows)

    def _recursive_cte(self, cte: A.CTE) -> None:
        """Delta-based recursive CTE evaluation (ref: pkg/executor/cte.go —
        seed part, then the recursive part iterates over the previous
        iteration's rows until a fixpoint or the depth cap)."""
        sets = cte.subquery
        # a WITH clause on the CTE's own body (nested CTEs) materializes
        # first so the seed/recursive parts can read it; the binding lands
        # in this scope (slightly wider than MySQL's body-only scope, but
        # later same-name definitions simply rebind)
        if getattr(sets, "ctes", None):
            self.process_ctes(sets.ctes)
            sets.ctes = []

        def refs_cte(sel) -> bool:
            def in_from(fr):
                if isinstance(fr, A.TableName):
                    return fr.name.lower() == cte.name.lower()
                if isinstance(fr, A.Join):
                    return in_from(fr.left) or in_from(fr.right)
                if isinstance(fr, A.SubqueryTable):
                    inner = fr.subquery
                    sels = inner.selects if isinstance(inner, A.SetOprStmt) else [inner]
                    return any(refs_cte(s) for s in sels)
                return False

            return in_from(sel.from_clause)

        seeds = [s for s in sets.selects if not refs_cte(s)]
        recs = [s for s in sets.selects if refs_cte(s)]
        if not seeds or not recs:
            raise SubqueryError(f"recursive CTE {cte.name!r} needs seed and recursive parts")
        distinct = not all(sets.all_flags)

        names = fts = None
        total: list = []
        seen: set = set()
        for s in seeds:
            n_, f_, r_ = self.exec_query(s)
            if names is None:
                names, fts = n_, f_
            total.extend(r_)
        if distinct:
            dedup = []
            for r in total:
                k = tuple(datum_group_key(d, ft) for d, ft in zip(r, fts))
                if k not in seen:
                    seen.add(k)
                    dedup.append(r)
            total = dedup
        if cte.columns:
            names = list(cte.columns) + list(names[len(cte.columns):])
        cmeta = self.registry.register(names, fts, total)
        self.bindings[cte.name.lower()] = cmeta
        delta = total
        for _ in range(self.max_recursion + 1):
            if not delta:
                break
            # the recursive part reads the previous iteration's delta
            self.registry.update_rows(cmeta, delta)
            new: list = []
            for s in recs:
                _, _, r_ = self.exec_query(copy.deepcopy(s))
                new.extend(r_)
            if distinct:
                fresh = []
                for r in new:
                    k = tuple(datum_group_key(d, ft) for d, ft in zip(r, fts))
                    if k not in seen:
                        seen.add(k)
                        fresh.append(r)
                new = fresh
            total = total + new
            delta = new
        else:
            raise SubqueryError(
                f"recursive CTE {cte.name!r} exceeded cte_max_recursion_depth={self.max_recursion}"
            )
        self.registry.update_rows(cmeta, total)

    def rewrite_select(self, stmt: A.SelectStmt) -> None:
        """In-place: after this returns, `stmt` contains no subquery nodes
        (SemiJoinCond markers and materialized table references instead)."""
        stmt.from_clause = self._rewrite_from(stmt.from_clause)
        schema = self._from_schema(stmt.from_clause)
        # WHERE conjuncts get the full treatment (semi/anti markers allowed)
        conjs = [self._rewrite_conjunct(c, schema, stmt) for c in _split_conjuncts(stmt.where)]
        conjs = [c for c in conjs if c is not None]
        stmt.where = _and_all(conjs)
        # everywhere else only value-producing rewrites are legal
        for f in stmt.fields:
            if isinstance(f, A.SelectField):
                f.expr = self._rewrite_expr(f.expr, schema, stmt)
        if stmt.having is not None:
            stmt.having = self._rewrite_expr(stmt.having, schema, stmt)
        for b in list(stmt.group_by) + list(stmt.order_by):
            b.expr = self._rewrite_expr(b.expr, schema, stmt)

    # ------------------------------------------------------------- pieces
    def _view_of(self, name: str):
        """ViewMeta for a FROM reference, unless a CTE binding in any
        enclosing scope shadows it (MySQL: CTE names win inside the query,
        ref: logical_plan_builder.go buildDataSource CTE-before-view)."""
        n = name.lower()
        p = self
        while p is not None:
            if n in p.bindings:
                return None
            p = p.parent
        view_of = getattr(self.catalog, "view_of", None)
        return view_of(n) if view_of is not None else None

    def _expand_view(self, node: A.TableName):
        """TableName over a view -> SubqueryTable over its stored SELECT
        (re-parsed each use: the view sees the CURRENT schema, ref:
        ViewInfo expansion in buildDataSource)."""
        vm = self._view_of(node.name)
        if vm is None:
            return None
        depth = 0
        p = self
        while p is not None:
            depth += 1
            p = p.parent
        if depth > 24:
            raise SubqueryError(f"view nesting too deep expanding {node.name!r}")
        from ..parser import parse_one

        sel = parse_one(vm.select_sql)
        # the stored SELECT resolves against the view's DEFINING database
        # (derived from the catalog key prefix), not the session's current
        # one (ref: ViewInfo security/definer db in buildDataSource)
        from .session import qualify_tables_ast

        vdb = vm.name.rsplit(".", 1)[0] if "." in vm.name else "test"
        qualify_tables_ast(sel, vdb)
        if vm.columns:
            if not isinstance(sel, A.SelectStmt):
                raise SubqueryError("view column list over a UNION body is not supported yet")
            fields = sel.fields
            if any(isinstance(getattr(f, "expr", f), A.Star) for f in fields):
                raise SubqueryError("view column list with SELECT * is not supported yet")
            if len(fields) != len(vm.columns):
                raise SubqueryError(
                    f"view {vm.name!r}: column list arity {len(vm.columns)} != select list {len(fields)}"
                )
            for f, cn in zip(fields, vm.columns):
                f.alias = cn
        return A.SubqueryTable(sel, node.alias or node.name)

    def _rewrite_from(self, node):
        if isinstance(node, A.TableName):
            expanded = self._expand_view(node)
            if expanded is not None:
                node = expanded  # falls through to the SubqueryTable branch
            else:
                return node
        if node is None:
            return node
        if isinstance(node, A.SubqueryTable):
            names, fts, rows = self.exec_query(node.subquery)
            meta = self.registry.register(names, fts, rows)
            return A.TableName(meta.name, alias=node.alias)
        if isinstance(node, A.Join):
            node.left = self._rewrite_from(node.left)
            node.right = self._rewrite_from(node.right)
            return node
        return node

    def _is_correlated(self, sub, schema) -> bool:
        sels = sub.selects if isinstance(sub, A.SetOprStmt) else [sub]
        return any(
            self._refs_outer(sel, self._from_schema(sel.from_clause), [schema])
            for sel in sels
        )

    def _rewrite_conjunct(self, c, schema, stmt):
        """Top-level WHERE conjunct: IN/EXISTS may become join markers.
        Returns None to drop the conjunct (proven always-true)."""
        neg = False
        node = c
        while isinstance(node, A.UnaryOp) and node.op == "not" and isinstance(
            node.operand, (A.Exists, A.InSubquery)
        ):
            neg = not neg
            node = node.operand
        if isinstance(node, A.Exists):
            negated = node.negated ^ neg
            if not self._is_correlated(node.subquery, schema):
                return self._uncorrelated_exists(node.subquery, negated)
            try:
                return self._correlated_semi(node.subquery, schema, None, negated)
            except SubqueryError:
                return self._apply_fallback("exists", node.subquery, schema, stmt, negated=negated)
        if isinstance(node, A.InSubquery):
            negated = node.negated ^ neg
            if not self._is_correlated(node.subquery, schema):
                return self._uncorrelated_in(node, schema, stmt, negated)
            if not isinstance(node.expr, A.RowExpr):
                try:
                    x = self._rewrite_expr(copy.deepcopy(node.expr), schema, stmt)
                    return self._correlated_semi(node.subquery, schema, x, negated)
                except SubqueryError:
                    pass
            return self._apply_fallback(
                "in", node.subquery, schema, stmt,
                probe_exprs=_probe_items(node.expr), negated=negated,
            )
        return self._rewrite_expr(c, schema, stmt)

    def _rewrite_expr(self, n, schema, stmt):
        """Generic walk replacing value-position subqueries."""
        if not hasattr(n, "__dataclass_fields__"):
            return n
        if isinstance(n, A.SubqueryExpr):
            return self._scalar(n.subquery, schema, stmt)
        if isinstance(n, A.Exists):
            if self._is_correlated(n.subquery, schema):
                return self._apply_fallback("exists", n.subquery, schema, stmt, negated=n.negated)
            return self._uncorrelated_exists(n.subquery, n.negated)
        if isinstance(n, A.InSubquery):
            if self._is_correlated(n.subquery, schema):
                return self._apply_fallback(
                    "in", n.subquery, schema, stmt,
                    probe_exprs=_probe_items(n.expr), negated=n.negated,
                )
            return self._uncorrelated_in(n, schema, stmt, n.negated, conjunct=False)
        if isinstance(n, A.CompareSubquery):
            return self._compare_subquery(n, schema, stmt)
        for f_ in n.__dataclass_fields__:
            v = getattr(n, f_)
            if isinstance(v, list):
                for i, it in enumerate(v):
                    if isinstance(it, tuple):
                        v[i] = tuple(
                            self._rewrite_expr(x, schema, stmt) if isinstance(x, A.ExprNode) else x
                            for x in it
                        )
                    elif isinstance(it, A.ExprNode):
                        v[i] = self._rewrite_expr(it, schema, stmt)
            elif isinstance(v, A.ExprNode):
                setattr(n, f_, self._rewrite_expr(v, schema, stmt))
        return n

    # -------------------------------------------------- uncorrelated forms
    def _exec_values(self, sub):
        """Run an uncorrelated subquery; returns (fts, rows)."""
        names, fts, rows = self.exec_query(sub)
        return fts, rows

    def _uncorrelated_exists(self, sub, negated):
        limited = copy.deepcopy(sub)
        tgt = limited.selects[0] if isinstance(limited, A.SetOprStmt) else limited
        if tgt.limit is None and not isinstance(limited, A.SetOprStmt):
            tgt.limit = A.Limit(A.Literal(1, "int"))
        _, rows = self._exec_values(limited)
        exists = bool(rows)
        return TRUE_LIT() if exists ^ negated else FALSE_LIT()

    def _uncorrelated_in(self, node, schema, stmt, negated, conjunct=True):
        sub = node.subquery
        if isinstance(node.expr, A.RowExpr):
            return self._uncorrelated_tuple_in(node, schema, stmt, negated)
        fields = (sub.selects[0] if isinstance(sub, A.SetOprStmt) else sub).fields
        if len(fields) != 1 or isinstance(fields[0].expr if isinstance(fields[0], A.SelectField) else fields[0], A.Star):
            raise SubqueryError("IN subquery must select exactly one column")
        fts, rows = self._exec_values(sub)
        x = self._rewrite_expr(node.expr, schema, stmt)
        values = [r[0] for r in rows]
        # dedup (IN is a set membership test; collation-aware key)
        seen: set = set()
        uniq = []
        for d in values:
            k = datum_group_key(d, fts[0] if fts else None)
            if k not in seen:
                seen.add(k)
                uniq.append(d)
        if len(uniq) <= MAX_IN_LITERALS:
            if not uniq:
                # x IN () is never TRUE; x NOT IN () is always TRUE
                return None if (negated and conjunct) else (TRUE_LIT() if negated else FALSE_LIT())
            return A.InList(x, [_dlit(d) for d in uniq], negated=negated)
        if not conjunct:
            raise SubqueryError(
                f"IN subquery with >{MAX_IN_LITERALS} values is only supported as a WHERE conjunct"
            )
        has_null = any(d.is_null() for d in uniq)
        if negated and has_null:
            # x NOT IN (S ∪ {NULL}) is never TRUE (three-valued logic)
            return FALSE_LIT()
        nonnull = [d for d in uniq if not d.is_null()]
        meta = self.registry.register(["v"], [fts[0]], [[d] for d in nonnull])
        marker = A.SemiJoinCond(meta.name, [x], ["v"], anti=negated)
        if negated:
            # NULL probe against non-empty S is NULL -> row filtered; the
            # anti join alone would keep it
            return A.BinaryOp("and", marker, A.IsNull(copy.deepcopy(x), negated=True))
        return marker

    def _uncorrelated_tuple_in(self, node, schema, stmt, negated):
        """(a, b) [NOT] IN (select x, y ...): fold the materialized rows
        into OR-of-row-equalities — SQL's own AND/OR/= three-valued logic
        makes the NULL semantics exact (row comparison decomposes to
        component conjunction, ref: expression_rewriter.go buildRowExpr +
        the NAAJ semantics it feeds)."""
        fts, rows = self._exec_values(node.subquery)
        xs = [self._rewrite_expr(copy.deepcopy(p), schema, stmt) for p in node.expr.items]
        if rows and len(rows[0]) != len(xs):
            raise SubqueryError("IN row-value arity mismatch")
        if len(rows) > MAX_IN_LITERALS:
            raise SubqueryError(
                f"row-value IN subquery with >{MAX_IN_LITERALS} rows not supported"
            )
        if not rows:
            return TRUE_LIT() if negated else FALSE_LIT()
        disj = None
        for r in rows:
            eqs = [
                A.BinaryOp("eq", copy.deepcopy(x), _dlit(d))
                for x, d in zip(xs, r)
            ]
            conj = eqs[0]
            for e in eqs[1:]:
                conj = A.BinaryOp("and", conj, e)
            disj = conj if disj is None else A.BinaryOp("or", disj, conj)
        return A.UnaryOp("not", disj) if negated else disj

    def _compare_subquery(self, n: A.CompareSubquery, schema, stmt):
        """cmp ANY/ALL folding over the materialized value set
        (ref: expression_rewriter.go handleCompareSubquery min/max rewrite)."""
        if self._is_correlated(n.subquery, schema):
            return self._apply_fallback(
                "cmp", n.subquery, schema, stmt,
                probe_exprs=[n.expr], cmp_op=n.op, cmp_all=n.all,
            )
        if isinstance(n.expr, A.RowExpr) and (
            (n.op == "eq" and not n.all) or (n.op == "ne" and n.all)
        ):
            # (a,b) = ANY (...) == row IN; (a,b) != ALL (...) == row NOT IN
            # (ref: expression_rewriter.go handleCompareSubquery NAAJ path)
            shim = A.InSubquery(n.expr, n.subquery, negated=(n.op == "ne"))
            return self._uncorrelated_tuple_in(shim, schema, stmt, n.op == "ne")
        fts, rows = self._exec_values(n.subquery)
        x = self._rewrite_expr(n.expr, schema, stmt)
        values = [r[0] for r in rows]
        has_null = any(d.is_null() for d in values)
        nonnull = [d for d in values if not d.is_null()]
        if n.op == "eq" and not n.all:  # = ANY == IN
            return self._fold_in(x, values, negated=False)
        if n.op == "ne" and n.all:  # <> ALL == NOT IN
            return self._fold_in(x, values, negated=True)
        if not values:
            return TRUE_LIT() if n.all else FALSE_LIT()
        if not nonnull:
            return NULL_LIT()
        mn = min(nonnull, key=lambda d: _cmp_key(d, nonnull[0]))
        mx = max(nonnull, key=lambda d: _cmp_key(d, nonnull[0]))
        if n.op in ("lt", "le", "gt", "ge"):
            bound = {
                ("lt", True): mn, ("le", True): mn, ("gt", True): mx, ("ge", True): mx,
                ("lt", False): mx, ("le", False): mx, ("gt", False): mn, ("ge", False): mn,
            }[(n.op, n.all)]
            cond = A.BinaryOp(n.op, x, _dlit(bound))
            if has_null:
                # AND NULL: TRUE->NULL, FALSE->FALSE (ALL); OR NULL:
                # TRUE->TRUE, FALSE->NULL (ANY) — exact three-valued fold
                cond = A.BinaryOp("and" if n.all else "or", cond, NULL_LIT())
            return cond
        if n.op == "eq" and n.all:
            # x = ALL(S): all values equal x
            cond = A.BinaryOp("and", A.BinaryOp("eq", x, _dlit(mn)), A.BinaryOp("eq", copy.deepcopy(x), _dlit(mx)))
            if has_null:
                cond = A.BinaryOp("and", cond, NULL_LIT())
            return cond
        if n.op == "ne" and not n.all:
            # x <> ANY(S): some value differs from x
            cond = A.BinaryOp("or", A.BinaryOp("ne", x, _dlit(mn)), A.BinaryOp("ne", copy.deepcopy(x), _dlit(mx)))
            if has_null:
                cond = A.BinaryOp("or", cond, NULL_LIT())
            return cond
        raise SubqueryError(f"comparison {n.op!r} ANY/ALL not supported")

    def _fold_in(self, x, values, negated):
        seen: set = set()
        uniq = []
        for d in values:
            k = datum_group_key(d)
            if k not in seen:
                seen.add(k)
                uniq.append(d)
        if not uniq:
            return TRUE_LIT() if negated else FALSE_LIT()
        if len(uniq) > MAX_IN_LITERALS:
            raise SubqueryError("ANY/ALL over large value sets not supported in value position")
        return A.InList(x, [_dlit(d) for d in uniq], negated=negated)

    # --------------------------------------------------- correlated forms
    # ----------------------------------------------------- apply fallback
    def _walk_outer_cols(self, node, schema, visit):
        """Walk `node` (a subquery AST) visiting every ColumnName that
        resolves ONLY in the enclosing `schema` (not in its local scope
        chain). `visit(parent, field, index_or_None, colname)` may return a
        replacement node. Mirrors _refs_outer's scope-stack walk."""

        def outer_only(n, schemas) -> bool:
            return (
                isinstance(n, A.ColumnName)
                and not any(self._resolves(n, s) for s in schemas[1:])
                and self._resolves(n, schemas[0])
            )

        def maybe(parent, f_, i, n, schemas):
            if isinstance(n, A.ColumnName):
                if outer_only(n, schemas):
                    rep = visit(n)
                    if rep is not None:
                        if i is None:
                            setattr(parent, f_, rep)
                        else:
                            getattr(parent, f_)[i] = rep
                return
            walk(n, schemas)

        def walk(n, schemas):
            if not hasattr(n, "__dataclass_fields__"):
                return
            sub = getattr(n, "subquery", None)
            if sub is not None and not isinstance(n, A.SubqueryTable):
                for sel in (sub.selects if isinstance(sub, A.SetOprStmt) else [sub]):
                    walk_stmt(sel, schemas + [self._from_schema(sel.from_clause)])
            for f_ in n.__dataclass_fields__:
                if f_ == "subquery":
                    continue
                v = getattr(n, f_)
                if isinstance(v, list):
                    for i, it in enumerate(v):
                        if isinstance(it, tuple):
                            # tuple elements (CASE when/then pairs) may BE
                            # bare outer columns: rebuild the tuple
                            newt, changed = [], False
                            for x in it:
                                if outer_only(x, schemas):
                                    rep = visit(x)
                                    if rep is not None:
                                        x, changed = rep, True
                                else:
                                    walk(x, schemas)
                                newt.append(x)
                            if changed:
                                v[i] = tuple(newt)
                        elif hasattr(it, "__dataclass_fields__"):
                            maybe(n, f_, i, it, schemas)
                elif hasattr(v, "__dataclass_fields__"):
                    maybe(n, f_, None, v, schemas)

        def walk_stmt(sel, schemas):
            if isinstance(sel, A.SetOprStmt):
                for s in sel.selects:
                    walk_stmt(s, schemas)
                return
            for f in sel.fields:
                walk(f, schemas)
            for f_ in ("where", "having"):
                part = getattr(sel, f_)
                if part is not None:
                    maybe(sel, f_, None, part, schemas)
            for b in list(sel.group_by) + list(sel.order_by):
                maybe(b, "expr", None, b.expr, schemas)

            def walk_from(fr):
                if isinstance(fr, A.Join):
                    walk_from(fr.left)
                    walk_from(fr.right)
                    if fr.on is not None:
                        walk(fr.on, schemas)
            walk_from(sel.from_clause)

        sels = node.selects if isinstance(node, A.SetOprStmt) else [node]
        for sel in sels:
            walk_stmt(sel, [schema, self._from_schema(sel.from_clause)])

    def _apply_fallback(self, kind, sub, schema, stmt, probe_exprs=(), negated=False, cmp_op=None, cmp_all=False):
        """Correlated subquery the decorrelator can't handle -> register a
        host-evaluated function that re-executes the inner per outer row
        (deduplicated by binding), and rewrite to a call on the outer refs.
        kind: exists | in | scalar | cmp."""
        from ..exec.executor import datum_group_key as _gk
        from ..types import new_longlong
        from .extension import EXTENSIONS
        from .planner import datum_ft

        refs: list = []
        ref_keys: dict = {}

        def collect(c: A.ColumnName):
            k = (c.db.lower(), c.table.lower(), c.name.lower())
            if k not in ref_keys:
                ref_keys[k] = len(refs)
                refs.append(A.ColumnName(c.name, c.table, c.db))
            return None

        self._walk_outer_cols(sub, schema, collect)
        if not refs:
            raise SubqueryError("correlated subquery has no resolvable outer references")
        probes = [self._rewrite_expr(copy.deepcopy(p), schema, stmt) for p in probe_exprs]
        np_ = len(probes)
        cache: dict = {}
        exec_query = self.exec_query
        resolves = self._resolves
        from_schema = self._from_schema
        walker = self._walk_outer_cols

        def tuple_in_3vl(xs, rows):
            if rows and len(rows[0]) != len(xs):
                from .session import SQLError

                raise SQLError(f"Operand should contain {len(xs)} column(s)")
            any_unknown = False
            for r in rows:
                all_true, unknown = True, False
                for x, s in zip(xs, r):
                    if x.is_null() or s.is_null():
                        unknown = True
                        continue
                    if compare(x, s) != 0:
                        all_true = False
                        unknown = False
                        break
                if all_true and not unknown:
                    return Datum.i64(0) if negated else Datum.i64(1)
                if unknown:
                    any_unknown = True
            if any_unknown:
                return Datum.NULL
            return Datum.i64(1) if negated else Datum.i64(0)

        def run(datums):
            key = tuple(_gk(d) for d in datums)
            if key in cache:
                return cache[key]
            bind = datums[np_:]
            sub2 = copy.deepcopy(sub)

            def subst(c: A.ColumnName):
                i = ref_keys.get((c.db.lower(), c.table.lower(), c.name.lower()))
                return _dlit(bind[i]) if i is not None else None

            walker(sub2, schema, subst)
            names, fts, rows = exec_query(sub2)
            if kind == "exists":
                out = Datum.i64(1 if bool(rows) ^ negated else 0)
            elif kind == "in":
                out = tuple_in_3vl(datums[:np_], rows)
            elif kind == "scalar":
                if len(rows) > 1:
                    # runtime (not rewrite-time) error: surface as SQLError
                    # so the session reports it like any statement error
                    from .session import SQLError

                    raise SQLError("Subquery returns more than 1 row")
                out = rows[0][0] if rows else Datum.NULL
            else:  # cmp ANY/ALL
                x = datums[0]
                vals = [r[0] for r in rows]
                if not vals:
                    out = Datum.i64(1 if cmp_all else 0)
                elif x.is_null():
                    out = Datum.NULL
                else:
                    import operator

                    opf = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
                           "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}[cmp_op]
                    res, unknown = (True if cmp_all else False), False
                    for v in vals:
                        if v.is_null():
                            unknown = True
                            continue
                        ok = opf(compare(x, v), 0)
                        if cmp_all and not ok:
                            res = False
                            unknown = False
                            break
                        if not cmp_all and ok:
                            res = True
                            unknown = False
                            break
                    out = Datum.NULL if unknown else Datum.i64(1 if res else 0)
            cache[key] = out
            return out

        fname = f"__apply_{id(sub):x}_{len(EXTENSIONS.functions)}"
        if kind == "scalar":
            # discover the result type from one NULL-bound probe run; on
            # any failure surface the original unsupported-shape error
            try:
                sub_t = copy.deepcopy(sub)
                walker(sub_t, schema, lambda c: A.Literal(None, "null"))
                _, t_fts, _ = exec_query(sub_t)
                ft = t_fts[0] if t_fts else new_longlong()
            except Exception as exc:  # noqa: BLE001
                raise SubqueryError(f"correlated scalar subquery not supported: {exc}") from exc
        else:
            ft = new_longlong()
        EXTENSIONS.register_function(fname, run, ft, raw=True)
        return A.FuncCall(fname, probes + refs)

    def _extract_corr(self, sub: A.SelectStmt, schema):
        """Split the inner WHERE into local conjuncts and correlation pairs
        (inner_expr, outer_expr). Raises unless every correlated conjunct
        is an equality with one pure-inner and one pure-outer side."""
        if isinstance(sub, A.SetOprStmt):
            raise SubqueryError("correlated UNION subqueries not supported")
        if sub.limit is not None or sub.order_by:
            raise SubqueryError("correlated subqueries with ORDER BY/LIMIT not supported")
        if sub.having is not None:
            raise SubqueryError("correlated subqueries with HAVING not supported")
        inner_schema = self._from_schema(sub.from_clause)
        local, pairs = [], []
        for c in _split_conjuncts(sub.where):
            if not self._refs_outer(c, inner_schema, [schema]):
                local.append(c)
                continue
            if not (isinstance(c, A.BinaryOp) and c.op == "eq"):
                raise SubqueryError(
                    "correlated subqueries support equality correlation only "
                    f"(got {type(c).__name__})"
                )

            def side_kind(e):
                refs_i = [False]
                refs_o = [False]

                def walk(x):
                    if isinstance(x, A.ColumnName):
                        if self._resolves(x, inner_schema):
                            refs_i[0] = True
                        elif self._resolves(x, schema):
                            refs_o[0] = True
                        return
                    if hasattr(x, "__dataclass_fields__"):
                        for f_ in x.__dataclass_fields__:
                            v = getattr(x, f_)
                            for it in v if isinstance(v, (list, tuple)) else [v]:
                                if hasattr(it, "__dataclass_fields__"):
                                    walk(it)

                walk(e)
                if refs_i[0] and refs_o[0]:
                    return "mixed"
                return "outer" if refs_o[0] else "inner"

            lk, rk = side_kind(c.left), side_kind(c.right)
            if lk == "inner" and rk == "outer":
                pairs.append((c.left, c.right))
            elif lk == "outer" and rk == "inner":
                pairs.append((c.right, c.left))
            else:
                raise SubqueryError(
                    "correlated equality must have one inner-only and one outer-only side"
                )
        if not pairs:
            raise SubqueryError("correlated subquery has no usable equality correlation")
        return local, pairs

    def _correlated_semi(self, sub, schema, in_expr, negated):
        """Correlated [NOT] IN / [NOT] EXISTS conjunct -> SemiJoinCond."""
        if isinstance(sub, A.SetOprStmt):
            raise SubqueryError("correlated UNION subqueries not supported")
        if sub.group_by or any(_has_agg_field(f) for f in sub.fields):
            raise SubqueryError("correlated IN/EXISTS with aggregation not supported")
        local, pairs = self._extract_corr(sub, schema)
        fields = []
        if in_expr is not None:
            inner_fields = sub.fields
            if len(inner_fields) != 1:
                raise SubqueryError("IN subquery must select exactly one column")
            ve = inner_fields[0].expr if isinstance(inner_fields[0], A.SelectField) else inner_fields[0]
            if isinstance(ve, A.Star):
                raise SubqueryError("IN subquery must select exactly one column")
            fields.append(A.SelectField(ve, "v"))
        for i, (ie, _) in enumerate(pairs):
            fields.append(A.SelectField(ie, f"k{i}"))
        mat_sel = A.SelectStmt(fields=fields, from_clause=sub.from_clause, where=_and_all(local))
        names, fts, rows = self.exec_query(mat_sel)
        probe = ([in_expr] if in_expr is not None else []) + [oe for _, oe in pairs]
        build = list(names)
        if in_expr is not None and negated:
            # rows whose value is NULL poison their whole correlation group
            # (x NOT IN {... NULL} is never TRUE): a second anti join on the
            # correlation keys alone removes probes of poisoned groups
            null_rows = [r[1:] for r in rows if r[0].is_null()]
            rows = [r for r in rows if not r[0].is_null()]
            meta = self.registry.register(build, fts, rows)
            marker = A.SemiJoinCond(meta.name, probe, build, anti=True, require_notnull_probe=True)
            if null_rows and pairs:
                nmeta = self.registry.register(build[1:], fts[1:], null_rows)
                poison = A.SemiJoinCond(nmeta.name, [copy.deepcopy(oe) for _, oe in pairs], build[1:], anti=True)
                return A.BinaryOp("and", marker, poison)
            if null_rows and not pairs:
                return FALSE_LIT()
            return marker
        meta = self.registry.register(build, fts, rows)
        return A.SemiJoinCond(meta.name, probe, build, anti=negated)

    def _scalar(self, sub, schema, stmt):
        """Scalar subquery in value position."""
        if isinstance(sub, A.SetOprStmt):
            sel = sub.selects[0]
        else:
            sel = sub
        n_fields = len(sel.fields)
        if n_fields != 1:
            raise SubqueryError("scalar subquery must select exactly one column")
        if not self._is_correlated(sub, schema):
            _, rows = self._exec_values(sub)
            if len(rows) > 1:
                raise SubqueryError("Subquery returns more than 1 row")
            return _dlit(rows[0][0]) if rows else NULL_LIT()
        if isinstance(sub, A.SetOprStmt):
            return self._apply_fallback("scalar", sub, schema, stmt)
        try:
            return self._scalar_corr(copy.deepcopy(sub), schema, stmt)
        except SubqueryError:
            return self._apply_fallback("scalar", sub, schema, stmt)

    def _scalar_corr(self, sub: A.SelectStmt, schema, stmt):
        """Correlated scalar subquery -> LEFT JOIN against the inner
        re-grouped by its correlation keys (ref: rule_decorrelate.go's
        aggregate pull-up producing an outer join)."""
        if sub.group_by:
            raise SubqueryError("correlated scalar subqueries with GROUP BY not supported")
        local, pairs = self._extract_corr(sub, schema)
        f0 = sub.fields[0]
        ve = f0.expr if isinstance(f0, A.SelectField) else f0
        if isinstance(ve, A.Star):
            raise SubqueryError("scalar subquery must select exactly one column")
        inner_schema = self._from_schema(sub.from_clause)
        if self._refs_outer(ve, inner_schema, [schema]):
            raise SubqueryError("outer references in a scalar subquery's select list not supported")
        has_agg = _has_agg_expr(ve)
        fields = [A.SelectField(ie, f"k{i}") for i, (ie, _) in enumerate(pairs)]
        fields.append(A.SelectField(ve, "v"))
        mat_sel = A.SelectStmt(fields=fields, from_clause=sub.from_clause, where=_and_all(local))
        if has_agg:
            mat_sel.group_by = [A.ByItem(copy.deepcopy(ie)) for ie, _ in pairs]
        names, fts, rows = self.exec_query(mat_sel)
        if not has_agg:
            keys = set()
            for r in rows:
                k = tuple(datum_group_key(d, ft) for d, ft in zip(r[:-1], fts))
                if k in keys:
                    raise SubqueryError("Subquery returns more than 1 row")
                keys.add(k)
        meta = self.registry.register(names, fts, rows)
        alias = "_sq_" + meta.name.lstrip("#")
        on = _and_all([
            A.BinaryOp("eq", copy.deepcopy(oe), A.ColumnName(f"k{i}", alias))
            for i, (_, oe) in enumerate(pairs)
        ])
        stmt.from_clause = A.Join(stmt.from_clause, A.TableName(meta.name, alias=alias), "left", on)
        ref = A.ColumnName("v", alias)
        if isinstance(ve, A.AggFunc) and ve.name.lower() == "count":
            # COUNT over an empty correlation group is 0, not NULL — the
            # left join's null extension must be patched back
            return A.FuncCall("ifnull", [ref, A.Literal(0, "int")])
        return ref


def _has_agg_expr(n) -> bool:
    if isinstance(n, A.AggFunc):
        return True
    if not hasattr(n, "__dataclass_fields__"):
        return False
    for f_ in n.__dataclass_fields__:
        v = getattr(n, f_)
        for it in v if isinstance(v, (list, tuple)) else [v]:
            if isinstance(it, tuple):
                if any(_has_agg_expr(x) for x in it):
                    return True
            elif _has_agg_expr(it):
                return True
    return False


def _has_agg_field(f) -> bool:
    return _has_agg_expr(f.expr if isinstance(f, A.SelectField) else f)


class _CmpWrap:
    """Total-order wrapper for min/max over homogeneous datums."""

    __slots__ = ("d",)

    def __init__(self, d):
        self.d = d

    def __lt__(self, other):
        return compare(self.d, other.d) < 0

    def __eq__(self, other):
        return compare(self.d, other.d) == 0


def _cmp_key(d: Datum, ref: Datum) -> _CmpWrap:
    return _CmpWrap(d)
