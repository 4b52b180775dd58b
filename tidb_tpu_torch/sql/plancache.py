"""Digest-keyed plan cache — the session-tier front door (ref:
pkg/planner/core/plan_cache.go + pkg/parser/digester.go: the reference
caches physical plans per normalized-SQL digest so repeated OLTP
statements and PREPARE/EXECUTE skip parse+plan entirely; our ProgramCache
already dedups compiled kernels BELOW the planner — this layer closes the
gap above it).

Key = the literal-masked lexer digest (the same normalization that drives
the slow log / statement summary, util/stmtlog.py) + current db + the
literal KIND signature + a plan-relevant sysvar fingerprint + the
session-binding revision. Schema drift is a validation, not a key part:
each entry records a content fingerprint of every referenced table and is
dropped when the catalog moved under it (invalidation rides the existing
`Catalog.version` / `TableMeta.schema_version` bumps).

Value = a literal-slotted template at one of three tiers, strongest first:

  pointget  the statement is the PointGet fast-path shape: the bound
            template re-executes the key read directly — no parse, no
            planner, no coprocessor.
  dag       the planned physical DAG with literal SLOTS: every literal
            provably lands either in a Selection comparison (re-lowered
            in place on hit) or in the scan-range recipe (ranger re-runs
            over the bound conjuncts — TiDB's rebuildRange-at-EXECUTE);
            parse AND plan are skipped.
  ast       the parsed statement template only: literals re-bind into a
            deep copy and the planner re-runs — parse is skipped. The
            graceful tier for shapes whose literals fold into the plan
            (projection arithmetic, LIMIT offsets, partition pruning).

Slots are carried by `SlotInt`/`SlotStr` — int/str subclasses tagged with
their lexical slot ordinal, assigned from the parser's token offsets
(`A.Literal.pos`). They compare/hash equal to their plain values, so the
install-time planning pass runs unchanged while every place a literal
SURVIVES into the plan stays discoverable. A literal the planner folds
away (so a re-bound value could not take effect) fails the slot audit and
the entry degrades to the `ast` tier — soundness by construction.

Non-cacheable shapes decline with a typed reason (DDL, multi-statement,
subqueries, views, user variables, stale reads, open transactions, ...),
surfaced per statement in EXPLAIN [ANALYZE] and the
`tidb_tpu_plan_cache_declines_total{reason=}` counter.

Copy of `tidb_tpu/sql/plancache.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from ..parser import ast as A
from ..parser.lexer import T, tokenize


class RebindError(ValueError):
    """A cached template could not re-bind the hot statement's literals
    (recipe produced no intervals, slot/kind drift, ...) — the caller
    treats the lookup as a miss and replans from scratch."""


# --------------------------------------------------------------- slot values

class SlotInt(int):
    """int tagged with its literal-slot ordinal; == / hash() follow the
    plain value so planning with a slotted template is planning with the
    real statement."""

    def __new__(cls, v: int, slot: int):
        o = super().__new__(cls, v)
        o.slot = slot
        return o

    def __deepcopy__(self, memo):
        return SlotInt(int(self), self.slot)


class SlotStr(str):
    """str twin of SlotInt (string literals and float/decimal literal
    TEXT — the parser keeps those as strings)."""

    def __new__(cls, v: str, slot: int):
        o = super().__new__(cls, v)
        o.slot = slot
        return o

    def __deepcopy__(self, memo):
        return SlotStr(str.__str__(self), self.slot)


def slot_of(v) -> int | None:
    return getattr(v, "slot", None) if isinstance(v, (SlotInt, SlotStr)) else None


# ------------------------------------------------------------- text probing

# literal kinds a slot may carry; anything else (hex blobs, X/B literals,
# adjacent-string concat) declines the statement — see the parser's pos
# sentinel convention (-1 untracked, -2 uncacheable shape)
_SLOT_KINDS = {"int": "i", "str": "s", "decimal": "d", "float": "f", "null": "n"}


@dataclass
class StmtProbe:
    """One statement's text-derived cache probe: the literal-masked digest
    plus the masked-token count the AST's slot collection must match.
    Built once per `Session.execute` from a single lexer pass (the same
    pass also feeds the slow log's digest, so the hot path lexes once).

    `slot_values`/`slot_kinds` are the masked tokens' literal values in
    lexical order — EXACTLY what the parser would store on the matching
    `A.Literal` nodes (ints parsed, decimal/float/string text verbatim;
    the parser never transforms a masked token's text, unary minus stays
    an enclosing UnaryOp node). A cache hit binds them into the template
    WITHOUT parsing — the parse-free fast path."""

    digest: str
    normalized: str
    n_masked: int
    has_var: bool = False
    multi_stmt: bool = False
    slot_values: tuple = ()
    slot_kinds: str = ""
    has_param: bool = False  # '?' markers: values come from EXECUTE, not text

    @staticmethod
    def from_sql(sql: str) -> "StmtProbe | None":
        try:
            toks = tokenize(sql)
        except Exception:  # noqa: BLE001 — unlexable text: no probe
            return None
        return StmtProbe._from_tokens(toks)

    @staticmethod
    def _from_tokens(toks) -> "StmtProbe":
        import hashlib

        parts = []
        values: list = []
        kinds: list = []
        has_var = False
        has_param = False
        multi = False
        last = len(toks) - 1
        for i, t in enumerate(toks):
            if t.kind is T.EOF:
                break
            if t.kind is T.NUMBER:
                parts.append("?")
                low = t.text.lower()
                if "e" in low:  # the parser's literal-kind decision, mirrored
                    values.append(t.text)
                    kinds.append("f")
                elif "." in t.text:
                    values.append(t.text)
                    kinds.append("d")
                else:
                    values.append(int(t.text))
                    kinds.append("i")
            elif t.kind is T.STRING:
                parts.append("?")
                values.append(t.text)
                kinds.append("s")
            elif t.kind is T.PARAM:
                # a PREPARE text's '?' markers are masked tokens too — the
                # prepared statement normalizes IDENTICALLY to its textual
                # form, so EXECUTE shares the direct statement's cache
                # entries and summary row (values bind at EXECUTE time)
                parts.append("?")
                values.append(None)
                kinds.append("?")
                has_param = True
            elif t.kind in (T.IDENT, T.QIDENT):
                parts.append(t.text.lower())
            else:
                if t.kind is T.OP and t.text == "@":
                    has_var = True
                if t.kind is T.OP and t.text == ";" and i < last - 1:
                    multi = True
                parts.append(t.text)
        norm = " ".join(parts)
        digest = hashlib.sha256(norm.encode()).hexdigest()[:32]
        return StmtProbe(digest, norm, len(values), has_var, multi,
                         tuple(values), "".join(kinds), has_param)

    @staticmethod
    def inner_probe(sql: str, kind: str) -> "StmtProbe | None":
        """Probe for the statement INSIDE an EXPLAIN [ANALYZE] / TRACE
        [FORMAT='x'] wrapper: strip the wrapper tokens and re-digest, so
        the inner statement shares cache entries with its direct form."""
        try:
            toks = tokenize(sql)
        except Exception:  # noqa: BLE001
            return None
        i = 0
        def at_kw(j, *kws):
            return (j < len(toks) and toks[j].kind is T.IDENT
                    and toks[j].text.lower() in kws)
        if kind == "explain":
            if not at_kw(i, "explain", "desc", "describe"):
                return None
            i += 1
            if at_kw(i, "analyze"):
                i += 1
        elif kind == "trace":
            if not at_kw(i, "trace"):
                return None
            i += 1
            if (at_kw(i, "format") and i + 2 < len(toks)
                    and toks[i + 1].text == "="):
                i += 3
        return StmtProbe._from_tokens(toks[i:])


# --------------------------------------------------------- slot collection

def collect_slots(stmt) -> list:
    """Token-position-tagged literals of a statement AST, in lexical
    order — the binding order of the masked tokens. Raises RebindError on
    an uncacheable literal shape (the parser's pos == -2 sentinel)."""
    out: list = []

    def walk(n):
        if isinstance(n, (list, tuple)):
            for x in n:
                walk(x)
            return
        if isinstance(n, A.Literal):
            if n.pos == -2:
                raise RebindError("uncacheable literal shape")
            if n.pos >= 0:
                out.append(n)
            return
        if isinstance(n, A.ParamMarker):
            raise RebindError("unbound parameter marker")
        if not hasattr(n, "__dataclass_fields__"):
            return
        for f_ in n.__dataclass_fields__:
            walk(getattr(n, f_))

    walk(stmt)
    out.sort(key=lambda lit: lit.pos)
    return out


def slot_signature(lits: list) -> str:
    sig = []
    for lit in lits:
        k = _SLOT_KINDS.get(lit.kind)
        if k is None:
            raise RebindError(f"uncacheable literal kind {lit.kind!r}")
        sig.append(k)
    return "".join(sig)


def wrap_slots(stmt, n_masked: int) -> str:
    """Tag the template's literals with their slot ordinals IN PLACE and
    return the kind signature. The count must match the lexer's masked
    tokens — a mismatch means some literal came from somewhere other than
    a masked token (string concat, synthesized nodes) and binding by
    position would be unsound."""
    lits = collect_slots(stmt)
    if len(lits) != n_masked:
        raise RebindError(
            f"literal slot count {len(lits)} != masked tokens {n_masked}")
    sig = slot_signature(lits)
    for i, lit in enumerate(lits):
        if lit.kind == "int":
            lit.value = SlotInt(int(lit.value), i)
        elif lit.kind in ("str", "decimal", "float"):
            lit.value = SlotStr(str(lit.value), i)
        # "null": value None is pinned by the kind signature — no tag
    return sig


def live_slot_values(stmt, n_masked: int) -> tuple[list, str]:
    """(values, kind signature) of the HOT statement's literals, by
    lexical position — what binds into a cached template."""
    lits = collect_slots(stmt)
    if len(lits) != n_masked:
        raise RebindError(
            f"literal slot count {len(lits)} != masked tokens {n_masked}")
    return [lit.value for lit in lits], slot_signature(lits)


def bind_template(template, values: list):
    """Clone a slotted template with the bound values substituted — the
    EXECUTE-parameter rebind, shared by every tier. One hand-rolled pass
    (clone + bind together): ASTs are trees of plain dataclasses, so a
    memo-free field walk beats copy.deepcopy by ~3x on the hit path;
    non-node leaves (ints, strings, Decimals, None) are immutable and
    pass through by reference."""

    def clone(n):
        if isinstance(n, A.Literal):
            s = slot_of(n.value)
            return A.Literal(values[s] if s is not None else n.value,
                             n.kind, n.pos)
        if isinstance(n, list):
            return [clone(x) for x in n]
        if isinstance(n, tuple):
            return tuple(clone(x) for x in n)
        fields_ = getattr(n, "__dataclass_fields__", None)
        if fields_ is None:
            return n
        out = object.__new__(type(n))
        for f_ in fields_:
            setattr(out, f_, clone(getattr(n, f_)))
        return out

    return clone(template)


# ------------------------------------------------------------ decline check

#: fixed reason vocabulary (metric label cardinality stays bounded)
DECLINE_REASONS = (
    "not_select", "ddl", "set_opr", "multi_statement", "user_var",
    "in_txn", "stale_read", "for_update", "cte", "subquery",
    "derived_table", "view", "memtable", "no_table", "literal_shape",
    "positional_ref", "uncacheable", "disabled", "dml_shape",
)

_DDL_KINDS = (
    "CreateTableStmt", "DropTableStmt", "AlterTableStmt", "RenameTableStmt",
    "CreateIndexStmt", "DropIndexStmt", "TruncateTableStmt",
    "CreateViewStmt", "DropViewStmt", "CreateDatabaseStmt",
    "DropDatabaseStmt",
)


def stmt_kind_reason(stmt) -> str | None:
    """Typed decline for statement kinds the cache never serves (None =
    SELECT — keep checking shape — or UPDATE/DELETE, whose point-write
    shapes get a `pointwrite` tier entry, the DML execute path
    owns that shape decision and counts `dml_shape` for the rest)."""
    if isinstance(stmt, (A.SelectStmt, A.UpdateStmt, A.DeleteStmt)):
        return None
    if isinstance(stmt, A.SetOprStmt):
        return "set_opr"
    if type(stmt).__name__ in _DDL_KINDS:
        return "ddl"
    return "not_select"


def shape_decline(stmt, session, probe: StmtProbe) -> str | None:
    """Typed reason this SELECT cannot be cached, or None. Session-state
    reasons (txn, stale read) are re-checked per statement; structural
    reasons transfer to every digest-equal statement."""
    if probe.multi_stmt:
        return "multi_statement"
    if probe.has_var:
        return "user_var"
    if session.txn is not None:
        return "in_txn"
    if session.sysvars.get("tidb_snapshot"):
        return "stale_read"
    if stmt.for_update:
        return "for_update"
    if stmt.ctes:
        return "cte"
    if stmt.from_clause is None:
        return "no_table"

    # FROM tree must be plain named tables (joins of TableNames)
    def from_ok(n):
        if isinstance(n, A.TableName):
            return True
        if isinstance(n, A.Join):
            return from_ok(n.left) and from_ok(n.right)
        return False

    if not from_ok(stmt.from_clause):
        return "derived_table"

    # any nested query anywhere (correlated state lives in the rewriter)
    found: list = []

    def walk(n, top=False):
        if isinstance(n, (list, tuple)):
            for x in n:
                walk(x)
            return
        if not top and isinstance(n, (A.SelectStmt, A.SetOprStmt, A.Exists)):
            found.append(n)
            return
        if not hasattr(n, "__dataclass_fields__"):
            return
        for f_ in n.__dataclass_fields__:
            walk(getattr(n, f_))

    walk(stmt, top=True)
    if found:
        return "subquery"

    names: list = []

    def tables(n):
        if isinstance(n, A.TableName):
            names.append(n)
        elif isinstance(n, A.Join):
            tables(n.left)
            tables(n.right)

    tables(stmt.from_clause)
    for t in names:
        eff_db = (t.db or session.db or "").lower()
        if eff_db in ("information_schema", "performance_schema"):
            return "memtable"
        if session.catalog.view_of(t.name) is not None:
            return "view"
        try:
            session.catalog.table(t.name)
        except Exception:  # noqa: BLE001 — unknown table: let the planner error
            return "uncacheable"
    return None


# --------------------------------------------------------------- table fps

def table_fingerprint(meta) -> tuple:
    """Content fingerprint of everything plan-relevant on a table: column
    shape, index set WITH online-DDL states, handle, partition layout.
    Any drift (ALTER TABLE, CREATE/DROP INDEX, reorg state steps)
    invalidates cached plans over the table."""
    return (
        meta.table_id, meta.schema_version,
        tuple((c.name, c.col_id, int(c.ft.tp), int(c.ft.flag), c.ft.flen,
               c.ft.decimal) for c in meta.columns),
        tuple((i.index_id, i.name, tuple(i.col_names), i.unique, i.state)
              for i in meta.indices),
        meta.handle_col,
        tuple(meta.physical_ids()),
    )


#: sysvars whose value shapes the PLAN (not just its execution): part of
#: the cache key, so a SET simply moves the session onto other entries
PLAN_SYSVARS = (
    "tidb_enable_tpu_coprocessor", "tidb_enable_tpu_mesh",
    "tidb_allow_mpp",
    "tidb_allow_batch_cop", "tidb_isolation_read_engines",
    "tidb_enable_index_merge", "sql_mode", "collation_connection",
    "time_zone", "div_precision_increment",
)


def sysvar_fingerprint(sysvars) -> str:
    return "|".join(sysvars.get(n) for n in PLAN_SYSVARS)


# ------------------------------------------------------------- cache entry

@dataclass
class PlanCacheEntry:
    tier: str  # "pointget" | "dag" | "ast"
    template: object  # slotted statement AST (never executed in place)
    n_slots: int
    kinds: str
    table_fps: dict  # catalog key name -> table_fingerprint
    catalog_version: int  # fast-path validation ticket; guarded by the cache lock
    bindings_rev: int
    has_limit: bool = False
    # dag tier only:
    plan: object = None  # slotted PlannedQuery
    range_src: tuple = ("full",)
    probe_name: str = ""
    build_names: tuple = ()
    hits: int = 0  # guarded by the cache lock


class PlanCache:
    """Server-shared LRU over (digest, db, kinds, sysvar-fp, bindings)
    keys — every session of a catalog consults one cache (the reference's
    instance-level plan cache)."""

    def __init__(self, capacity: int = 512, shared: bool = False):
        self.capacity = capacity
        #: the shared cross-catalog instance must not drive the
        #: tidb_tpu_plan_cache_entries gauge — that gauge tracks the
        #: per-catalog cache, and two writers would fight over it
        self._shared = shared
        self._mu = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # guarded_by: _mu

    def lookup(self, key, catalog, bindings_rev: int):
        """Validated entry for `key`, or None. Schema validation is a
        catalog.version ticket: unchanged version ⇒ tables unchanged;
        a moved version re-checks per-table content fingerprints and
        drops the entry on drift (the TableMeta.schema_version ride)."""
        from ..util import metrics

        with self._mu:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            if e.bindings_rev != bindings_rev:
                del self._entries[key]
                if not self._shared:
                    metrics.PLAN_CACHE_ENTRIES.set(len(self._entries))
                return None
            if e.catalog_version != catalog.version:
                for name, fp in e.table_fps.items():
                    try:
                        meta = catalog.table(name)
                    except Exception:  # noqa: BLE001 — dropped table
                        meta = None
                    if meta is None or table_fingerprint(meta) != fp:
                        del self._entries[key]
                        if not self._shared:
                            metrics.PLAN_CACHE_ENTRIES.set(len(self._entries))
                        return None
                e.catalog_version = catalog.version  # re-validated: cheap again
            e.hits += 1
            return e

    def lookup_shared(self, key, catalog):
        """Cross-catalog lookup. A catalog.version
        ticket is meaningless in another catalog — two catalogs' version
        counters advance independently, so version 5 here and version 5
        there can name different schemas. Every shared hit therefore
        re-checks the per-table content fingerprints against the adopting
        catalog; the returned copy carries the adopter's version ticket so
        its promoted local entry validates cheaply from then on. Mismatch
        returns None without evicting — the entry stays valid for its
        home catalog."""
        with self._mu:
            e = self._entries.get(key)
            if e is None or e.bindings_rev != 0:
                return None
            self._entries.move_to_end(key)
            for name, fp in e.table_fps.items():
                try:
                    meta = catalog.table(name)
                except Exception:  # noqa: BLE001 — no such table here
                    meta = None
                if meta is None or table_fingerprint(meta) != fp:
                    return None
            e.hits += 1
            out = copy.copy(e)
            out.catalog_version = catalog.version
            return out

    def put(self, key, entry: PlanCacheEntry):
        from ..util import metrics

        with self._mu:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > max(self.capacity, 1):
                self._entries.popitem(last=False)
                if not self._shared:
                    metrics.PLAN_CACHE_EVICTIONS.inc()
            if not self._shared:
                metrics.PLAN_CACHE_ENTRIES.set(len(self._entries))

    def clear(self):
        from ..util import metrics

        with self._mu:
            self._entries.clear()
            if not self._shared:
                metrics.PLAN_CACHE_ENTRIES.set(0)

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._entries),
                "tiers": {t: sum(1 for e in self._entries.values() if e.tier == t)
                          for t in ("pointget", "dag", "ast", "pointwrite")},
            }

    def __len__(self):
        with self._mu:
            return len(self._entries)


# ----------------------------------------------- shared cross-catalog tier

#: process-wide tier behind every catalog's own cache (
#: satellite): sessions over DIFFERENT catalogs (one TPUStore per tenant)
#: that compile the same digest against byte-identical schemas reuse one
#: slotted template instead of paying one compile per catalog. Entries
#: are copies — the home catalog's cache never aliases the shared one.
SHARED_CACHE = PlanCache(256, shared=True)


def publish_shared(key, entry: PlanCacheEntry,
                   catalog_bindings_rev: int, session_bindings_rev: int):
    """Offer a fresh install to the shared tier. Binding-active catalogs
    and sessions never publish (nor adopt): a binding-shaped plan must not
    leak into a catalog that doesn't carry that binding, and binding
    revisions don't transfer across catalogs."""
    if catalog_bindings_rev != 0 or session_bindings_rev != 0:
        return
    e = copy.copy(entry)
    e.hits = 0
    SHARED_CACHE.put(key, e)


# --------------------------------------------------------- dag-tier rebind

#: comparison ops whose DIRECT Const arguments may be literal slots — the
#: re-lowered const feeds a boolean, so no parent FieldType goes stale
_CMP_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge", "nulleq", "in",
                      "between", "like"})
_LOGIC_OPS = frozenset({"and", "or", "not", "xor"})


def _relower(value, kind_code: str):
    """Re-lower a bound slot value exactly as a fresh parse+plan would
    (planner._lower_literal over the reconstructed literal)."""
    from .planner import _lower_literal

    kind = {"i": "int", "s": "str"}[kind_code]
    return _lower_literal(A.Literal(value, kind))


def audit_dag_slots(plan, kinds: str, n_slots: int) -> bool:
    """True when EVERY literal slot provably survives into a re-bindable
    position of the planned DAG: a Const that is a direct argument of a
    comparison inside a Selection (re-lowered on hit), or an int count on
    TopN/Limit. Slots the planner folded away, or that landed in
    projection/aggregation expressions (where parent FieldTypes were
    inferred from the cold value), fail the audit — the entry then rides
    the `ast` tier instead. Each surviving Const must also round-trip
    through re-lowering byte-identically, proving the hit-time rebind
    reproduces the cold plan exactly."""
    from ..expr.ir import Const, ScalarFunc
    from .dag_rebind import iter_exec_fields

    covered: set = set()
    ok = [True]

    def visit_expr(e, ctx):
        # ctx: "logic" (selection condition spine) | "other"
        if isinstance(e, Const):
            s = slot_of(e.datum.val)
            if s is None:
                return
            if ctx != "cmp":
                ok[0] = False
                return
            k = kinds[s]
            if k not in ("i", "s"):
                ok[0] = False
                return
            fresh = _relower(e.datum.val, k)
            if (fresh.datum.kind != e.datum.kind or fresh.datum.val != e.datum.val
                    or fresh.ft.tp != e.ft.tp or int(fresh.ft.flag) != int(e.ft.flag)
                    or fresh.ft.decimal != e.ft.decimal):
                ok[0] = False
                return
            covered.add(s)
            return
        if isinstance(e, ScalarFunc):
            if ctx == "logic" and e.op in _LOGIC_OPS:
                for a in e.args:
                    visit_expr(a, "logic")
                return
            if ctx == "logic" and e.op in _CMP_OPS:
                for a in e.args:
                    visit_expr(a, "cmp" if isinstance(a, Const) else "other")
                return
            for a in e.args:
                visit_expr(a, "other")

    from ..exec.dag import Limit, Selection, TopN

    for ex in plan.dag.executors:
        if isinstance(ex, Selection):
            for c in ex.conditions:
                visit_expr(c, "logic")
        elif isinstance(ex, (TopN, Limit)):
            s = slot_of(ex.limit)
            if s is not None:
                if kinds[s] != "i":
                    ok[0] = False
                else:
                    covered.add(s)
            for e, _k in iter_exec_fields(ex):
                visit_expr(e, "other")
        else:
            for e, _k in iter_exec_fields(ex):
                visit_expr(e, "other")
    if not ok[0]:
        return False
    # every slot must be re-bindable somewhere: a dag comparison const, a
    # TopN/Limit count, or a range-recipe conjunct (the recipe re-runs
    # ranger over the BOUND template WHERE, so slots that reached the
    # recipe's column are covered by construction when they also appear in
    # the Selection — which lowers EVERY local conjunct, consumed-by-range
    # or not). Anything else (folded, projected) fails.
    if slot_of(plan.offset) is not None:
        return False
    return covered | _null_slots(kinds) == set(range(n_slots))


def _null_slots(kinds: str) -> set:
    # NULL-kind slots (EXECUTE with a NULL parameter) are pinned by the
    # kind signature itself: every hit on this entry has NULL there
    return {i for i, k in enumerate(kinds) if k == "n"}


def rebind_plan(entry: PlanCacheEntry, values: list, catalog):
    """Bind hot literal values into a dag-tier entry → a fresh
    PlannedQuery: Consts re-lowered in place, scan ranges recomputed by
    the recipe (ranger re-run over the bound conjuncts — the
    rebuildRange-at-EXECUTE analog), table metas re-resolved live."""
    from dataclasses import replace as _dc_replace

    from .dag_rebind import rebind_dag
    from .planner import _split_conjuncts, range_const_of
    from .ranger import (
        handle_ranges_from_intervals,
        index_ranges_from_intervals,
        intervals_for_column,
    )

    plan = entry.plan

    def binder(slot: int):
        k = entry.kinds[slot]
        if k == "i":
            return _relower(int(values[slot]), "i")
        if k == "s":
            return _relower(str(values[slot]), "s")
        raise RebindError(f"slot {slot} kind {k!r} not dag-bindable")

    dag = rebind_dag(plan.dag, binder, values)
    try:
        probe_meta = catalog.table(entry.probe_name)
        builds = [catalog.table(n) for n in entry.build_names]
    except Exception as exc:  # noqa: BLE001 — table dropped between
        raise RebindError(str(exc)) from exc  # validation and bind

    ranges = plan.ranges
    lookup = plan.lookup
    src = entry.range_src
    if src[0] != "full":
        bound_tpl = bind_template(entry.template, values)
        conjs = [c for c in _split_conjuncts(bound_tpl.where)
                 if not isinstance(c, A.SemiJoinCond)]
        col_name = src[2] if len(src) > 2 else src[1]
        cm = probe_meta.col(col_name)
        ivs = intervals_for_column(conjs, cm.name, range_const_of(cm.ft))
        if ivs is None:
            raise RebindError(f"recipe produced no intervals for {col_name!r}")
        if src[0] == "handle":
            ranges = handle_ranges_from_intervals(probe_meta.table_id, ivs)
        elif src[0] == "index":
            ranges = index_ranges_from_intervals(probe_meta.table_id, src[1], ivs)
        elif src[0] == "lookup":
            lookup = (src[1],
                      index_ranges_from_intervals(probe_meta.table_id, src[1], ivs))
            ranges = None
        else:
            raise RebindError(f"unknown range recipe {src[0]!r}")
    return _dc_replace(plan, dag=dag, ranges=ranges, lookup=lookup,
                       probe_table=probe_meta, build_tables=builds)
