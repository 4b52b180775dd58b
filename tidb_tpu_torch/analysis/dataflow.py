"""dataflow — interprocedural passes over an AST-derived project call
graph (ref: golang.org/x/tools/go/analysis facts + the Engler-style
"bugs as deviant behavior" inference the reference leans on via nogo).
Lexical passes see one file at a time, but the bug classes that cost the
most are FLOW properties: a snapshot read
that bypasses `start_ts` three calls below the dispatch loop, a retry
loop whose budget consult lives in a helper, a typed error that crosses
the session boundary unmapped. These need reachability and propagation,
not grep.

Three layers:

  * **CallGraph** — module-qualified resolution of intra-package calls
    (plain functions, methods, nested closures handed to thread pools),
    with lightweight receiver typing from parameter annotations,
    `self.x = Class(...)` constructor assignments and dataclass field
    annotations; an unresolvable receiver falls back to unique-name
    method resolution (exactly one project class defines the method).
  * **TaintAnalysis** — a small forward fact-propagation framework:
    facts seed at the request-path roots and flow through assignments,
    containers (coarse), call arguments and returns to a fixpoint.
  * the three passes:
      dataflow-snapshot      every MVCC read reachable from the request
                             path must flow a `start_ts` (latest-version
                             `kv.get`/`kv.scan` there is a finding)
      dataflow-backoff       request-path retry loops must consult a
                             Backoffer budget; request-path sleeps must
                             be the Backoffer's sliced, deadline-clamped
                             one — never a raw `time.sleep`
      dataflow-error-escape  interprocedural raise/catch reachability:
                             bare RuntimeError/Exception must not escape
                             a request root, and typed request-path
                             errors must be mapped to a SQLError code
                             before crossing the session boundary
                             (supersedes a lexical error-taxonomy)

Roots are the live request-path entry points (distsql select /
select_stream, the TPUStore coprocessor endpoints, TxnEngine.commit);
fixtures declare their own with `# vet: request-path-root` on the def
line and `# vet: session-boundary` for the boundary function. On the live
tree (a file set holding `tidb_tpu_torch/__init__.py`) every catalog root
must resolve to a function of the port: a root that resolves to nothing
is itself a finding, never a silently empty cone.

Copy of `tidb_tpu/analysis/dataflow.py` for the PyTorch port: the package
root is the one constant PKG.
"""

from __future__ import annotations

import ast
import builtins
import os
import re
from dataclasses import dataclass, field

from .common import REPO, Finding, SourceFile

PKG = "tidb_tpu_torch"

PASS_SNAPSHOT = "dataflow-snapshot"
PASS_BACKOFF = "dataflow-backoff"
PASS_ESCAPE = "dataflow-error-escape"

_ROOT_MARK = re.compile(r"#\s*vet:\s*request-path-root")
_BOUNDARY_MARK = re.compile(r"#\s*vet:\s*session-boundary")

# live-tree request-path roots: (rel-suffix, class-or-None, func name).
# These are the MVCC-read / retry-loop paths the snapshot and backoff
# passes police.
REQUEST_ROOTS = (
    ("distsql/dispatch.py", None, "select"),
    ("distsql/dispatch.py", None, "select_stream"),
    ("store/store.py", "TPUStore", "coprocessor"),
    ("store/store.py", "TPUStore", "batch_coprocessor"),
    ("store/store.py", "TPUStore", "coprocessor_bytes"),
    ("store/store.py", "TPUStore", "batch_coprocessor_bytes"),
)
# extra roots for the escape pass only: the write path's typed errors
# (TxnError) must map at the boundary too — but its LEGITIMATE
# latest-version reads (write-conflict checks) are not snapshot reads,
# so the snapshot pass must not police them
ESCAPE_EXTRA_ROOTS = (
    ("store/txn.py", "TxnEngine", "commit"),
)
# CDC entry points: the SQL changefeed statements,
# the /cdc/api/v1 handlers and the sink flush loop are request-path
# roots for the ESCAPE and BACKOFF passes — typed CDC errors must map at
# the boundary and the flush/recovery loops must never spin or raw-sleep.
# NOT snapshot roots: the incremental scans read version RANGES
# (scan_versions), not statement snapshots.
CDC_ROOTS = (
    ("sql/session.py", "Session", "_changefeed"),
    ("server/http_api.py", "StatusServer", "_cdc_route"),
    ("cdc/hub.py", "ChangefeedHub", "tick"),
)
# columnar replica entry points: the engine-routed
# read path, the compaction tick, the apply sink, and the HTTP view are
# ESCAPE and BACKOFF roots — typed staleness must never spin or
# raw-sleep (the data_not_ready wait rides a Backoffer budget) and no
# bare error may escape. NOT snapshot roots: the replica reads typed
# delta/stable layers, never MVCC kv at a latest-version ts.
COLUMNAR_ROOTS = (
    ("columnar/route.py", None, "try_columnar_select"),
    ("columnar/replica.py", "ColumnarReplica", "compact_tick"),
    ("columnar/sink.py", "ColumnarSink", "write"),
    ("server/http_api.py", "StatusServer", "_columnar_route"),
)
# production front door: the admission gate's two entry
# points are ESCAPE and BACKOFF roots — a shed must leave as the typed
# AdmissionShed (mapped to MySQL 9003 at the session boundary) and the
# gate's bounded queue wait must never spin or raw-sleep. The plan-cache
# consult/serve seam is an ESCAPE-only root (below): its cone reaches
# the planner/parser, whose scanning loops are not retry loops — but no
# bare error may escape a cache hit any more than a cold plan. NOT
# snapshot roots: the cache serves templates, never MVCC reads (those
# happen below dispatch, already policed).
FRONT_DOOR_ROOTS = (
    ("server/admission.py", "AdmissionGate", "admit"),
    ("server/admission.py", "AdmissionGate", "before_dispatch"),
)
FRONT_DOOR_ESCAPE_ROOTS = (
    ("sql/session.py", "Session", "_plan_cache_begin"),
)
# Top SQL: the HTTP reporter view and the PD-tick rotation
# are ESCAPE and BACKOFF roots — reporter reads must leave typed (a
# broken window serialization may not 500 as a bare KeyError) and the
# collector's seal path must never spin or raw-sleep under its leaf
# lock. NOT snapshot roots: the collector reads its own ring, never
# MVCC kv.
TOPSQL_ROOTS = (
    ("server/http_api.py", "StatusServer", "_topsql_route"),
    ("topsql/reporter.py", "TopSQLCollector", "rotate"),
)
# MPP dispatch: the fragment coordinator is an ESCAPE and
# BACKOFF root — every decline must be a counted fallback or a typed
# region/staleness error at the boundary (never a bare escape from the
# wire round-trip or the replica readiness gate), and the data_not_ready
# wait it inherits from the columnar path must ride a Backoffer budget.
# NOT a snapshot root: probe scans go through distsql.select / the
# replica's typed layers, both already policed.
MPP_ROOTS = (
    ("mpp/dispatch.py", None, "try_mpp_select"),
)
# cross-session fused execution: the coalescer's two park
# entry points are ESCAPE and BACKOFF roots — a lane must leave with a
# result, a typed error, or a counted fall-out (never a bare escape from
# the batched flush), and the leader/follower waits must be deadline'd
# condition/event waits, never a raw sleep or an unbudgeted spin. NOT
# snapshot roots: the read flush draws ONE window ts and hands it to
# batch_coprocessor, which the snapshot pass already polices.
COALESCE_ROOTS = (
    ("server/coalesce.py", "SessionCoalescer", "point_get"),
    ("server/coalesce.py", "SessionCoalescer", "group_commit"),
)
# point-in-time recovery: the restore replay loop and the
# log-backup flush are ESCAPE and BACKOFF roots — every coverage break
# must leave as the typed LogGapError (mapped to a SQLError at the
# session boundary), a flush failure must park the feed typed (never a
# bare escape from the segment writer), and neither loop may spin or
# raw-sleep. NOT snapshot roots: replay re-ingests at SOURCE commit
# timestamps and the sink buffers raw bytes — neither draws a statement
# snapshot.
PITR_ROOTS = (
    ("br/pitr.py", None, "restore_until"),
    ("br/pitr.py", "LogBackupSink", "flush"),
    ("br/pitr.py", None, "pitr_tick"),
)
SESSION_BOUNDARIES = (("sql/session.py", "Session", "execute"),)

# directories whose exception classes form the "typed request-path error"
# family the boundary check tracks (store region/txn errors, dispatch
# errors, backoff exhaustion, replication faults)
_FAMILY_DIRS = ("distsql", "store", "replication")
_FAMILY_FILES = ("util/backoff.py", "server/admission.py")

# taint facts
REQ = "REQ"  # a request-carrying object (KVRequest/CopRequest/...)
TS = "TS"  # a start_ts snapshot timestamp

_FACT_SEED_PARAMS = {"req": {REQ}, "start_ts": {TS}}


# --------------------------------------------------------------- call graph

@dataclass
class FuncInfo:
    qname: str  # "<rel>::Class.name" / "<rel>::name" / "<rel>::f.<locals>.g"
    rel: str
    cls: str | None
    name: str
    node: ast.AST
    sf: SourceFile
    params: list[str] = field(default_factory=list)
    is_root: bool = False
    is_boundary: bool = False
    # analysis state
    callees: list = field(default_factory=list)  # [(FuncInfo, Call node)]
    callers: list = field(default_factory=list)
    facts: dict = field(default_factory=dict)  # param -> set of facts
    local_facts: dict = field(default_factory=dict)  # name -> facts (post-fixpoint)
    escapes: dict = field(default_factory=dict)  # (type, rel, line) -> True
    consults_backoff: bool = False
    return_facts: set = field(default_factory=set)


@dataclass
class ClassInfo:
    key: tuple  # (rel, name)
    node: ast.ClassDef
    rel: str
    bases: list = field(default_factory=list)  # resolved keys / builtin names
    methods: dict = field(default_factory=dict)  # name -> FuncInfo
    attr_types: dict = field(default_factory=dict)  # attr -> class key


class CallGraph:
    """Project call graph + symbol tables for one file set."""

    def __init__(self, files: list[SourceFile]):
        self.files = [sf for sf in files if sf.tree is not None]
        self.by_rel = {sf.rel: sf for sf in self.files}
        self.module_of = {self._dotted(sf.rel): sf.rel for sf in self.files}
        self.funcs: dict[str, FuncInfo] = {}
        self.classes: dict[tuple, ClassInfo] = {}
        self.mod_funcs: dict[tuple, FuncInfo] = {}  # (rel, name) -> info
        self.imports: dict[str, dict] = {}  # rel -> alias -> ("mod", dotted) | ("sym", dotted, name)
        self.method_index: dict[str, list] = {}  # method name -> [ClassInfo]
        self._collect()
        self._resolve_bases_and_attrs()
        self._build_edges()

    # -- symbol collection --------------------------------------------------
    @staticmethod
    def _dotted(rel: str) -> str:
        mod = rel[:-3].replace(os.sep, ".").replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        return mod

    def _collect(self):
        for sf in self.files:
            self.imports[sf.rel] = self._imports_of(sf)
            for node in sf.tree.body:
                self._collect_node(sf, node, cls=None, prefix="")

    def _collect_node(self, sf, node, cls, prefix):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qname = f"{sf.rel}::{prefix}{node.name}"
            fi = FuncInfo(qname, sf.rel, cls.key[1] if cls else None,
                          node.name, node, sf,
                          params=[a.arg for a in node.args.args])
            line = sf.lines[node.lineno - 1] if node.lineno <= len(sf.lines) else ""
            fi.is_root = bool(_ROOT_MARK.search(line))
            fi.is_boundary = bool(_BOUNDARY_MARK.search(line))
            self.funcs[qname] = fi
            if cls is not None and prefix == f"{cls.key[1]}.":
                cls.methods[node.name] = fi
                self.method_index.setdefault(node.name, []).append(cls)
            elif cls is None and prefix == "":
                self.mod_funcs[(sf.rel, node.name)] = fi
            for sub in ast.walk(node):
                if sub is not node and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    sub_q = f"{sf.rel}::{prefix}{node.name}.<locals>.{sub.name}"
                    if sub_q not in self.funcs:
                        sfi = FuncInfo(sub_q, sf.rel, fi.cls, sub.name, sub, sf,
                                       params=[a.arg for a in sub.args.args])
                        self.funcs[sub_q] = sfi
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo((sf.rel, node.name), node, sf.rel)
            self.classes[ci.key] = ci
            for sub in node.body:
                self._collect_node(sf, sub, cls=ci, prefix=f"{node.name}.")

    def _imports_of(self, sf) -> dict:
        out: dict = {}
        pkg = self._dotted(sf.rel).rsplit(".", 1)[0] if "." in self._dotted(sf.rel) else ""
        is_pkg = sf.rel.endswith("__init__.py")
        self_mod = self._dotted(sf.rel)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = ("mod", a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = self_mod if is_pkg else pkg
                    parts = base.split(".") if base else []
                    if node.level > 1:
                        parts = parts[: len(parts) - (node.level - 1)]
                    base = ".".join(parts)
                    mod = f"{base}.{node.module}" if node.module else base
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = ("sym", mod, a.name)
        return out

    # -- symbol resolution --------------------------------------------------
    def resolve_symbol(self, mod: str, name: str, depth: int = 0):
        """(kind, obj) for `name` exported by dotted module `mod`:
        ("func", FuncInfo) | ("class", ClassInfo) | ("mod", dotted) | None.
        Follows re-exports through package __init__ chains."""
        if depth > 6:
            return None
        sub = self.module_of.get(f"{mod}.{name}")
        if sub:
            return ("mod", f"{mod}.{name}")
        rel = self.module_of.get(mod)
        if rel is None:
            return None
        fi = self.mod_funcs.get((rel, name))
        if fi is not None:
            return ("func", fi)
        ci = self.classes.get((rel, name))
        if ci is not None:
            return ("class", ci)
        imp = self.imports.get(rel, {}).get(name)
        if imp is None:
            return None
        if imp[0] == "mod":
            return ("mod", imp[1])
        return self.resolve_symbol(imp[1], imp[2], depth + 1)

    def resolve_alias(self, rel: str, name: str):
        """Resolve a bare name used in `rel`: local def, then imports."""
        fi = self.mod_funcs.get((rel, name))
        if fi is not None:
            return ("func", fi)
        ci = self.classes.get((rel, name))
        if ci is not None:
            return ("class", ci)
        imp = self.imports.get(rel, {}).get(name)
        if imp is None:
            return None
        if imp[0] == "mod":
            return ("mod", imp[1])
        return self.resolve_symbol(imp[1], imp[2])

    def _resolve_bases_and_attrs(self):
        for ci in self.classes.values():
            for b in ci.node.bases:
                if isinstance(b, ast.Name):
                    r = self.resolve_alias(ci.rel, b.id)
                    ci.bases.append(r[1].key if r and r[0] == "class" else b.id)
                elif isinstance(b, ast.Attribute):
                    ci.bases.append(b.attr)
            # dataclass-style field annotations
            for node in ci.node.body:
                if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                    t = self._annotation_class(ci.rel, node.annotation)
                    if t is not None:
                        ci.attr_types[node.target.id] = t.key
            # `self.x = Class(...)` / `self.x: T = ...` in method bodies
            for m in ci.methods.values():
                for node in ast.walk(m.node):
                    tgt = None
                    val = None
                    if isinstance(node, ast.Assign) and len(node.targets) == 1:
                        tgt, val = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign):
                        tgt, val = node.target, node.value
                    if not (isinstance(tgt, ast.Attribute) and
                            isinstance(tgt.value, ast.Name) and tgt.value.id == "self"):
                        continue
                    if isinstance(node, ast.AnnAssign):
                        t = self._annotation_class(ci.rel, node.annotation)
                        if t is not None:
                            ci.attr_types.setdefault(tgt.attr, t.key)
                            continue
                    if isinstance(val, ast.Call) and isinstance(val.func, ast.Name):
                        r = self.resolve_alias(ci.rel, val.func.id)
                        if r and r[0] == "class":
                            ci.attr_types.setdefault(tgt.attr, r[1].key)

    def _annotation_class(self, rel: str, ann) -> ClassInfo | None:
        name = None
        if isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().split("|")[0].strip()
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        elif isinstance(ann, ast.BinOp):  # "X | None"
            return self._annotation_class(rel, ann.left)
        if not name:
            return None
        r = self.resolve_alias(rel, name)
        if r and r[0] == "class":
            return r[1]
        # annotation naming a class defined elsewhere in the project
        for ci in self.method_index.get("__init__", []):
            if ci.key[1] == name:
                return ci
        hits = [ci for ci in self.classes.values() if ci.key[1] == name]
        return hits[0] if len(hits) == 1 else None

    def class_method(self, ci: ClassInfo, name: str) -> FuncInfo | None:
        seen = set()
        stack = [ci]
        while stack:
            c = stack.pop()
            if c.key in seen:
                continue
            seen.add(c.key)
            m = c.methods.get(name)
            if m is not None:
                return m
            for b in c.bases:
                if isinstance(b, tuple) and b in self.classes:
                    stack.append(self.classes[b])
        return None

    # -- receiver typing ----------------------------------------------------
    def _scope_types(self, fi: FuncInfo) -> dict:
        """name -> ClassInfo key for the function's locals/params."""
        types: dict = {}
        if fi.cls is not None and fi.params and fi.params[0] == "self":
            types["self"] = (fi.rel, fi.cls)
        for a in fi.node.args.args + fi.node.args.kwonlyargs:
            if a.annotation is not None:
                t = self._annotation_class(fi.rel, a.annotation)
                if t is not None:
                    types[a.arg] = t.key
        for node in ast.walk(fi.node):
            tgt = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                t = self.expr_type(node.value, fi, types)
                if t is not None:
                    types.setdefault(tgt, t)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                t = self._annotation_class(fi.rel, node.annotation)
                if t is not None:
                    types.setdefault(node.target.id, t.key)
        return types

    def expr_type(self, expr, fi: FuncInfo, types: dict):
        """Best-effort static type (a ClassInfo key) of an expression."""
        if isinstance(expr, ast.Name):
            return types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.expr_type(expr.value, fi, types)
            if base is not None and base in self.classes:
                return self.classes[base].attr_types.get(expr.attr)
            return None
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name):
                if expr.func.id == "getattr" and len(expr.args) >= 2 \
                        and isinstance(expr.args[1], ast.Constant):
                    base = self.expr_type(expr.args[0], fi, types)
                    if base is not None and base in self.classes:
                        return self.classes[base].attr_types.get(expr.args[1].value)
                    return None
                r = self.resolve_alias(fi.rel, expr.func.id)
                if r and r[0] == "class":
                    return r[1].key
        return None

    # -- edges --------------------------------------------------------------
    def _build_edges(self):
        for fi in self.funcs.values():
            types = self._scope_types(fi)
            fi._types = types  # reused by the passes
            fi._call_map = {}  # id(Call) -> FuncInfo, for the fact engine
            local_defs = {}
            parent = fi.node
            for sub in ast.walk(parent):
                if sub is not parent and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = self._local_qname(fi, sub.name)
                    if q in self.funcs:
                        local_defs[sub.name] = self.funcs[q]
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve_call(node, fi, types, local_defs)
                if callee is not None:
                    fi.callees.append((callee, node))
                    callee.callers.append(fi)
                    fi._call_map.setdefault(id(node), callee)
                # callbacks: a known function handed as an argument is
                # assumed invoked (pool.submit(run_task, ...), Thread target)
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Name):
                        cb = local_defs.get(arg.id)
                        if cb is None:
                            r = self.resolve_alias(fi.rel, arg.id)
                            cb = r[1] if r and r[0] == "func" else None
                        if cb is not None:
                            fi.callees.append((cb, node))
                            cb.callers.append(fi)

    def _local_qname(self, fi: FuncInfo, name: str) -> str:
        base = fi.qname.split("::", 1)[1]
        return f"{fi.rel}::{base}.<locals>.{name}"

    def resolve_call(self, call: ast.Call, fi: FuncInfo, types: dict,
                     local_defs: dict) -> FuncInfo | None:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in local_defs:
                return local_defs[f.id]
            r = self.resolve_alias(fi.rel, f.id)
            if r is None:
                return None
            if r[0] == "func":
                return r[1]
            if r[0] == "class":
                return self.class_method(r[1], "__init__")
            return None
        if isinstance(f, ast.Attribute):
            # module-attr call: dispatch.select(...)
            if isinstance(f.value, ast.Name):
                r = self.resolve_alias(fi.rel, f.value.id)
                if r and r[0] == "mod":
                    s = self.resolve_symbol(r[1], f.attr)
                    if s and s[0] == "func":
                        return s[1]
                    if s and s[0] == "class":
                        return self.class_method(s[1], "__init__")
                    return None
            t = self.expr_type(f.value, fi, types)
            if t is not None and t in self.classes:
                m = self.class_method(self.classes[t], f.attr)
                if m is not None:
                    return m
            # unique-name fallback: exactly one project class defines it
            owners = self.method_index.get(f.attr, ())
            if len(owners) == 1:
                return owners[0].methods[f.attr]
        return None

    # -- roots / reachability ----------------------------------------------
    def request_roots(self, extra=()) -> list[FuncInfo]:
        specs = tuple(REQUEST_ROOTS) + tuple(extra)
        out = []
        for fi in self.funcs.values():
            if fi.is_root:
                out.append(fi)
                continue
            for suffix, cls, name in specs:
                if fi.rel.endswith(suffix) and fi.name == name and fi.cls == cls:
                    out.append(fi)
        return out

    def boundaries(self) -> list[FuncInfo]:
        out = []
        for fi in self.funcs.values():
            if fi.is_boundary:
                out.append(fi)
                continue
            for suffix, cls, name in SESSION_BOUNDARIES:
                if fi.rel.endswith(suffix) and fi.name == name and fi.cls == cls:
                    out.append(fi)
        return out

    def reachable(self, roots) -> set:
        seen = set()
        stack = list(roots)
        while stack:
            fi = stack.pop()
            if fi.qname in seen:
                continue
            seen.add(fi.qname)
            for callee, _node in fi.callees:
                if callee.qname not in seen:
                    stack.append(callee)
        return seen


_GRAPH_MEMO: dict = {}


def graph_for(files: list[SourceFile]) -> CallGraph:
    """One CallGraph per distinct file-set revision — the three dataflow
    passes share it (building it is the expensive part)."""
    key = tuple(sorted((sf.rel, sf.sha) for sf in files))
    g = _GRAPH_MEMO.get(key)
    if g is None:
        _GRAPH_MEMO.clear()  # one live tree at a time; fixtures are tiny
        g = _GRAPH_MEMO[key] = CallGraph(files)
    return g


def _catalog_line(suffix: str, cls, name: str) -> int:
    """Line of a root's catalog entry in this module (1 when absent)."""
    cls_src = "None" if cls is None else f'"{cls}"'
    want = f'("{suffix}", {cls_src}, "{name}")'
    try:
        with open(__file__, encoding="utf-8") as f:
            for ln, text in enumerate(f, 1):
                if want in text:
                    return ln
    except OSError:
        pass
    return 1


def unresolved_roots(graph: CallGraph, passname: str, catalogs: dict) -> list:
    """Findings for catalog roots that resolve to no function of the live
    tree (`catalogs`: catalog name -> root specs). A renamed seam would
    otherwise leave an empty cone and the pass would pass vacuously. Only
    the live tree is held to the catalogs: a fixture file set declares its
    own roots with markers."""
    rels = {sf.rel.replace(os.sep, "/") for sf in graph.files}
    if f"{PKG}/__init__.py" not in rels:
        return []
    here = os.path.relpath(os.path.abspath(__file__), REPO)
    findings: list = []
    for cat, specs in catalogs.items():
        for suffix, cls, name in specs:
            if any(fi.rel.replace(os.sep, "/").endswith(suffix) and fi.name == name and fi.cls == cls
                   for fi in graph.funcs.values()):
                continue
            where = f"{cls}.{name}" if cls else name
            findings.append(Finding(
                here, _catalog_line(suffix, cls, name), passname,
                f"{cat} root {suffix}::{where} resolves to no function under {PKG}/ — its "
                f"cone would be empty and the pass would pass vacuously; point the "
                f"catalog entry at the port's seam"))
    return findings


# ------------------------------------------------------- taint propagation

class TaintAnalysis:
    """Forward fact propagation from the request roots: REQ (request
    object) and TS (start_ts) flow through assignments, containers
    (coarse: a container holding a tainted value is tainted), attribute
    projection (`req.start_ts` -> TS) and call argument/return edges to a
    fixpoint."""

    def __init__(self, graph: CallGraph):
        self.g = graph
        roots = graph.request_roots()
        for fi in roots:
            for p in fi.params:
                seeded = set(_FACT_SEED_PARAMS.get(p, ()))
                t = fi._types.get(p)
                if t is not None and t[1].endswith("Request"):
                    seeded.add(REQ)
                if seeded:
                    fi.facts.setdefault(p, set()).update(seeded)
        # facts can only matter inside the request-path cone: every
        # reachable function gets analyzed at least once (so reachable
        # code has local_facts even before any taint arrives); changed
        # callees re-enter the worklist until the fixpoint
        reach = graph.reachable(roots)
        self._fixpoint([graph.funcs[q] for q in sorted(reach)])

    def _fixpoint(self, work: list):
        seen_rounds = 0
        while work and seen_rounds < 20000:
            seen_rounds += 1
            fi = work.pop()
            changed_callees = self._analyze(fi)
            work.extend(changed_callees)

    def _analyze(self, fi: FuncInfo) -> list:
        t = {p: set(fs) for p, fs in fi.facts.items()}
        for _ in range(2):  # loops: one extra sweep covers backward deps
            before = {k: set(v) for k, v in t.items()}
            self._walk_stmts(fi.node.body if hasattr(fi.node, "body") else [], fi, t)
            if t == before:
                break
        fi.local_facts = t
        # returns (a growing return-fact set re-queues the callers)
        rets = getattr(fi, "_returns", None)
        if rets is None:
            rets = fi._returns = [n.value for n in ast.walk(fi.node)
                                  if isinstance(n, ast.Return) and n.value is not None]
        ret: set = set()
        for value in rets:
            ret |= self.expr_facts(value, fi, t)
        changed = []
        if ret - fi.return_facts:
            fi.return_facts |= ret
            changed.extend(fi.callers)
        # propagate to callees
        for callee, call in fi.callees:
            if self._flow_call(fi, callee, call, t):
                changed.append(callee)
        return changed

    def _walk_stmts(self, stmts, fi, t):
        for node in stmts:
            if isinstance(node, ast.Assign):
                fx = self.expr_facts(node.value, fi, t)
                for tgt in node.targets:
                    self._bind(tgt, fx, t)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._bind(node.target, self.expr_facts(node.value, fi, t), t)
            elif isinstance(node, ast.AugAssign):
                fx = self.expr_facts(node.value, fi, t)
                self._bind(node.target, fx | self.expr_facts(node.target, fi, t), t)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                self._bind(node.target, self.expr_facts(node.iter, fi, t), t)
                self._walk_stmts(node.body, fi, t)
                self._walk_stmts(node.orelse, fi, t)
            elif isinstance(node, ast.While):
                self._walk_stmts(node.body, fi, t)
                self._walk_stmts(node.orelse, fi, t)
            elif isinstance(node, ast.If):
                self._walk_stmts(node.body, fi, t)
                self._walk_stmts(node.orelse, fi, t)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars,
                                   self.expr_facts(item.context_expr, fi, t), t)
                self._walk_stmts(node.body, fi, t)
            elif isinstance(node, ast.Try):
                self._walk_stmts(node.body, fi, t)
                for h in node.handlers:
                    self._walk_stmts(h.body, fi, t)
                self._walk_stmts(node.orelse, fi, t)
                self._walk_stmts(node.finalbody, fi, t)
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                # container mutation: L.append(x) / L.extend(x) / d.setdefault(...)
                call = node.value
                if isinstance(call.func, ast.Attribute) and call.func.attr in (
                        "append", "extend", "add", "insert", "setdefault", "update"):
                    fx = set()
                    for a in call.args:
                        fx |= self.expr_facts(a, fi, t)
                    root = call.func.value
                    while isinstance(root, (ast.Attribute, ast.Call, ast.Subscript)):
                        root = getattr(root, "value", None) or getattr(root, "func", None)
                        if root is None:
                            break
                    if isinstance(root, ast.Name) and fx:
                        t.setdefault(root.id, set()).update(fx)

    def _bind(self, tgt, fx: set, t: dict):
        if isinstance(tgt, ast.Name):
            if fx:
                t.setdefault(tgt.id, set()).update(fx)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._bind(e, fx, t)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, fx, t)

    def expr_facts(self, expr, fi, t) -> set:
        if isinstance(expr, ast.Name):
            return set(t.get(expr.id, ()))
        if isinstance(expr, ast.Attribute):
            base = self.expr_facts(expr.value, fi, t)
            if REQ in base and expr.attr == "start_ts":
                return base | {TS}
            return base
        if isinstance(expr, ast.Call):
            # resolved project call: constructor re-wraps, function returns
            callee = getattr(fi, "_call_map", {}).get(id(expr))
            arg_facts: set = set()
            for a in list(expr.args) + [k.value for k in expr.keywords]:
                arg_facts |= self.expr_facts(a, fi, t)
            if callee is not None and callee.name == "__init__" and arg_facts:
                return {REQ} if (REQ in arg_facts or TS in arg_facts) else set()
            if callee is not None:
                return set(callee.return_facts)
            # unresolved: coarse — taint of receiver and args flows through
            out = set(arg_facts)
            if isinstance(expr.func, ast.Attribute):
                out |= self.expr_facts(expr.func.value, fi, t)
            return out
        out: set = set()
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, (ast.expr, ast.keyword)):
                sub = child.value if isinstance(child, ast.keyword) else child
                out |= self.expr_facts(sub, fi, t)
        return out

    def _flow_call(self, fi, callee, call, t) -> bool:
        params = list(callee.params)
        if params and params[0] == "self" and not (
                isinstance(call.func, ast.Name) and call.func.id == callee.name):
            params = params[1:]
        changed = False
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred) or i >= len(params):
                break
            fx = self.expr_facts(a, fi, t)
            if fx - callee.facts.get(params[i], set()):
                callee.facts.setdefault(params[i], set()).update(fx)
                changed = True
        for kw in call.keywords:
            if kw.arg is None or kw.arg not in callee.params:
                continue
            fx = self.expr_facts(kw.value, fi, t)
            if fx - callee.facts.get(kw.arg, set()):
                callee.facts.setdefault(kw.arg, set()).update(fx)
                changed = True
        return changed


# ------------------------------------------------------- pass: snapshot

_LATEST_CALLS = {"max_ts", "next_ts", "max_committed", "latest_ts"}


def _walk_own(root):
    """ast.walk, but nested def bodies stay out: they are separate
    FuncInfos walked on their own — re-walking them from the parent
    would double-report every finding inside a closure. Lambdas are NOT
    FuncInfos, so their bodies stay in."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def _closure_facts(graph: CallGraph, fi: FuncInfo) -> dict:
    """The function's fact map, with the enclosing function's facts as a
    fallback for closures (captured names carry the parent's taint)."""
    t = dict(fi.local_facts)
    if ".<locals>." in fi.qname:
        parent_q = fi.qname.rsplit(".<locals>.", 1)[0]
        parent = graph.funcs.get(parent_q)
        if parent is not None:
            for k, v in parent.local_facts.items():
                t.setdefault(k, v)
    return t


def _is_kv_receiver(graph, expr, fi, types) -> bool:
    """Receiver is the MVCC engine: typed as a class named MemKV, or a
    syntactic `.kv` attribute chain (fixtures without full typing)."""
    t = graph.expr_type(expr, fi, types)
    if t is not None and t[1] == "MemKV":
        return True
    if isinstance(expr, ast.Attribute) and expr.attr == "kv":
        return True
    return isinstance(expr, ast.Name) and expr.id == "kv"


def _ts_argument(call: ast.Call, method: str):
    idx = {"get": 1, "scan": 2}[method]
    for kw in call.keywords:
        if kw.arg == "ts":
            return kw.value
    if len(call.args) > idx:
        a = call.args[idx]
        return None if isinstance(a, ast.Starred) else a
    return None


def _is_latest_version_expr(expr, graph, fi) -> bool:
    """ts argument that structurally means "newest version": a literal,
    a *_MAX_* constant, or a max_ts()/next_ts()-style oracle call."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Name) and ("MAX" in expr.id.upper() or expr.id.isupper()):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        return name in _LATEST_CALLS
    return False


def run_snapshot(files: list[SourceFile]) -> list:
    graph = graph_for(files)
    unresolved = unresolved_roots(graph, PASS_SNAPSHOT, {"REQUEST_ROOTS": REQUEST_ROOTS})
    roots = graph.request_roots()
    if not roots:
        return unresolved
    taint = TaintAnalysis(graph)
    reachable = graph.reachable(roots)
    findings: list = []
    for qname in sorted(reachable):
        fi = graph.funcs[qname]
        if os.sep + "analysis" + os.sep in fi.rel or "/analysis/" in fi.rel:
            continue
        types = fi._types
        t = _closure_facts(graph, fi)
        for node in _walk_own(fi.node):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            meth = node.func.attr
            if meth in ("max_ts", "latest_ts") and _is_kv_receiver(
                    graph, node.func.value, fi, types):
                findings.append(Finding(
                    fi.rel, node.lineno, PASS_SNAPSHOT,
                    f"`{meth}()` on a request path reads the NEWEST version, not the "
                    f"statement snapshot — MVCC reads reachable from dispatch must "
                    f"flow the request's start_ts"))
                continue
            if meth not in ("get", "scan") or not _is_kv_receiver(
                    graph, node.func.value, fi, types):
                continue
            ts_arg = _ts_argument(node, meth)
            if ts_arg is None:
                findings.append(Finding(
                    fi.rel, node.lineno, PASS_SNAPSHOT,
                    f"`kv.{meth}` on a request path without a snapshot ts — every "
                    f"MVCC read reachable from dispatch must flow the request's start_ts"))
                continue
            if _is_latest_version_expr(ts_arg, graph, fi):
                findings.append(Finding(
                    fi.rel, node.lineno, PASS_SNAPSHOT,
                    f"`kv.{meth}` on a request path reads at a latest-version ts "
                    f"({ast.unparse(ts_arg)}) — a raw newest-version read bypasses "
                    f"the statement snapshot; flow the request's start_ts instead"))
                continue
            if not (taint.expr_facts(ts_arg, fi, t) & {TS, REQ}):
                findings.append(Finding(
                    fi.rel, node.lineno, PASS_SNAPSHOT,
                    f"`kv.{meth}` ts argument `{ast.unparse(ts_arg)}` does not flow "
                    f"from the request's start_ts (no REQ/TS fact reaches it) — "
                    f"snapshot discipline broken on a request path"))
    return unresolved + findings


# ------------------------------------------------------- pass: backoff

def _consults_backoff_directly(fi: FuncInfo, node=None) -> bool:
    scope = node if node is not None else fi.node
    for sub in ast.walk(scope):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if sub.func.attr in ("backoff", "sleep"):
                recv = sub.func.value
                name = recv.id if isinstance(recv, ast.Name) else \
                    recv.attr if isinstance(recv, ast.Attribute) else ""
                if "boff" in name or "backoff" in name:
                    return True
        if isinstance(sub, ast.Raise) and isinstance(sub.exc, ast.Call) \
                and isinstance(sub.exc.func, ast.Name) \
                and "Backoff" in sub.exc.func.id:
            return True
    return False


def _compute_backoff_consulters(graph: CallGraph) -> None:
    for fi in graph.funcs.values():
        fi.consults_backoff = _consults_backoff_directly(fi)
    changed = True
    while changed:
        changed = False
        for fi in graph.funcs.values():
            if fi.consults_backoff:
                continue
            if any(c.consults_backoff for c, _ in fi.callees):
                fi.consults_backoff = True
                changed = True


def _is_retry_loop(loop: ast.While) -> bool:
    """An UNBOUNDED re-attempt loop: `while True:` (or another constant-
    true test) that `continue`s back around. A `while i < n:` walk with a
    continue is an iteration idiom, not a retry — and a bounded retry
    loop consumes its attempt budget by construction."""
    t = loop.test
    unbounded = isinstance(t, ast.Constant) and bool(t.value)
    return unbounded and _loop_has_continue(loop)


def _loop_has_continue(loop: ast.While) -> bool:
    """Continue belonging to THIS loop (nested loops own their own)."""
    def walk(stmts):
        for node in stmts:
            if isinstance(node, ast.Continue):
                return True
            if isinstance(node, (ast.While, ast.For, ast.AsyncFor,
                                 ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for attr in ("body", "orelse", "finalbody"):
                if walk(getattr(node, attr, [])):
                    return True
            if isinstance(node, ast.Try) and any(walk(h.body) for h in node.handlers):
                return True
        return False
    return walk(loop.body)


def _loop_consults_budget(graph, fi, loop) -> bool:
    if _consults_backoff_directly(fi, loop):
        return True
    calls_in_loop = {id(c) for c in ast.walk(loop) if isinstance(c, ast.Call)}
    for callee, call in fi.callees:
        if id(call) in calls_in_loop and callee.consults_backoff:
            return True
    return False


def _is_time_sleep(call: ast.Call, graph: CallGraph, fi: FuncInfo) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "sleep" and isinstance(f.value, ast.Name):
        imp = graph.imports.get(fi.rel, {}).get(f.value.id)
        return bool(imp and imp[0] == "mod" and imp[1] == "time")
    if isinstance(f, ast.Name) and f.id == "sleep":
        imp = graph.imports.get(fi.rel, {}).get("sleep")
        return bool(imp and imp[0] == "sym" and imp[1] == "time")
    return False


_BACKOFF_CATALOGS = {
    "REQUEST_ROOTS": REQUEST_ROOTS, "CDC_ROOTS": CDC_ROOTS, "COLUMNAR_ROOTS": COLUMNAR_ROOTS,
    "FRONT_DOOR_ROOTS": FRONT_DOOR_ROOTS, "TOPSQL_ROOTS": TOPSQL_ROOTS, "MPP_ROOTS": MPP_ROOTS,
    "PITR_ROOTS": PITR_ROOTS,
}


def run_backoff(files: list[SourceFile]) -> list:
    graph = graph_for(files)
    findings: list = unresolved_roots(graph, PASS_BACKOFF, _BACKOFF_CATALOGS)
    roots = graph.request_roots(extra=CDC_ROOTS + COLUMNAR_ROOTS + FRONT_DOOR_ROOTS + TOPSQL_ROOTS + MPP_ROOTS + PITR_ROOTS)
    if not roots:
        return findings
    _compute_backoff_consulters(graph)
    reachable = graph.reachable(roots)
    for qname in sorted(reachable):
        fi = graph.funcs[qname]
        if fi.rel.endswith(os.path.join("util", "backoff.py")) or \
                fi.rel.endswith("util/backoff.py"):
            continue  # the Backoffer IS the sliced/clamped sleep primitive
        for node in _walk_own(fi.node):
            if isinstance(node, ast.While) and _is_retry_loop(node):
                if not _loop_consults_budget(graph, fi, node):
                    findings.append(Finding(
                        fi.rel, node.lineno, PASS_BACKOFF,
                        "retry loop on a request path never consults a Backoffer "
                        "budget — a persistent fault spins this loop forever "
                        "instead of surfacing a typed RegionUnavailableError"))
            elif isinstance(node, ast.Call) and _is_time_sleep(node, graph, fi):
                findings.append(Finding(
                    fi.rel, node.lineno, PASS_BACKOFF,
                    "raw time.sleep on a request path — sleeps must ride "
                    "Backoffer.sleep (sliced for KILL QUERY, clamped to the "
                    "statement deadline, attributed to backoff metrics)"))
    return findings


# ------------------------------------------------- pass: error escape

_BARE_RAISES = {"RuntimeError", "Exception"}


def _builtin_exc(name: str):
    obj = getattr(builtins, name, None)
    return obj if isinstance(obj, type) and issubclass(obj, BaseException) else None


class EscapeAnalysis:
    """Per-function escaping exception sets to a fixpoint: a raise (or a
    callee's escape) survives the enclosing handler stack unless a
    handler absorbs it; a handler whose body ends in a TOP-LEVEL bare
    `raise` re-raises, so it is transparent (the session.execute shape:
    catch Exception, map the typed ones, re-raise the rest)."""

    def __init__(self, graph: CallGraph):
        self.g = graph
        self._sub_memo: dict = {}
        # escape only matters in the cone of the roots and the boundary
        reach = graph.reachable(
            graph.request_roots(extra=ESCAPE_EXTRA_ROOTS + CDC_ROOTS + COLUMNAR_ROOTS + FRONT_DOOR_ROOTS + FRONT_DOOR_ESCAPE_ROOTS + TOPSQL_ROOTS + MPP_ROOTS + COALESCE_ROOTS + PITR_ROOTS)
            + graph.boundaries())
        work = [graph.funcs[q] for q in sorted(reach)]
        rounds = 0
        while work and rounds < 20000:
            rounds += 1
            fi = work.pop()
            if self._analyze(fi):
                work.extend(c for c in fi.callers)

    # -- type lattice -------------------------------------------------------
    def exc_class(self, rel: str, expr):
        """Resolve a raise/handler type expression to a ClassInfo key or
        a builtin exception name."""
        name = None
        if isinstance(expr, ast.Call):
            expr = expr.func
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute):
            name = expr.attr
        if name is None:
            return None
        r = self.g.resolve_alias(rel, name)
        if r and r[0] == "class":
            return r[1].key
        if _builtin_exc(name) is not None:
            return name
        hits = [ci for ci in self.g.classes.values() if ci.key[1] == name]
        return hits[0].key if len(hits) == 1 else name

    def _bases_of(self, t):
        if isinstance(t, tuple):
            ci = self.g.classes.get(t)
            return ci.bases if ci else []
        b = _builtin_exc(t)
        return [b.__bases__[0].__name__] if b and b.__bases__ else []

    def is_subtype(self, t, handler) -> bool:
        memo_key = (t, handler)
        hit = self._sub_memo.get(memo_key)
        if hit is not None:
            return hit
        r = self._is_subtype(t, handler)
        self._sub_memo[memo_key] = r
        return r

    def _is_subtype(self, t, handler) -> bool:
        if handler is None:
            return True  # bare except
        if isinstance(handler, str) and _builtin_exc(handler) in (Exception, BaseException):
            return True
        seen = set()
        stack = [t]
        while stack:
            cur = stack.pop()
            key = cur if isinstance(cur, str) else cur
            if key in seen:
                continue
            seen.add(key)
            if cur == handler:
                return True
            if isinstance(cur, str) and isinstance(handler, str):
                a, b = _builtin_exc(cur), _builtin_exc(handler)
                if a is not None and b is not None and issubclass(a, b):
                    return True
            stack.extend(self._bases_of(cur))
        return False

    # -- per-function -------------------------------------------------------
    @staticmethod
    def _handler_transparent(handler: ast.ExceptHandler) -> bool:
        """Top-level unconditional bare `raise` in the handler body
        re-raises what it caught; a CONDITIONAL bare raise (the
        cop-debug-raise gate shape) is a deliberate opt-in, treated as
        absorbing."""
        return any(isinstance(s, ast.Raise) and s.exc is None for s in handler.body)

    def _survives(self, t, handler_stack) -> bool:
        """Walk the enclosing trys innermost-out: the first handler per
        level that matches either absorbs (done) or — if transparent —
        re-raises to the NEXT outer level."""
        for handlers in reversed(handler_stack):
            for h in handlers:
                if h.type is None:
                    types = [None]
                elif isinstance(h.type, ast.Tuple):
                    types = list(h.type.elts)
                else:
                    types = [h.type]
                matched = False
                for ht in types:
                    hk = None if ht is None else self.exc_class(self._rel, ht)
                    if hk is None and ht is not None:
                        continue
                    if self.is_subtype(t, hk):
                        matched = True
                        break
                if matched:
                    if self._handler_transparent(h):
                        break  # re-raised: continue to the outer level
                    return False  # absorbed
            # no handler at this level caught it (or it was re-raised)
        return True

    def _prepare(self, fi: FuncInfo) -> list:
        """One-time site extraction: every raise and every resolved call,
        each with its (static) enclosing handler stack. Re-analysis then
        never touches the AST again — it just re-filters callee escape
        sets through the precomputed stacks."""
        callees_at: dict = {}
        for callee, call in fi.callees:
            callees_at.setdefault(id(call), []).append(callee)
        sites: list = []

        def calls_in(expr, stack):
            if expr is None:
                return
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call):
                    for callee in callees_at.get(id(sub), ()):
                        sites.append(("call", callee, None, 0, stack))

        def walk(stmts, stack):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(node, ast.Raise):
                    if node.exc is not None:
                        t = self.exc_class(fi.rel, node.exc)
                        if t is not None:
                            sites.append(("raise", t, fi.rel, node.lineno, stack))
                        calls_in(node.exc, stack)
                elif isinstance(node, ast.Try):
                    walk(node.body, stack + (node.handlers,))
                    for h in node.handlers:
                        walk(h.body, stack)
                    walk(node.orelse, stack)  # orelse escapes bypass the handlers
                    walk(node.finalbody, stack)
                elif isinstance(node, ast.If):
                    calls_in(node.test, stack)
                    walk(node.body, stack)
                    walk(node.orelse, stack)
                elif isinstance(node, ast.While):
                    calls_in(node.test, stack)
                    walk(node.body, stack)
                    walk(node.orelse, stack)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    calls_in(node.iter, stack)
                    walk(node.body, stack)
                    walk(node.orelse, stack)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        calls_in(item.context_expr, stack)
                    walk(node.body, stack)
                else:
                    calls_in(node, stack)

        walk(fi.node.body, ())
        return sites

    def _analyze(self, fi: FuncInfo) -> bool:
        """Escape sets are deduplicated per exception TYPE: one
        representative origin site rides along for the report (keeps the
        fixpoint linear in #types instead of #raise-sites)."""
        self._rel = fi.rel
        sites = getattr(fi, "_esc_sites", None)
        if sites is None:
            sites = fi._esc_sites = self._prepare(fi)
        memo = getattr(fi, "_survive_memo", None)
        if memo is None:
            memo = fi._survive_memo = {}
        out: dict = {}
        for kind, payload, rel, line, stack in sites:
            if kind == "raise":
                if payload not in out:
                    key = (payload, id(stack))
                    ok = memo.get(key)
                    if ok is None:
                        ok = memo[key] = self._survives(payload, stack)
                    if ok:
                        out[payload] = (rel, line)
            else:
                for t, site in payload.escapes.items():
                    if t not in out:
                        key = (t, id(stack))
                        ok = memo.get(key)
                        if ok is None:
                            ok = memo[key] = self._survives(t, stack)
                        if ok:
                            out[t] = site
        if set(out) - set(fi.escapes):
            for t, site in out.items():
                fi.escapes.setdefault(t, site)
            return True
        return False


def _family_classes(graph: CallGraph) -> set:
    """Typed request-path error classes: Exception subclasses defined in
    the dispatch/store/replication/backoff layers (live tree), or any
    project exception class in a fixture file set."""
    fam: set = set()
    # "tidb_tpu_torch/", never a bare prefix: "tidb_tpu" also matches the
    # JAX package's own tree
    live = any(sf.rel.replace(os.sep, "/").startswith(PKG + "/") for sf in graph.files)
    for key, ci in graph.classes.items():
        # exception-ness: transitively rooted in a builtin exception
        stack, seen, is_exc = [key], set(), False
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if isinstance(cur, str) and _builtin_exc(cur) is not None:
                is_exc = True
                break
            if isinstance(cur, tuple) and cur in graph.classes:
                stack.extend(graph.classes[cur].bases)
        if not is_exc:
            continue
        rel = ci.rel.replace(os.sep, "/")
        in_family = any(f"{PKG}/{d}/" in rel for d in _FAMILY_DIRS) or \
            any(rel.endswith(f) for f in _FAMILY_FILES)
        if in_family or not live:
            fam.add(key)
    return fam


def _mapped_types(graph: CallGraph, boundary: FuncInfo) -> set:
    """Exception type NAMES the boundary module maps to SQLError: except
    handlers whose body raises SQLError, and isinstance(exc, T) branches
    doing the same."""
    sf = graph.by_rel.get(boundary.rel)
    mapped: set = set()
    if sf is None or sf.tree is None:
        return mapped

    def names_of(expr):
        if isinstance(expr, ast.Name):
            return [expr.id]
        if isinstance(expr, ast.Attribute):
            return [expr.attr]
        if isinstance(expr, ast.Tuple):
            return [n for e in expr.elts for n in names_of(e)]
        return []

    def raises_sqlerror(stmts) -> bool:
        for s in stmts:
            for sub in ast.walk(s):
                if isinstance(sub, ast.Raise) and isinstance(sub.exc, ast.Call) \
                        and isinstance(sub.exc.func, ast.Name) \
                        and sub.exc.func.id == "SQLError":
                    return True
        return False

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is not None:
            if raises_sqlerror(node.body):
                mapped.update(names_of(node.type))
        elif isinstance(node, ast.If):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                        and sub.func.id == "isinstance" and len(sub.args) == 2:
                    if raises_sqlerror(node.body):
                        mapped.update(names_of(sub.args[1]))
    return mapped


_ESCAPE_CATALOGS = {
    **_BACKOFF_CATALOGS, "ESCAPE_EXTRA_ROOTS": ESCAPE_EXTRA_ROOTS,
    "FRONT_DOOR_ESCAPE_ROOTS": FRONT_DOOR_ESCAPE_ROOTS, "COALESCE_ROOTS": COALESCE_ROOTS,
    "SESSION_BOUNDARIES": SESSION_BOUNDARIES,
}
ROOT_CATALOGS = _ESCAPE_CATALOGS  # every catalog: the resolution test reads it


def run_escape(files: list[SourceFile]) -> list:
    graph = graph_for(files)
    findings: list = unresolved_roots(graph, PASS_ESCAPE, _ESCAPE_CATALOGS)
    roots = graph.request_roots(extra=ESCAPE_EXTRA_ROOTS + CDC_ROOTS + COLUMNAR_ROOTS + FRONT_DOOR_ROOTS + FRONT_DOOR_ESCAPE_ROOTS + TOPSQL_ROOTS + MPP_ROOTS + COALESCE_ROOTS + PITR_ROOTS)
    boundaries = graph.boundaries()
    if not roots and not boundaries:
        return findings
    esc = EscapeAnalysis(graph)
    seen: set = set()
    # (a) bare RuntimeError/Exception escaping a request root
    for fi in roots:
        for t, (rel, line) in sorted(fi.escapes.items(), key=str):
            if isinstance(t, str) and t in _BARE_RAISES and (rel, line) not in seen:
                seen.add((rel, line))
                findings.append(Finding(
                    rel, line, PASS_ESCAPE,
                    f"bare `raise {t}` escapes the request path uncaught (reaches "
                    f"{fi.name}) — use a typed error from store/errors.py or a "
                    f"subsystem exception with a MySQL code mapping so dispatch "
                    f"can classify, back off and account it"))
    # (b) typed family errors escaping the session boundary unmapped. A
    # handler/isinstance mapping of a BASE class covers its subclasses
    # (except TxnError absorbs KeyIsLocked).
    fam = _family_classes(graph)
    for b in boundaries:
        mapped = _mapped_types(graph, b)
        for t, (rel, line) in sorted(b.escapes.items(), key=str):
            if not isinstance(t, tuple) or t not in fam:
                continue
            name = t[1]
            covered = name in mapped or any(
                esc.is_subtype(t, m) for m in
                (esc.exc_class(b.rel, ast.Name(id=mn)) for mn in mapped) if m)
            if name == "SQLError" or covered or (rel, line, name) in seen:
                continue
            seen.add((rel, line, name))
            findings.append(Finding(
                rel, line, PASS_ESCAPE,
                f"typed error {name} (raised here) escapes the session boundary "
                f"{b.name}() with no SQLError mapping — add an except/isinstance "
                f"mapping with a MySQL error code before it reaches the client"))
    # (c) the lexical floor the old error-taxonomy pass provided: bare
    # RuntimeError/Exception raises in the dispatch/store/PD layers are
    # findings even OUTSIDE the request cone (control-plane code — PD
    # ticks, schedulers — still deserves typed errors; interprocedural
    # reachability must narrow nothing the lexical rule guaranteed)
    for sf in graph.files:
        rel = sf.rel.replace(os.sep, "/")
        if not any(rel.startswith(f"{PKG}/{d}/") for d in ("distsql", "store", "pd", "cdc", "columnar", "mpp", "br")):
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in _BARE_RAISES and (sf.rel, node.lineno) not in seen:
                seen.add((sf.rel, node.lineno))
                findings.append(Finding(
                    sf.rel, node.lineno, PASS_ESCAPE,
                    f"bare `raise {name}` in a dispatch/store/PD layer — use a "
                    f"typed error from store/errors.py (or a subsystem exception "
                    f"with a MySQL code mapping) so callers can classify it"))
    return findings


