"""`lock-discipline` — statically verify every access to a
`# guarded_by: <lock>`-annotated attribute happens lexically inside
`with self.<lock>:` (or `with <lock>:` for module-level locks), in the
spirit of go vet's lostcancel/copylocks family and Clang GUARDED_BY
checking (ref: a cop-cache TOCTOU and a PD timer thread — both were
exactly "shared attribute touched off-lock").

Rules:
  * `__init__` bodies are exempt (object construction precedes sharing —
    the Eraser initialization exemption).
  * a `# requires: <lock>` def-line annotation treats the whole function
    body as holding the lock (validated dynamically by lockwatch).
  * module-level definition lines of annotated globals are exempt.

Copy of `tidb_tpu/analysis/lock_discipline.py` for the PyTorch port,
reading the port's `guards.py`.
"""

from __future__ import annotations

import ast

from . import guards as _guards
from .common import Finding, SourceFile

PASS = "lock-discipline"


def _with_locks(node: ast.With) -> set:
    out = set()
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Attribute) and isinstance(ctx.value, ast.Name) \
                and ctx.value.id == "self":
            out.add(ctx.attr)
        elif isinstance(ctx, ast.Name):
            out.add(ctx.id)
    return out


class _FuncChecker(ast.NodeVisitor):
    """Walk one function body tracking the lexically-held lock set."""

    def __init__(self, sf: SourceFile, attrs: dict, globals_: dict,
                 held: set, findings: list):
        self.sf = sf
        self.attrs = attrs  # attr -> lockname (self.<attr> accesses)
        self.globals_ = globals_  # name -> lockname (module globals)
        self.held = set(held)
        self.findings = findings

    def visit_With(self, node: ast.With):
        added = _with_locks(node) - self.held
        self.held |= added
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            lock = self.attrs.get(node.attr)
            if lock is not None and lock not in self.held:
                verb = "written" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
                self.findings.append(Finding(
                    self.sf.rel, node.lineno, PASS,
                    f"self.{node.attr} (guarded_by {lock}) {verb} outside `with self.{lock}`"))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        lock = self.globals_.get(node.id)
        if lock is not None and lock not in self.held:
            verb = "written" if isinstance(node.ctx, (ast.Store, ast.Del)) else "read"
            self.findings.append(Finding(
                self.sf.rel, node.lineno, PASS,
                f"module global {node.id} (guarded_by {lock}) {verb} outside `with {lock}`"))
        self.generic_visit(node)


def _check_function(sf: SourceFile, fn: ast.FunctionDef, attrs: dict,
                    globals_: dict, base_held: set, findings: list):
    checker = _FuncChecker(sf, attrs, globals_, base_held, findings)
    for stmt in fn.body:
        checker.visit(stmt)


def run(files) -> list:
    findings: list = []
    for sf in files:
        if sf.tree is None:
            continue
        g = _guards.collect(sf.tree, sf.lines)
        if not g.any():
            continue
        fns = [n for n in ast.walk(sf.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        spans = [(f.lineno, f.end_lineno or f.lineno) for f in fns]
        for node in fns:
            # nested defs are visited as part of their enclosing function
            # (they inherit its lexical lock set — closures run inline)
            if any(lo < node.lineno and (node.end_lineno or node.lineno) <= hi
                   for lo, hi in spans if (lo, hi) != (node.lineno, node.end_lineno or node.lineno)):
                continue
            cls = _owner_class(sf.tree, node)
            attrs = g.classes.get(cls, {}) if cls else {}
            # methods may also touch annotated module globals
            if not attrs and not g.globals_:
                continue
            if cls and node.name in ("__init__", "__post_init__"):
                continue  # construction precedes sharing
            held = set()
            req = g.requires.get((cls or "", node.name))
            if req:
                held.add(req)
            _check_function(sf, node, attrs, g.globals_, held, findings)
    return findings


def _owner_class(tree: ast.AST, fn: ast.FunctionDef) -> str | None:
    """Name of the class whose body directly contains `fn` (None for
    module-level functions; nested defs inherit their method's class)."""
    best = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            lo, hi = node.lineno, node.end_lineno or node.lineno
            if lo <= fn.lineno <= hi and (best is None or lo > best[1]):
                best = (node.name, lo)
    return best[0] if best else None
