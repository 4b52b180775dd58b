"""`metrics` — registration/use consistency for the Prometheus registry
(ref: client_golang panicking on duplicate registration and label-arity
mismatch at runtime; here both become lint findings before any scrape).

Checks:
  * every literal metric name is registered at exactly ONE call site
  * registered names satisfy the exposition grammar (promparse) and the naming
    conventions: counters end `_total`, gauges don't, histograms carry a
    unit suffix (`_seconds`/`_bytes`)
  * declared label names are valid
  * every `metrics.<CONST>` use site resolves to a registered instrument;
    vec instruments are always addressed through `.labels(...)` with the
    registration's exact arity (positional) or exact names (keyword), and
    plain instruments never are

Copy of `tidb_tpu/analysis/metrics_lint.py` for the PyTorch port, over
`tidb_tpu_torch/util/metrics.py`'s registrations and their uses.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from . import promparse
from .common import Finding

PASS = "metrics"

_KINDS = {
    "counter": "counter", "gauge": "gauge", "histogram": "histogram",
    "counter_vec": "counter", "gauge_vec": "gauge", "histogram_vec": "histogram",
}
_VEC_KINDS = {"counter_vec", "gauge_vec", "histogram_vec"}
_CHILD_METHODS = {"inc", "dec", "set", "observe"}


@dataclass
class Registration:
    name: str
    method: str  # counter / counter_vec / ...
    labelnames: tuple | None
    const: str | None
    rel: str
    line: int


def _literal_str(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None


def _labelnames(call: ast.Call) -> tuple | None:
    for kw in call.keywords:
        if kw.arg == "labelnames":
            if isinstance(kw.value, (ast.Tuple, ast.List)):
                vals = [_literal_str(e) for e in kw.value.elts]
                if all(v is not None for v in vals):
                    return tuple(vals)
            return None  # non-literal: cannot check
    # positional third arg
    if len(call.args) >= 3 and isinstance(call.args[2], (ast.Tuple, ast.List)):
        vals = [_literal_str(e) for e in call.args[2].elts]
        if all(v is not None for v in vals):
            return tuple(vals)
        return None  # non-literal: cannot check
    return ()  # a vec registered without labelnames


def _collect_registrations(files) -> tuple[list, list]:
    regs: list[Registration] = []
    findings: list = []
    for sf in files:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            call = None
            const = None
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                call = node.value
                if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                    const = node.targets[0].id
            elif isinstance(node, ast.Call):
                call = node
            if call is None or not isinstance(call.func, ast.Attribute):
                continue
            method = call.func.attr
            if method not in _KINDS or not call.args:
                continue
            name = _literal_str(call.args[0])
            if name is None:
                continue
            labelnames = _labelnames(call) if method in _VEC_KINDS else None
            regs.append(Registration(name, method, labelnames, const, sf.rel, call.lineno))
    # de-dup Assign/Call double-walk hits (the Call inside an Assign is
    # walked twice); keep one per (file, line, name)
    seen = set()
    uniq = []
    for r in regs:
        key = (r.rel, r.line, r.name)
        if key in seen:
            continue
        seen.add(key)
        uniq.append(r)
    return uniq, findings


def _check_registrations(regs) -> list:
    findings: list = []
    by_name: dict[str, list] = {}
    for r in regs:
        by_name.setdefault(r.name, []).append(r)
    for name, rs in sorted(by_name.items()):
        if len(rs) > 1:
            sites = ", ".join(f"{r.rel}:{r.line}" for r in rs[1:])
            findings.append(Finding(rs[0].rel, rs[0].line, PASS,
                                    f"metric {name!r} registered more than once (also at {sites}) — "
                                    f"one registration site per family"))
        r = rs[0]
        if not promparse.valid_metric_name(name):
            findings.append(Finding(r.rel, r.line, PASS,
                                    f"invalid metric name {name!r}"))
        kind = _KINDS[r.method]
        if kind == "counter" and not name.endswith(promparse.COUNTER_SUFFIX):
            findings.append(Finding(r.rel, r.line, PASS,
                                    f"counter {name!r} must end `_total` (prometheus naming)"))
        if kind != "counter" and name.endswith(promparse.COUNTER_SUFFIX):
            findings.append(Finding(r.rel, r.line, PASS,
                                    f"{kind} {name!r} must not claim the counter suffix `_total`"))
        if kind == "histogram" and not name.endswith(("_seconds", "_bytes")):
            findings.append(Finding(r.rel, r.line, PASS,
                                    f"histogram {name!r} should carry a base-unit suffix (_seconds/_bytes)"))
        for ln in (r.labelnames or ()):
            if not promparse.valid_label_name(ln):
                findings.append(Finding(r.rel, r.line, PASS,
                                        f"invalid label name {ln!r} on {name!r}"))
    return findings


def _metrics_aliases(tree: ast.AST) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "metrics":
                    out.add(a.asname or "metrics")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith(".metrics"):
                    out.add(a.asname or a.name.split(".")[0])
    return out


def _check_uses(files, regs) -> list:
    by_const = {r.const: r for r in regs if r.const}
    findings: list = []
    for sf in files:
        if sf.tree is None:
            continue
        aliases = _metrics_aliases(sf.tree)
        if not aliases:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            base = node.func.value
            # metrics.CONST.labels(...) / metrics.CONST.inc(...)
            if not (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                    and base.value.id in aliases):
                continue
            const = base.attr
            if const == "REGISTRY" or not const.isupper():
                continue
            reg = by_const.get(const)
            if reg is None:
                if meth in _CHILD_METHODS | {"labels"}:
                    findings.append(Finding(sf.rel, node.lineno, PASS,
                                            f"metrics.{const} is not a registered instrument"))
                continue
            is_vec = reg.method in _VEC_KINDS
            if meth == "labels":
                if not is_vec:
                    findings.append(Finding(sf.rel, node.lineno, PASS,
                                            f"{reg.name!r} is a plain {_KINDS[reg.method]} — it has no .labels()"))
                elif reg.labelnames is not None:
                    if node.keywords:
                        names = tuple(kw.arg for kw in node.keywords)
                        if set(names) != set(reg.labelnames) or node.args:
                            findings.append(Finding(
                                sf.rel, node.lineno, PASS,
                                f"{reg.name!r} label set mismatch: registered {reg.labelnames}, "
                                f"called with {names}"))
                    elif len(node.args) != len(reg.labelnames):
                        findings.append(Finding(
                            sf.rel, node.lineno, PASS,
                            f"{reg.name!r} takes {len(reg.labelnames)} label value(s) "
                            f"{reg.labelnames}, got {len(node.args)}"))
            elif meth in _CHILD_METHODS and is_vec:
                findings.append(Finding(
                    sf.rel, node.lineno, PASS,
                    f"{reg.name!r} is a labeled family — address a child via "
                    f".labels({', '.join(reg.labelnames or ())}) before .{meth}()"))
    return findings


def run(files) -> list:
    regs, findings = _collect_registrations(files)
    findings += _check_registrations(regs)
    findings += _check_uses(files, regs)
    return findings
