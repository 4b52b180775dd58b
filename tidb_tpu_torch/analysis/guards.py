"""The `guarded_by` annotation convention — the collection the runtime
lockwatch detector reads (ref:
Clang's thread-safety attributes: GUARDED_BY on fields, REQUIRES on
functions; here they are structured comments, the only metadata channel a
runtime-typed codebase has).

Convention:

  * `self.attr = ...  # guarded_by: _mu` on an attribute's defining
    assignment (normally in __init__) declares that every read/write of
    `self.attr` must happen while `self._mu` is held. The lock name may
    also be a module-level lock (`# guarded_by: _ALLOC_LOCK`).
  * `GLOBAL = {}  # guarded_by: _lock` at module level declares the same
    for a module global.
  * `def _helper(self):  # requires: _mu` on a def line declares that the
    function runs with `_mu` already held (RLock re-entry or private
    helpers only called under the lock) — its body counts as guarded.
    The runtime detector checks the real held set, so a wrong
    `requires` surfaces under lockwatch.

Copy of `tidb_tpu/analysis/guards.py` for the PyTorch port (the JAX
package's static lock-discipline pass reads the same comments there).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

# the marker may trail other comment text (`# LRU ring; guarded_by: _mu`)
GUARDED = re.compile(r"#.*?\bguarded_by:\s*([A-Za-z_]\w*)")
REQUIRES = re.compile(r"#.*?\brequires:\s*([A-Za-z_]\w*)")
_SELF_ATTR = re.compile(r"self\.([A-Za-z_]\w*)\s*(?::[^=]+)?=")
_GLOBAL_ATTR = re.compile(r"^([A-Za-z_]\w*)\s*(?::[^=]+)?=")
# dataclass-style class field: `_next_handle: int = 1  # guarded_by: ...`
_FIELD_ATTR = re.compile(r"^\s+([A-Za-z_]\w*)\s*:[^=#]*=")


@dataclass
class ModuleGuards:
    """Annotations of one module. `classes` maps class name ->
    {attr: lockname}; `globals_` maps global name -> lockname;
    `requires` maps (class-or-'' , funcname) -> lockname."""

    classes: dict = field(default_factory=dict)
    globals_: dict = field(default_factory=dict)
    requires: dict = field(default_factory=dict)

    def any(self) -> bool:
        return bool(self.classes or self.globals_ or self.requires)


def _class_spans(tree: ast.AST) -> list[tuple[str, int, int]]:
    """(name, first_line, last_line) of every top-level-ish class."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.append((node.name, node.lineno, node.end_lineno or node.lineno))
    return out


def collect(tree: ast.AST | None, lines: list[str]) -> ModuleGuards:
    """Scan a module's comments for guarded_by / requires annotations."""
    g = ModuleGuards()
    if tree is None:
        return g
    spans = _class_spans(tree)

    def owner_of(line_no: int) -> str | None:
        best = None
        for name, lo, hi in spans:
            if lo <= line_no <= hi and (best is None or lo > best[1]):
                best = (name, lo)
        return best[0] if best else None

    for ln, line in enumerate(lines, 1):
        m = GUARDED.search(line)
        if m:
            lock = m.group(1)
            cls = owner_of(ln)
            am = _SELF_ATTR.search(line)
            if cls is not None and am:
                g.classes.setdefault(cls, {})[am.group(1)] = lock
            elif cls is not None:
                fm = _FIELD_ATTR.match(line)
                if fm:
                    g.classes.setdefault(cls, {})[fm.group(1)] = lock
            else:
                gm = _GLOBAL_ATTR.match(line)
                if gm:
                    g.globals_[gm.group(1)] = lock
        r = REQUIRES.search(line)
        if r and re.search(r"^\s*def\s+(\w+)", line):
            fn = re.search(r"^\s*def\s+(\w+)", line).group(1)
            g.requires[(owner_of(ln) or "", fn)] = r.group(1)
    return g
