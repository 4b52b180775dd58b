"""Shared plumbing of the analysis package (ref: the shape of a
golang.org/x/tools/go/analysis.Pass — each pass gets parsed sources and
reports findings): the repo root, parsed source files and findings, read
by the `# guarded_by:` collector and the runtime lock watcher.

Copy of `tidb_tpu/analysis/common.py` for the PyTorch port (it imports
nothing of tidb_tpu).

Suppression: a finding anchored on a line carrying (or immediately
preceded by a line carrying) `# vet: ignore[<pass>]` is dropped. The
marker names the pass explicitly so a suppression can never silence a
different analyzer by accident.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from dataclasses import dataclass, field

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_IGNORE = re.compile(r"#\s*vet:\s*ignore\[([a-z0-9_,\- ]+)\]")


@dataclass(frozen=True)
class Finding:
    """One analyzer hit: `path` is repo-relative, `line` 1-based."""

    path: str
    line: int
    passname: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.passname}] {self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line,
                "pass": self.passname, "message": self.message}


@dataclass
class SourceFile:
    """One parsed module: raw text, split lines and the ast tree (None on a
    syntax error — passes skip unparseable files; vet itself reports them)."""

    path: str  # absolute
    rel: str  # repo-relative
    text: str
    lines: list[str] = field(default_factory=list)
    tree: ast.AST | None = None
    parse_error: str | None = None
    mtime: float = 0.0  # cache-key ingredients: (rel, mtime, sha) identify
    sha: str = ""  # one analyzed file revision

    @staticmethod
    def load(path: str, repo: str = REPO) -> "SourceFile":
        rel = os.path.relpath(path, repo)
        try:
            text = open(path, encoding="utf-8").read()
            mtime = os.stat(path).st_mtime
        except OSError as exc:
            return SourceFile(path, rel, "", [], None, f"unreadable: {exc}")
        sf = SourceFile(path, rel, text, text.splitlines(), mtime=mtime,
                        sha=hashlib.sha256(text.encode("utf-8")).hexdigest())
        try:
            sf.tree = ast.parse(text, filename=rel)
        except SyntaxError as exc:
            sf.parse_error = f"syntax error: {exc}"
        return sf

    def suppression_line(self, line: int, passname: str) -> int | None:
        """Line number of the inline `# vet: ignore[<pass>]` marker
        covering `line` (the line itself or the one above), or None."""
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _IGNORE.search(self.lines[ln - 1])
                if m and passname in [p.strip() for p in m.group(1).split(",")]:
                    return ln
        return None

    def suppressed(self, line: int, passname: str) -> bool:
        """True when `line` (or the line above it) carries an inline
        `# vet: ignore[<pass>]` marker naming this pass."""
        return self.suppression_line(line, passname) is not None

    def ignore_markers(self) -> list[tuple[int, list[str]]]:
        """Every `# vet: ignore[...]` marker in the file as
        (line, [passnames]) — the stale-suppression audit's input."""
        out = []
        for ln, text in enumerate(self.lines, 1):
            m = _IGNORE.search(text)
            if m:
                out.append((ln, [p.strip() for p in m.group(1).split(",")]))
        return out


def py_files(*rel_paths: str, repo: str = REPO) -> list[str]:
    """Every .py file under the given repo-relative dirs (files pass
    through), sorted for deterministic output."""
    out: list[str] = []
    for rel in rel_paths:
        root = os.path.join(repo, rel)
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, _dirs, files in os.walk(root):
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


def load_files(paths) -> list[SourceFile]:
    return [SourceFile.load(p) for p in paths]


def filter_suppressed(findings, files_by_rel: dict, used: set | None = None) -> list:
    """Drop findings covered by an inline ignore marker. When `used` is
    given, every marker that actually suppressed something is recorded as
    (rel, marker_line, passname) — the stale-suppression audit subtracts
    this set from the universe of markers."""
    out = []
    for f in findings:
        sf = files_by_rel.get(f.path)
        if sf is not None:
            ln = sf.suppression_line(f.line, f.passname)
            if ln is not None:
                if used is not None:
                    used.add((f.path, ln, f.passname))
                continue
        out.append(f)
    return out
