"""Per-file / per-corpus finding cache for the port's vet driver (the
suite re-runs constantly — the tests run it in-process AND as subprocess
CLI contract tests — and the AST passes are pure functions of their input
file revisions, so results cache by content).

Keys are self-invalidating: every key embeds the analyzed files'
(path, mtime, content sha) AND the sha of the pass's own implementation
modules — editing either the tree or an analyzer misses cleanly. Values
are PRE-suppression findings (suppression markers are re-applied on
every run so the stale-suppression audit always sees live data).

The cache file lives at `<repo>/.vet_cache_torch.json` (gitignored; the
JAX package's suite keeps its own `.vet_cache.json`, and the two may run
side by side; `TIDB_TPU_TORCH_VET_CACHE` overrides the path, an empty
value disables).
Writes are atomic (tmp + rename) and best-effort — a corrupt or
unwritable cache degrades to a cold run, never a failure.

Copy of `tidb_tpu/analysis/vetcache.py` for the PyTorch port.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

from .common import REPO, Finding

_DEFAULT_PATH = os.path.join(REPO, ".vet_cache_torch.json")
_MAX_ENTRIES = 4000
_VERSION = 1


def _module_sha(mod) -> str:
    f = getattr(mod, "__file__", None)
    if not f:
        return "?"
    try:
        return hashlib.sha256(open(f, "rb").read()).hexdigest()[:16]
    except OSError:
        return "?"


class VetCache:
    def __init__(self, path: str | None = None):
        if path is None:
            path = os.environ.get("TIDB_TPU_TORCH_VET_CACHE", _DEFAULT_PATH)
        self.path = path or None  # empty env value disables
        self._data: dict = {}
        self._dirty = False
        self._mod_shas: dict = {}
        if self.path:
            try:
                raw = json.load(open(self.path, encoding="utf-8"))
                if raw.get("version") == _VERSION:
                    self._data = raw.get("entries", {})
            except (OSError, ValueError):
                self._data = {}

    # -- keys ---------------------------------------------------------------
    def pass_sha(self, *mods) -> str:
        parts = []
        for m in mods:
            k = getattr(m, "__name__", str(m))
            if k not in self._mod_shas:
                self._mod_shas[k] = _module_sha(m)
            parts.append(self._mod_shas[k])
        return "+".join(parts)

    @staticmethod
    def file_key(passname: str, pass_sha: str, sf) -> str:
        return f"{passname}|{pass_sha}|{sf.rel}|{sf.mtime}|{sf.sha}"

    @staticmethod
    def corpus_key(passname: str, pass_sha: str, files, salt: str = "") -> str:
        h = hashlib.sha256()
        for sf in sorted(files, key=lambda s: s.rel):
            h.update(f"{sf.rel}:{sf.mtime}:{sf.sha}\n".encode())
        h.update(salt.encode())
        return f"{passname}|{pass_sha}|corpus|{h.hexdigest()}"

    # -- access -------------------------------------------------------------
    def get(self, key: str) -> list | None:
        ent = self._data.get(key)
        if ent is None:
            return None
        try:
            return [Finding(d["path"], d["line"], d["pass"], d["message"])
                    for d in ent]
        except (KeyError, TypeError):
            return None

    def put(self, key: str, findings: list) -> None:
        self._data[key] = [f.to_dict() for f in findings]
        self._dirty = True

    def save(self) -> None:
        if not (self.path and self._dirty):
            return
        entries = self._data
        if len(entries) > _MAX_ENTRIES:
            # drop the oldest insertions (dict order); newest stay
            entries = dict(list(entries.items())[-_MAX_ENTRIES:])
        try:
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self.path) or ".", suffix=".vetcache")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump({"version": _VERSION, "entries": entries}, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # best-effort: cold runs are always correct
