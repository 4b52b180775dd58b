"""The port's analysis suite: the static vet passes, the program auditor
and the runtime lock watcher (the counterpart of the JAX package's
`tidb_tpu/analysis`).

Three families:

  * AST lint passes (stdlib `ast`, zero deps):
      torch-purity     module-level tensors / process-wide torch toggles
                       in ops/, exec/, expr/, parallel/
      lock-discipline  `# guarded_by:` attributes accessed off-lock
      metrics          registration/label consistency (promparse)
      wire-parity      encode_*/decode_* symmetry in codec/wire.py
      failpoints       armed names resolve to real injection sites
      suppressions     stale `# vet: ignore[...]` markers and stale
                       prog-audit KNOWN entries (audited from the
                       full-suite run)
  * interprocedural dataflow passes (dataflow.py) —
      dataflow-snapshot      MVCC reads on the request path flow start_ts
      dataflow-backoff       retry loops consult a Backoffer budget,
                             request-path sleeps are sliced/clamped
      dataflow-error-escape  typed errors map to SQLError codes before
                             the session boundary
    plus the program auditor (progaudit.py, pass `prog-audit`): the exec
    builder's catalog run on a device under an op recorder, checked for
    float64 leaks, host syncs, device leaks, lane-by-lane vmap ops,
    region-axis drift and build instability.
  * lockwatch (lockwatch.py) — the opt-in runtime lockset / lock-order
    detector the storm and concurrency tests run under:

        from tidb_tpu_torch.analysis import lockwatch
        with lockwatch.watching() as w:
            ...  # drive concurrent engine work
        w.report()  # {"edges", "cycles", "violations"}

Driver: `python -m tidb_tpu_torch.tools.vet [--json] [--device cpu]` —
exit 0 clean, 1 on findings. Results cache per file revision in
`.vet_cache_torch.json` (vetcache.py); suppress a finding with an inline
`# vet: ignore[<pass>]` marker (the `suppressions` pass flags markers that
rot). The submodules, and the pass table, load on first use.
"""

from __future__ import annotations

import importlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

PKG = "tidb_tpu_torch"

_SUBMODULES = ("common", "dataflow", "failpoints", "guards", "lock_discipline", "lockwatch", "metrics_lint",
               "progaudit", "promparse", "suppress_audit", "torch_purity", "vetcache", "wire_parity")
__all__ = list(_SUBMODULES) + ["PASSES", "SUPPRESSIONS", "ALL_PASS_NAMES", "run_pass", "run_only", "run_all"]


@dataclass
class PassSpec:
    """One analyzer: how to run it, what it scans, how it caches.

    kind: "file"   — findings are a pure function of ONE file (cache per
                     (pass, file revision), runs parallelize per file)
          "corpus" — findings need the whole scope at once (cache per
                     (pass, corpus digest))
          "plain"  — self-scoped, uncached (failpoints: its inputs span
                     the port's tests and chip_smoke.py, which aren't
                     loaded here)
    """

    run: object  # callable(files) -> [Finding]
    roots: tuple
    kind: str
    mods: tuple = field(default_factory=tuple)  # implementation modules (cache key)
    salt: str = ""  # extra cache-key ingredient (e.g. torch's version)
    live_files: bool = True  # live run receives the scope files; False =
    # the pass owns its live inputs (prog-audit builds the catalog) —
    # roots then only scope the cache digest
    on_device: bool = False  # the live run takes run_all's / run_only's `device`


def _torch_salt() -> str:
    try:
        import torch

        return f"torch-{torch.__version__}"
    except Exception:  # noqa: BLE001
        return "torch-?"


_PASSES: dict | None = None


def _passes() -> dict:
    """pass name -> spec; the scan roots encode each pass's blast radius
    (torch purity only matters where programs are built, wire parity at
    the codec seam, the dataflow passes across the whole package)."""
    global _PASSES
    if _PASSES is None:
        from . import (dataflow, failpoints, guards, lock_discipline, metrics_lint, progaudit, promparse,
                       torch_purity, wire_parity)

        _PASSES = {
            torch_purity.PASS: PassSpec(
                torch_purity.run,
                (f"{PKG}/ops", f"{PKG}/exec", f"{PKG}/expr", f"{PKG}/parallel"),
                "file", (torch_purity,)),
            lock_discipline.PASS: PassSpec(
                lock_discipline.run, (PKG,), "file", (lock_discipline, guards)),
            metrics_lint.PASS: PassSpec(
                metrics_lint.run, (PKG,), "corpus", (metrics_lint, promparse)),
            wire_parity.PASS: PassSpec(
                wire_parity.run, (f"{PKG}/codec/wire.py",), "corpus", (wire_parity,)),
            failpoints.PASS: PassSpec(failpoints.run, (), "plain", (failpoints,)),
            dataflow.PASS_SNAPSHOT: PassSpec(
                dataflow.run_snapshot, (PKG,), "corpus", (dataflow,)),
            dataflow.PASS_BACKOFF: PassSpec(
                dataflow.run_backoff, (PKG,), "corpus", (dataflow,)),
            dataflow.PASS_ESCAPE: PassSpec(
                dataflow.run_escape, (PKG,), "corpus", (dataflow,)),
            progaudit.PASS: PassSpec(
                progaudit.run, (PKG,), "corpus", (progaudit,), salt=_torch_salt(),
                live_files=False, on_device=True),
        }
    return _PASSES


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name == "PASSES":
        return _passes()
    if name == "SUPPRESSIONS":
        return "suppressions"
    if name == "ALL_PASS_NAMES":
        return tuple(_passes()) + ("suppressions",)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _in_scope(sf, roots: tuple) -> bool:
    rel = sf.rel.replace(os.sep, "/")
    for r in roots:
        if rel == r or rel.startswith(r.rstrip("/") + "/"):
            return True
    return False


_POOL_WORKERS = min(8, (os.cpu_count() or 2))


def _load_tree(roots=(PKG,)) -> list:
    """Parse the scan universe ONCE, in parallel."""
    from .common import SourceFile, py_files

    paths = py_files(*roots)
    with ThreadPoolExecutor(max_workers=_POOL_WORKERS) as pool:
        return list(pool.map(SourceFile.load, paths))


def _run_file_pass(name: str, spec: PassSpec, scope, cache) -> list:
    from .vetcache import VetCache

    psha = cache.pass_sha(*spec.mods)
    out: list = []
    misses: list = []
    for sf in scope:
        key = VetCache.file_key(name, psha, sf)
        hit = cache.get(key)
        if hit is None:
            misses.append((key, sf))
        else:
            out.extend(hit)
    if misses:
        with ThreadPoolExecutor(max_workers=_POOL_WORKERS) as pool:
            results = list(pool.map(lambda m: spec.run([m[1]]), misses))
        for (key, _sf), fnds in zip(misses, results):
            cache.put(key, fnds)
            out.extend(fnds)
    return out


def _run_corpus_pass(name: str, spec: PassSpec, scope, cache, device: str) -> list:
    from .vetcache import VetCache

    if spec.on_device:
        from .progaudit import resolve_device

        resolve_device(device)  # raises without CUDA, cached result or not
    salt = f"{spec.salt}|{device}" if spec.on_device else spec.salt
    key = VetCache.corpus_key(name, cache.pass_sha(*spec.mods), scope, salt)
    hit = cache.get(key)
    if hit is not None:
        return hit
    if spec.on_device:
        fnds = spec.run(None, device=device)
    else:
        fnds = spec.run(scope) if (spec.roots and spec.live_files) else spec.run(None)
    cache.put(key, fnds)
    return fnds


def _run_live(name: str, spec: PassSpec, tree, cache, device: str) -> list:
    """One pass over the live tree (pre-suppression findings)."""
    scope = [sf for sf in tree if _in_scope(sf, spec.roots)] if spec.roots else []
    if spec.kind == "file":
        return _run_file_pass(name, spec, scope, cache)
    if spec.kind == "corpus":
        return _run_corpus_pass(name, spec, scope, cache, device)
    return spec.run(None)


def _filter(name: str, fnds, by_rel: dict, used_markers: set | None, used_known: set | None,
            device: str) -> list:
    """Suppression markers for every pass; KNOWN entries for prog-audit."""
    from . import progaudit
    from .common import filter_suppressed

    if name == progaudit.PASS:
        fnds = progaudit.apply_known(fnds, device, used_known)
    return filter_suppressed(fnds, by_rel, used_markers)


def run_pass(name: str, files=None, device: str = "cuda") -> list:
    """Run one pass; `files` overrides the default scan roots (fixture
    testing). Suppression markers are honored either way."""
    from .common import filter_suppressed

    if name == "suppressions":
        raise ValueError(
            "the suppressions audit needs every other pass's verdict — "
            "it only runs from run_all() (or the vet CLI without --only)")
    if files is not None:
        findings = _passes()[name].run(files)
        return filter_suppressed(findings, {sf.rel: sf for sf in files})
    return run_only([name], device=device)


def run_only(names, cache=None, device: str = "cuda") -> list:
    """A subset of passes over the live tree — ONE shared parse and the
    same per-revision cache as run_all. The stale-suppression audit needs
    every pass's verdict, so it only rides full runs."""
    from .vetcache import VetCache

    if cache is None:
        cache = VetCache()
    tree = _load_tree((PKG,))
    by_rel = {sf.rel: sf for sf in tree}
    out: list = []
    for name in names:
        out.extend(_filter(name, _run_live(name, _passes()[name], tree, cache, device), by_rel, None, None,
                           device))
    cache.save()
    return sorted(out, key=lambda f: (f.path, f.line, f.passname))


def run_all(cache=None, device: str = "cuda") -> list:
    """Every pass over its default scope — shared parse, per-revision
    cache, suppression filtering with marker-usage tracking, and the
    stale-suppression audit (markers, and prog-audit's KNOWN entries) over
    the result. Findings sorted by location."""
    from . import progaudit, suppress_audit
    from .vetcache import VetCache

    if cache is None:
        cache = VetCache()
    passes = _passes()
    tree = _load_tree((PKG,))
    by_rel = {sf.rel: sf for sf in tree}
    used_markers: set = set()
    used_known: set = set()
    out: list = []
    for name, spec in passes.items():
        fnds = _run_live(name, spec, tree, cache, device)
        out.extend(_filter(name, fnds, by_rel, used_markers, used_known, device))
    out.extend(suppress_audit.audit(
        tree, used_markers, ran_passes=set(passes), known_passes=set(passes) | {"suppressions"}))
    out.extend(progaudit.stale_known(used_known, device))
    cache.save()
    return sorted(out, key=lambda f: (f.path, f.line, f.passname))
