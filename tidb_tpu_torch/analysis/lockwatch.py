"""lockwatch — opt-in runtime lockset / lock-order detector (ref: Eraser
[Savage et al. 1997] lockset checking and the Go race detector's
happens-before instrumentation, scaled down to what a pure-Python harness
can observe: the DYNAMIC property of the `# guarded_by:` / `# requires:`
annotations, checked against the locks a thread really holds).

Three cooperating mechanisms, all enabled by `watching()`:

  * lock wrapping — while installed, `threading.Lock()`/`RLock()` calls
    made FROM repo code return `WatchedLock` proxies that maintain each
    thread's held-lock stack (re-entrant RLock acquisitions don't grow
    it). Locks created by stdlib frames (pool/queue internals) stay real.
  * lock-order graph — acquiring lock B while holding lock A records the
    edge A->B, aggregated by lock CREATION SITE so an ABBA inversion
    between different instances of the same two locks is still a cycle.
    `report()["cycles"]` lists every cycle: each is a potential deadlock
    even if this run happened not to interleave into it.
  * guarded-attribute checking (Eraser-lite) — classes whose attributes
    carry `# guarded_by: <lock>` annotations get checking descriptors
    installed: once an (object, attr) has been touched by a second thread
    it is SHARED, and every later access must hold the annotated guard
    lock; an access with the guard absent from the thread's lockset is a
    data-race report. Objects touched by one thread only are exempt (the
    Eraser virgin/exclusive states), which is what makes __init__ and
    single-threaded tests quiet.

Accounting is keyed by id(obj) (slotted classes aren't weakref-able);
state is scoped to one `watching()` block, so id reuse across watches
cannot alias.

Copy of `tidb_tpu/analysis/lockwatch.py` for the PyTorch port. What
differs: `watching()` guards `tidb_tpu_torch` by default, and
`guard_tree` imports only modules of that package. The lock factory wraps
every lock made from a file under the repo (outside an `analysis`
directory), so a block that also runs the JAX package records that
package's locks too: read the port's edges as those whose sites lie under
`tidb_tpu_torch/` (`LockWatch.edges_under`).
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager
from dataclasses import dataclass

from .common import REPO

_SHARED = -1
PACKAGE = "tidb_tpu_torch"  # the package whose annotated classes are guarded

# ONE per-thread held-lock stack shared by every LockWatch: a WatchedLock
# outlives its watch (global metric children keep theirs across tests),
# and a later watch must still see it held — per-watch stacks would
# misreport those acquisitions as absent
_TLS = threading.local()


def _held_stack() -> list:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []  # [ [lock, count], ... ] in acquisition order
    return h


@dataclass
class Violation:
    cls: str
    attr: str
    mode: str  # read | write
    guard: str
    where: str  # file:line of the access
    thread: str

    def render(self) -> str:
        return (f"{self.where}: {self.cls}.{self.attr} {self.mode} without "
                f"holding {self.guard} (thread {self.thread})")


class WatchedLock:
    """Proxy over a real Lock/RLock that maintains the per-thread held set
    and feeds the acquisition-order graph."""

    def __init__(self, real, kind: str, site: str, watch: "LockWatch"):
        self._real = real
        self.kind = kind  # "Lock" | "RLock"
        self.site = site  # creation file:line — the aggregation key
        self._watch = watch

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._watch._acquired(self)
        return ok

    def release(self):
        self._watch._released(self)
        self._real.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked() if hasattr(self._real, "locked") else None

    def _is_owned(self):  # Condition compatibility
        return self._real._is_owned() if hasattr(self._real, "_is_owned") else None

    def __repr__(self):
        return f"<WatchedLock {self.kind} {self.site}>"


class _GuardedAttr:
    """Data descriptor standing in for one annotated attribute; delegates
    storage to the original slot descriptor (slotted classes) or the
    instance __dict__, checking the thread's lockset around each access."""

    def __init__(self, attr: str, lockname: str, orig, watch: "LockWatch"):
        self.attr = attr
        self.lockname = lockname
        self.orig = orig  # member_descriptor / previous class attr / None
        self.watch = watch

    def _check(self, obj, mode: str):
        self.watch._access(obj, self.attr, self.lockname, mode)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "read")
        if self.orig is not None:
            return self.orig.__get__(obj, objtype)
        try:
            return obj.__dict__[self.attr]
        except KeyError:
            raise AttributeError(self.attr) from None

    def __set__(self, obj, value):
        self._check(obj, "write")
        if self.orig is not None:
            self.orig.__set__(obj, value)
        else:
            obj.__dict__[self.attr] = value

    def __delete__(self, obj):
        self._check(obj, "write")
        if self.orig is not None:
            self.orig.__delete__(obj)
        else:
            del obj.__dict__[self.attr]


class LockWatch:
    """One watching session: installed factories, the order graph, the
    guard descriptors and every report they produced."""

    def __init__(self, repo: str = REPO):
        self.repo = repo
        self._mu = threading.Lock()  # real lock (created pre-install)
        self.edges: dict[tuple[str, str], str] = {}  # (src, dst) -> example
        self.violations: list[Violation] = []
        self._owners: dict[tuple[int, str], int] = {}  # (id(obj), attr) -> tid|_SHARED
        self._installed = False
        self._patched: list[tuple[type, str, object, bool]] = []
        self._orig_lock = None
        self._orig_rlock = None

    # -- per-thread held stack ---------------------------------------------
    def _held(self) -> list:
        return _held_stack()

    def _acquired(self, lock: WatchedLock):
        held = self._held()
        for ent in held:
            if ent[0] is lock:  # re-entrant RLock acquisition
                ent[1] += 1
                return
        if held:
            with self._mu:
                for ent in held:
                    src = ent[0].site
                    if src != lock.site:
                        self.edges.setdefault((src, lock.site), _caller())
        held.append([lock, 1])

    def _released(self, lock: WatchedLock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return

    def held_locks(self) -> list:
        return [ent[0] for ent in self._held()]

    # -- Eraser-lite guarded access ----------------------------------------
    def _access(self, obj, attr: str, lockname: str, mode: str):
        tid = threading.get_ident()
        key = (id(obj), attr)
        owner = self._owners.get(key)
        if owner is None:
            self._owners[key] = tid  # virgin -> exclusive
            return
        if owner == tid:
            return  # still exclusive to its first thread
        if owner != _SHARED:
            self._owners[key] = _SHARED  # second thread arrived
        lock = getattr(obj, lockname, None)
        if lock is None:
            mod = sys.modules.get(type(obj).__module__)
            lock = getattr(mod, lockname, None) if mod else None
        if not isinstance(lock, WatchedLock):
            return  # guard created outside the watch: cannot verify
        for ent in self._held():
            if ent[0] is lock:
                return
        with self._mu:
            self.violations.append(Violation(
                type(obj).__name__, attr, mode, lockname, _caller(2),
                threading.current_thread().name))

    # -- installation -------------------------------------------------------
    def install(self):
        assert not self._installed
        self._orig_lock, self._orig_rlock = threading.Lock, threading.RLock
        threading.Lock = self._factory(self._orig_lock, "Lock")
        threading.RLock = self._factory(self._orig_rlock, "RLock")
        self._installed = True
        return self

    def _factory(self, real_ctor, kind: str):
        repo = self.repo + os.sep
        watch = self

        def make(*a, **kw):
            real = real_ctor(*a, **kw)
            f = sys._getframe(1)
            fn = f.f_code.co_filename
            if fn.startswith(repo) and os.sep + "analysis" + os.sep not in fn:
                rel = os.path.relpath(fn, watch.repo)
                return WatchedLock(real, kind, f"{rel}:{f.f_lineno}", watch)
            return real

        return make

    def guard_class(self, cls: type, attrs: dict[str, str]):
        """Install checking descriptors for `attrs` ({attr: lockname})."""
        for attr, lockname in attrs.items():
            had = attr in cls.__dict__
            orig = cls.__dict__.get(attr)
            if isinstance(orig, _GuardedAttr):
                continue
            # only delegate to real descriptors (slots); plain class-level
            # defaults fall back to instance-dict storage
            deleg = orig if (orig is not None and hasattr(orig, "__set__")) else None
            setattr(cls, attr, _GuardedAttr(attr, lockname, deleg, self))
            self._patched.append((cls, attr, orig, had))

    def guard_tree(self, packages=(PACKAGE,)):
        """Collect `# guarded_by:` annotations from the source tree and
        guard every annotated class that is already imported (unimported
        modules are imported on demand). Only modules of the port's
        package are imported or guarded."""
        import importlib

        from . import guards as _g
        from .common import load_files, py_files

        for sf in load_files(py_files(*packages, repo=self.repo)):
            if sf.tree is None:
                continue
            g = _g.collect(sf.tree, sf.lines)
            if not g.classes:
                continue
            mod_name = sf.rel[:-3].replace(os.sep, ".")
            if mod_name.endswith(".__init__"):
                mod_name = mod_name[: -len(".__init__")]
            if mod_name.split(".")[0] != PACKAGE:
                continue
            try:
                mod = sys.modules.get(mod_name) or importlib.import_module(mod_name)
            except Exception:  # noqa: BLE001 — unimportable module: skip
                continue
            for cls_name, attrs in g.classes.items():
                cls = getattr(mod, cls_name, None)
                if isinstance(cls, type):
                    self.guard_class(cls, attrs)
        return self

    def uninstall(self):
        if self._installed:
            threading.Lock = self._orig_lock
            threading.RLock = self._orig_rlock
            self._installed = False
        for cls, attr, orig, had in reversed(self._patched):
            if had:
                setattr(cls, attr, orig)
            else:
                try:
                    delattr(cls, attr)
                except AttributeError:
                    pass
        self._patched.clear()

    # -- reporting ----------------------------------------------------------
    def edges_under(self, prefix: str = PACKAGE + "/") -> list[str]:
        """The order edges whose two sites both lie under `prefix` (repo-
        relative, `/`-separated): the port's own lock nesting."""
        return sorted(f"{a} -> {b}" for a, b in self.edges
                      if a.replace(os.sep, "/").startswith(prefix)
                      and b.replace(os.sep, "/").startswith(prefix))

    def cycles(self) -> list[list[str]]:
        """Every elementary cycle in the site-level acquisition-order
        graph (each is a potential deadlock ordering)."""
        adj: dict[str, set] = {}
        for src, dst in self.edges:
            adj.setdefault(src, set()).add(dst)
        out: list[list[str]] = []
        seen_cycles: set = set()

        def dfs(node, path, on_path):
            for nxt in sorted(adj.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    continue
                if (node, nxt) in visited_edges:
                    continue
                visited_edges.add((node, nxt))
                dfs(nxt, path + [nxt], on_path | {nxt})

        visited_edges: set = set()
        for start in sorted(adj):
            dfs(start, [start], {start})
        return out

    def report(self) -> dict:
        return {
            "edges": sorted(f"{a} -> {b}" for a, b in self.edges),
            "cycles": self.cycles(),
            "violations": [v.render() for v in self.violations],
        }


@contextmanager
def watching(guard_tree: bool = True, packages=(PACKAGE,)):
    """Run a block under lockwatch; yields the LockWatch (read `.report()`
    before the block exits or keep the reference). Not re-entrant."""
    w = LockWatch()
    w.install()
    try:
        if guard_tree:
            w.guard_tree(packages)
        yield w
    finally:
        w.uninstall()


def _caller(extra: int = 0) -> str:
    """file:line of the first non-lockwatch frame."""
    f = sys._getframe(2 + extra)
    here = os.path.dirname(os.path.abspath(__file__))
    while f is not None and f.f_code.co_filename.startswith(here):
        f = f.f_back
    if f is None:
        return "?"
    try:
        rel = os.path.relpath(f.f_code.co_filename, REPO)
    except ValueError:
        rel = f.f_code.co_filename
    return f"{rel}:{f.f_lineno}"
