"""Hierarchical statement tracing — the span tree behind `TRACE <stmt>`
(ref: pkg/util/tracing over opentracing spans + executor/trace.go's
TraceExec collecting them into the result set).

Design:

  * A trace is a tree of `Span`s. `trace(name)` opens a root; `span(name)`
    opens a child of the ambient current span. When NO trace is active,
    `span()` yields None at near-zero cost — instrumentation stays in the
    hot paths permanently, like the reference's always-on tracing hooks.
  * The ambient span is a `contextvars.ContextVar`, so nested sync code
    parents correctly. Worker threads (the distsql dispatch pool) do NOT
    inherit context: the dispatcher captures `current_span()` on the
    session thread and passes it as `span(..., parent=...)` — the
    explicit-handoff analog of opentracing's SpanContext propagation.
  * Child attach is lock-protected (concurrent cop tasks append to one
    parent); finished spans are immutable in practice and render without
    the lock.

Durations are perf_counter_ns; a span still inside `with` reports the
elapsed time so a partial tree (failing statement) renders consistently.
A span that opens and closes on one thread also records `cpu_ns`, the
thread's CPU time (`time.thread_time_ns`) over it, rendered beside
`duration_ns`: their difference is the time the thread was runnable or
blocked but off a CPU (the GIL, a device wait). A span given `start_ns`
(`span(..., start_ns=t)`) began on another thread at `t`, say a pool
task's queue wait from its submit; it carries no `cpu_ns`.

A copy of the JAX package's tidb_tpu/util/tracing.py (stdlib only), with
`cpu_ns` and `start_ns` added.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from contextlib import contextmanager

_current: contextvars.ContextVar = contextvars.ContextVar("tidb_tpu_span", default=None)


class Span:
    """One timed operation with attributes and children."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "cpu_ns", "children", "_lock")

    def __init__(self, name: str, start_ns: int | None = None, **attrs):
        self.name = name
        self.attrs: dict = dict(attrs)
        self.start_ns = time.perf_counter_ns() if start_ns is None else start_ns
        self.end_ns: int | None = None
        self.cpu_ns: int | None = None  # thread CPU over the span; None across threads
        self.children: list[Span] = []  # guarded_by: _lock
        self._lock = threading.Lock()

    # -- building ----------------------------------------------------------
    def child(self, name: str, start_ns: int | None = None, **attrs) -> "Span":
        sp = Span(name, start_ns, **attrs)
        with self._lock:
            self.children.append(sp)
        return sp

    def set(self, key: str, value) -> None:
        """Record an attribute (rows, bytes, cache_hit, region_id...)."""
        self.attrs[key] = value

    def finish(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()

    # -- reading -----------------------------------------------------------
    @property
    def duration_ns(self) -> int:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return end - self.start_ns

    def find(self, name: str) -> list["Span"]:
        """All spans named `name` anywhere under (and including) this one."""
        out = [self] if self.name == name else []
        with self._lock:
            kids = list(self.children)
        for c in kids:
            out.extend(c.find(name))
        return out

    def sum_attr(self, name: str, attr: str) -> int:
        """Sum a numeric attribute over every span named `name` under (and
        including) this one — how a statement-level reader aggregates
        per-dispatch attribution (e.g. `batch_size` / `launches_saved` on
        the distsql.batch_cop spans) without walking the tree by hand."""
        total = 0
        for sp in self.find(name):
            v = sp.attrs.get(attr)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                total += v
        return int(total)

    def to_dict(self) -> dict:
        with self._lock:
            kids = list(self.children)
        d: dict = {"name": self.name, "duration_ns": self.duration_ns}
        if self.cpu_ns is not None:
            d["cpu_ns"] = self.cpu_ns
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if kids:
            d["children"] = [c.to_dict() for c in kids]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)

    def rows(self, _depth: int = 0, _t0: int | None = None) -> list[tuple]:
        """Flatten to (operation, start_offset_us, duration_us, attrs-json)
        rows, children indented two spaces per level — the `TRACE
        FORMAT='row'` rendering (ref: executor/trace.go dfsTree)."""
        t0 = self.start_ns if _t0 is None else _t0
        with self._lock:
            kids = list(self.children)
        row = (
            "  " * _depth + self.name,
            (self.start_ns - t0) // 1000,
            self.duration_ns // 1000,
            json.dumps(self.attrs, sort_keys=True, default=str) if self.attrs else "",
        )
        out = [row]
        for c in kids:
            out.extend(c.rows(_depth + 1, t0))
        return out


def current_span() -> Span | None:
    """The ambient span of THIS thread's context, or None (tracing off)."""
    return _current.get()


@contextmanager
def trace(name: str, **attrs):
    """Open a root span and make it ambient. The statement entry point."""
    root = Span(name, **attrs)
    cpu0 = time.thread_time_ns()
    token = _current.set(root)
    try:
        yield root
    finally:
        root.cpu_ns = time.thread_time_ns() - cpu0
        root.finish()
        _current.reset(token)


@contextmanager
def span(name: str, parent: Span | None = None, start_ns: int | None = None, **attrs):
    """Child span of `parent` (explicit cross-thread handoff) or of the
    ambient span; yields None — and skips all bookkeeping — when neither
    exists. Exceptions are recorded on the span and re-raised, so a failing
    statement leaves a partial tree with `error` attributes. `start_ns`
    (perf_counter_ns, taken on another thread) backdates the span's start;
    such a span records no `cpu_ns`."""
    cur = parent if parent is not None else _current.get()
    if cur is None:
        yield None
        return
    sp = cur.child(name, start_ns, **attrs)
    cpu0 = time.thread_time_ns() if start_ns is None else None
    token = _current.set(sp)
    try:
        yield sp
    except BaseException as exc:
        sp.attrs["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        if cpu0 is not None:
            sp.cpu_ns = time.thread_time_ns() - cpu0
        sp.finish()
        _current.reset(token)
