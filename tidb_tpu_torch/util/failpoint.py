"""Failpoints — compile-time-free fault injection (ref:
github.com/pingcap/failpoint; 673 sites in the reference, activated
per-test via testkit/testfailpoint).

A failpoint is a named hook; tests enable it with a value (bool, count, or
callable). Production code calls `eval("name")` at the site; disabled sites
cost one dict lookup.

A copy of the JAX package's tidb_tpu/util/failpoint.py (stdlib only)."""

from __future__ import annotations

import threading

_lock = threading.Lock()
_active: dict[str, object] = {}  # guarded_by: _lock


def enable(name: str, value: object = True):
    with _lock:
        _active[name] = value


def disable(name: str):
    with _lock:
        _active.pop(name, None)


def is_armed(name: str) -> bool:
    """True when the failpoint is enabled, WITHOUT consuming a count —
    batch paths use this to route through the single-request code where
    the injection site actually lives."""
    # benign unlocked probe: one GIL-atomic dict lookup on the hot path
    return name in _active  # vet: ignore[lock-discipline]


def peek(name: str):
    """The failpoint's raw value WITHOUT consuming a count or invoking a
    callable — health probes use this to ask 'would this site fire for
    store N?' without firing it."""
    return _active.get(name)  # vet: ignore[lock-discipline] — GIL-atomic probe


def eval(name: str):  # noqa: A001 (mirrors the reference API)
    """Returns the failpoint's value if enabled, else None. A callable
    value is invoked (and may raise, the usual injection shape); an int
    value decrements per hit and auto-disables at 0 (fire-N-times)."""
    # disabled sites cost ONE unlocked dict lookup (the contract above);
    # arming/decrement take the lock
    v = _active.get(name)  # vet: ignore[lock-discipline]
    if v is None:
        return None
    if callable(v):
        return v()
    if isinstance(v, int) and not isinstance(v, bool):
        with _lock:
            left = _active.get(name)
            if isinstance(left, int) and left <= 1:
                _active.pop(name, None)
            elif isinstance(left, int):
                _active[name] = left - 1
        return True
    return v


class enabled:  # noqa: N801 — context manager, test-side sugar
    def __init__(self, name: str, value: object = True):
        self.name = name
        self.value = value

    def __enter__(self):
        enable(self.name, self.value)
        return self

    def __exit__(self, *exc):
        disable(self.name)
        return False
