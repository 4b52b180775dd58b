"""What the per-layer readers of the port's host spans share: a
statement's spans by name, the union of their intervals, and the time
they spent off a CPU (duration less the thread CPU, `cpu_ns`, that a span
opened and closed on one thread records).

A program without the spans a reader names (one that predates them) has
nothing to read: the readers return None there, not 0."""

from __future__ import annotations

from . import trace


def named(root, names) -> list:
    """Every span under root (root included) whose name is in names."""
    out, stack = [], [root]
    while stack:
        sp = stack.pop()
        if sp.name in names:
            out.append(sp)
        stack.extend(sp.children)
    return out


def _mean_ms(ctx, per_root) -> float | None:
    """The mean over completed statements of per_root(root) in ns, as ms,
    where per_root gives None for a statement with nothing to read; None
    where no statement has anything."""
    got = [per_root(r.span) for r in ctx.completed if r.span is not None]
    if all(v is None for v in got):
        return None
    return sum(v or 0 for v in got) / len(got) / 1e6


def union_ms(ctx, names) -> float | None:
    """A statement's union of the named spans' intervals, in ms."""
    def one(root):
        iv = trace.spans(root, lambda n: n in names)
        return trace.total(iv) if iv else None

    return _mean_ms(ctx, one)


def offcpu_ms(ctx, names) -> float | None:
    """A statement's summed duration less thread CPU of the named spans, in
    ms: the thread-time their work spent runnable or blocked off a CPU."""
    def one(root):
        sps = [sp for sp in named(root, names) if getattr(sp, "cpu_ns", None) is not None]
        return sum(sp.end_ns - sp.start_ns - sp.cpu_ns for sp in sps) if sps else None

    return _mean_ms(ctx, one)
