"""Reduction of a traced window: the statements' span trees (the port's
util.tracing) and the profiler's device timeline (torch.profiler, CUPTI),
on one clock."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def total(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def minus(a, b) -> int:
    """Length of the union of a less the part the union of b covers."""
    a, b = union(a), union(b)
    covered, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            covered += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return sum(e - s for s, e in a) - covered


def spans(root, pred) -> list:
    """(start_ns, end_ns) of every span under root whose name passes pred."""
    out = []
    stack = [root]
    while stack:
        sp = stack.pop()
        if pred(sp.name):
            out.append((sp.start_ns, sp.end_ns if sp.end_ns is not None else sp.start_ns))
        stack.extend(sp.children)
    return out


def deepest_open(root, t_ns: int, depth: int = 0):
    """(depth, name) of the deepest span under root open at t_ns, or None."""
    end = root.end_ns if root.end_ns is not None else t_ns + 1
    if not root.start_ns <= t_ns < end:
        return None
    best = (depth, root.name)
    for c in root.children:
        got = deepest_open(c, t_ns, depth + 1)
        if got is not None and got[0] > best[0]:
            best = got
    return best


@dataclass
class DeviceTimeline:
    """Device operations of the window: (name, start_ns, end_ns) on the
    host's perf_counter_ns clock."""

    ops: list = field(default_factory=list)

    def busy_ns(self, lo: int, hi: int) -> int:
        return total(clip([(s, e) for _n, s, e in self.ops], lo, hi))

    def gaps(self, lo: int, hi: int) -> list:
        """Idle [start, end) intervals of the window, longest first."""
        busy = union(clip([(s, e) for _n, s, e in self.ops], lo, hi))
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        out = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        return sorted(out, key=lambda g: g[0] - g[1])

    def by_name(self, lo: int, hi: int) -> list:
        sums: dict = {}
        for n, s, e in self.ops:
            for cs, ce in clip([(s, e)], lo, hi):
                sums[n] = sums.get(n, 0) + ce - cs
        return sorted(sums.items(), key=lambda kv: -kv[1])


class Profiler:
    """torch.profiler over the window, its device events mapped onto
    perf_counter_ns by a marker opened at a known host time."""

    MARK = "sqlbench.window"

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark_ns = time.perf_counter_ns()
        with record_function(self.MARK):
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def timeline(self) -> DeviceTimeline:
        from torch.autograd import DeviceType

        evs = self.prof.profiler.kineto_results.events()
        mark = [e for e in evs if e.name() == self.MARK]
        if not mark:
            raise RuntimeError("the profiler recorded no window marker")
        offset = self.mark_ns - mark[0].start_ns()
        ops = [(e.name(), e.start_ns() + offset, e.start_ns() + e.duration_ns() + offset)
               for e in evs if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        return DeviceTimeline(ops)
