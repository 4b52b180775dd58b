"""What a traced window hands the per-layer metrics' readers: the
statements completed in it with their span trees, the port's counters
before and after, and the device timeline; and the run's breakdown."""

from __future__ import annotations

from dataclasses import dataclass

from . import trace

NAME_CHARS = 120  # a device op's name in the breakdown, cut (C++ template names run to kilobytes)

# the hand kernels' launch counters: (module, wrapper) in tidb_tpu_torch.ops
LAUNCH_COUNTERS = {
    "k1": ("dense_agg", "dense_agg"),
    "k2": ("joinscan", "postsort_segscan"),
    "k3": ("joinscan", "membership_segscan"),
    "k4": ("join_probe", "probe_tables"),
}


def counters(store) -> dict:
    """The port's counts the readers take deltas of."""
    import importlib

    from tidb_tpu_torch.util import metrics

    out = dict(store.stats())
    out["program_launches"] = metrics.PROGRAM_LAUNCHES.value
    for k, (mod, fn) in LAUNCH_COUNTERS.items():
        out[f"{k}_launches"] = getattr(getattr(importlib.import_module(f"tidb_tpu_torch.ops.{mod}"), fn), "launches", 0)
    return out


@dataclass
class Context:
    window: object  # loop.Window
    completed: list  # loop.Record of the statements completed in the window, correct
    before: dict
    after: dict
    timeline: object  # trace.DeviceTimeline, None off the card
    work: object = None  # kernels.CallWork of the window, None off the card

    def delta(self, key: str) -> int:
        return self.after[key] - self.before[key]

    @property
    def bounds_ns(self) -> tuple:
        return int(self.window.start * 1e9), int(self.window.deadline * 1e9)

    def per_statement_ms(self, fn) -> float | None:
        """The mean over completed statements of fn(root span) in ns, as ms."""
        roots = [r.span for r in self.completed if r.span is not None]
        if not roots:
            return None
        return sum(fn(root) for root in roots) / len(roots) / 1e6


def breakdown(win, timeline, lo: int, hi: int, top: int) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the deepest host span open at its middle."""
    ops = [[name[:NAME_CHARS], ns / 1e9] for name, ns in timeline.by_name(lo, hi)[:top]]
    roots = [r.span for r in win.records if r.span is not None]
    gaps = []
    for s, e in timeline.gaps(lo, hi)[:top]:
        mid = (s + e) // 2
        open_ = [x for x in (trace.deepest_open(root, mid) for root in roots) if x is not None]
        name = max(open_)[1] if open_ else "between statements"
        gaps.append([name, (e - s) / 1e9])
    return {"device_ops": ops, "idle_gaps": gaps}
