"""device_idle_pct: the share of the traced window in which no device
operation runs (the complement of the union of the profiler's device
intervals)."""


def read(ctx):
    if ctx.timeline is None:
        return None
    lo, hi = ctx.bounds_ns
    return 100.0 * (1.0 - ctx.timeline.busy_ns(lo, hi) / (hi - lo))
