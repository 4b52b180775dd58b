"""k4_roofline_pct: K4's (`probe_kernel`, the radix join's probe) share of
its roofline over the window: the summed bound of its calls (the larger of
bytes once over 3.35 TB/s and operations over 67 T/s, per call, from its
inputs) over its summed device time in the profiler's timeline. Nothing
to read where K4 did not launch, or launched inside vmap."""

from sqlbench.harness.kernels import KERNELS

CUDA_NAME = KERNELS["k4"][2]


def read(ctx):
    if ctx.timeline is None or ctx.work is None or ctx.work.batched["k4"]:
        return None
    lo, hi = ctx.bounds_ns
    bound, calls = ctx.work.bound_ns("k4", lo, hi)
    device = sum(e - s for n, s, e in ctx.timeline.ops if CUDA_NAME in n and lo <= s < hi)
    if not calls or device <= 0:
        return None
    return 100.0 * bound / device
