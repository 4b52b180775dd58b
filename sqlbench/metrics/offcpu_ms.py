"""offcpu_ms: thread-ms that a statement's runnable host work spent off a
CPU: the sum over its `cop.decode`, `exec.launch` and `exec.fetch` spans
of duration less thread CPU (`cpu_ns`), averaged over completed
statements. On a host that is not oversubscribed this is the wait for the
GIL."""

from sqlbench.harness import hostspans


def read(ctx):
    return hostspans.offcpu_ms(ctx, {"cop.decode", "exec.launch", "exec.fetch"})
