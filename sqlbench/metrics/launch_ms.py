"""launch_ms: a statement's time in the program's launch phase, the union
(the pool's tasks overlap) of its `exec.launch` spans, averaged over
completed statements. The phase is the program's call: Python and torch
dispatch enqueueing its device operations, and any sync inside it."""

from sqlbench.harness import hostspans


def read(ctx):
    return hostspans.union_ms(ctx, {"exec.launch"})
