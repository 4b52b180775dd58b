"""wait_ms: a statement's time in the program's wait phase, the union (the
pool's tasks overlap) of its `exec.wait` spans, averaged over completed
statements. The phase is the first blocking read, of the overflow flags:
the host waiting for the card to finish the queued work."""

from sqlbench.harness import hostspans


def read(ctx):
    return hostspans.union_ms(ctx, {"exec.wait"})
