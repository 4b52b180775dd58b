"""fetch_ms: a statement's time in the program's fetch phase, the union
(the pool's tasks overlap) of its `exec.fetch` spans, averaged over
completed statements. The phase is the device-to-host reads of the row
counts, the valid mask and the output leaves, and their decode into a
Chunk."""

from sqlbench.harness import hostspans


def read(ctx):
    return hostspans.union_ms(ctx, {"exec.fetch"})
