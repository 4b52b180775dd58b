"""pool_queue_ms: a statement's wait in the dispatch pool, the union of its
`distsql.cop_queue` spans (each from a task's submit on the session
thread to its start on a worker), averaged over completed statements."""

from sqlbench.harness import hostspans


def read(ctx):
    return hostspans.union_ms(ctx, {"distsql.cop_queue"})
