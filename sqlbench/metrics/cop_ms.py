"""cop_ms: a statement's time in the store's coprocessor, the union (the
pool's tasks overlap) of its `cop.*` spans, averaged over completed
statements."""

from sqlbench.harness import trace


def read(ctx):
    return ctx.per_statement_ms(lambda root: trace.total(trace.spans(root, lambda n: n.startswith("cop."))))
