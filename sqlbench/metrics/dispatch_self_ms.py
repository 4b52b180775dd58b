"""dispatch_self_ms: a statement's time in dispatch (task split, pool
waits, root merge): `distsql.execute_root` less the union of its `cop.*`
spans, averaged over completed statements."""

from sqlbench.harness import trace


def read(ctx):
    def one(root):
        er = trace.spans(root, lambda n: n == "distsql.execute_root")
        return trace.minus(er, trace.spans(root, lambda n: n.startswith("cop.")))

    return ctx.per_statement_ms(one)
