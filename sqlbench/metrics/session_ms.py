"""session_ms: a statement's time in the session layer (parse, plan cache,
plan, Result build): the whole `Session.execute` call (the harness's
`sqlbench.statement` span around it) less the part its
`distsql.execute_root` spans cover, averaged over completed statements."""

from sqlbench.harness import trace


def read(ctx):
    def one(root):
        whole = [(root.start_ns, root.end_ns)]
        return trace.minus(whole, trace.spans(root, lambda n: n == "distsql.execute_root"))

    return ctx.per_statement_ms(one)
