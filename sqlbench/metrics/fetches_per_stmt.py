"""fetches_per_stmt: the coprocessor's device-to-host reads
(TPUStore.stats() host_fetches) in the window over the statements
completed in it; None from a store that does not count them."""


def read(ctx):
    if not ctx.completed or "host_fetches" not in ctx.before:
        return None
    return ctx.delta("host_fetches") / len(ctx.completed)
