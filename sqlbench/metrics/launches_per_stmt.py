"""launches_per_stmt: program launches (util.metrics PROGRAM_LAUNCHES) in
the window over the statements completed in it."""


def read(ctx):
    if not ctx.completed:
        return None
    return ctx.delta("program_launches") / len(ctx.completed)
