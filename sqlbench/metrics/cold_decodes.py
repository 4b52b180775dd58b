"""cold_decodes: region decodes in the window (TPUStore.stats()
chunk_decodes); a warm deployment reads 0."""


def read(ctx):
    return ctx.delta("chunk_decodes")
