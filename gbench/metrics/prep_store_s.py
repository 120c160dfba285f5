"""Host clock around ``GraphService.register``: the store build (DBG,
partitions) and the graph's fingerprint."""


def read(ctx):
    return ctx.prep_store_s
