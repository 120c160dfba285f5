"""Process start to the end of warm-up: loading, generating the graph on
the card, ``register`` (store), and one request of each app (plan, pack,
the kernel's build or load)."""


def read(ctx):
    return ctx.setup_s
