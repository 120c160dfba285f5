"""Mean ``t_splice_ms`` of the window's updates (``streaming.apply_delta``:
the delta merged into the dirty partitions and spliced into a derived
store)."""


def read(ctx):
    xs = [u.stats["t_splice_ms"] for u in ctx.updates
          if "t_splice_ms" in u.stats]
    return sum(xs) / len(xs) if xs else None
