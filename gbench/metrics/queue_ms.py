"""Mean ``t_queue_ms`` (submit to worker pickup, the service's own clock)
of the window's requests outside the profiled stretch."""


def read(ctx):
    xs = [r.stages["t_queue_ms"] for r in ctx.requests
          if r.stages and not r.traced]
    return sum(xs) / len(xs) if xs else None
