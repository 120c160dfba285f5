"""Mean of ``t_total_ms - t_queue_ms - t_execute_ms`` of the window's
requests outside the profiled stretch: what the service spends on a
request besides its wait and its execution (store lease, executor
lookup, result hand-off)."""


def read(ctx):
    xs = [r.stages["t_total_ms"] - r.stages["t_queue_ms"]
          - r.stages["t_execute_ms"] for r in ctx.requests
          if r.stages and not r.traced]
    return sum(xs) / len(xs) if xs else None
