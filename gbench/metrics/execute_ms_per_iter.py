"""Summed ``t_execute_ms`` over summed iterations of the window's requests
outside the profiled stretch: the executor's host time per iteration,
convergence read and reorder to original ids included."""


def read(ctx):
    rs = [r for r in ctx.requests if r.stages and not r.traced]
    its = sum(r.iterations for r in rs)
    return sum(r.stages["t_execute_ms"] for r in rs) / its if its else None
