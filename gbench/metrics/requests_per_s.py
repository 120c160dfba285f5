"""App requests answered without error inside the window, over its length
(host clock, client side)."""


def read(ctx):
    done = [r for r in ctx.requests
            if r.error is None and r.t_done <= ctx.t_close]
    return len(done) / (ctx.t_close - ctx.t_open)
