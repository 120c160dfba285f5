"""The mean time of the updates completed in the window: from the
``update`` call until the new snapshot answered its first request."""


def read(ctx):
    done = [u.t_first - u.t_call for u in ctx.updates
            if u.t_first is not None and u.t_first <= ctx.t_close]
    if not done:
        return None
    return {"value": sum(done) / len(done), "samples": len(done)}
