"""The 95th percentile of the window's requests, from submit to result on
the client's clock, with the number of samples beside it."""
import statistics


def read(ctx):
    lat = [(r.t_done - r.t_submit) * 1e3 for r in ctx.requests
           if r.error is None]
    if len(lat) < 2:
        return None
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18]
    return {"value": p95, "samples": len(lat)}
