"""The comparison that decides ``correct``.

Each kept answer is judged against the plain reference (``reference/``)
on the snapshot it was asked of: the generated edge list after the deltas
before it, applied by the reference itself. Every number is the worst
over the answers judged; a run is correct when no request or update
failed and every number is within its limit.
"""
from __future__ import annotations

import math

from .reference import edges as redges
from .reference import load


def limits(apps) -> dict:
    out = {}
    for app in sorted(set(apps)):
        out.update(load(app).LIMITS)
    return out


def snapshots(base: redges.Edges, deltas):
    """``(k, edges)`` of snapshot 0 (``base``) and of each snapshot after
    deltas 1..k, in order."""
    g = base
    yield 0, g
    for k, d in enumerate(deltas, 1):
        g = redges.apply_delta(g, d.add_src, d.add_dst, d.add_w, d.rm_src,
                               d.rm_dst)
        yield k, g


def judge(entries, base: redges.Edges, deltas, solve=None) -> tuple:
    """``entries``: ``(snap, app, kwargs, answer, iterations, n)`` each.
    Returns (worst value of each number, answers judged per app). With
    ``solve(module, edges, kwargs)`` the answers are the control's:
    ``entries`` then give only which requests to answer."""
    apps = [e[1] for e in entries]
    worst = {name: 0.0 for name in limits(apps)}
    judged = {}
    last = max((e[0] for e in entries), default=0)
    for k, g in snapshots(base, deltas[:last]):
        sols = {}
        for snap, app, kwargs, got, iterations, n in entries:
            if snap != k:
                continue
            mod = load(app)
            key = (app, tuple(sorted(kwargs.items())))
            if key not in sols:
                sols[key] = mod.solve(g, kwargs)
            if solve is not None:
                got, iterations = solve(mod, g, kwargs)
            for name, v in mod.judge(got, iterations, sols[key]).items():
                v = math.inf if v != v else float(v)
                worst[name] = max(worst[name], v)
            judged[app] = judged.get(app, 0) + n
    return worst, judged
