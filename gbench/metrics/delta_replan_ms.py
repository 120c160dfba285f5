"""Mean ``t_replan_ms`` of the window's updates (the cached plans rebuilt
on the derived store, dirty lanes re-packed)."""


def read(ctx):
    xs = [u.stats["t_replan_ms"] for u in ctx.updates
          if "t_replan_ms" in u.stats]
    return sum(xs) / len(xs) if xs else None
