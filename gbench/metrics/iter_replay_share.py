"""The share of the executor's iterations replayed from a captured CUDA
graph: ``replayed_iterations`` over ``run_iterations`` of the program's
process totals (``repro_torch.core.replay.totals()``), read after the
window. The totals count from the process's start, so the warm-up's
iterations (each key's first, captured one among them) are in the share
too. A program without those counters, or where no iteration ran, gives
nothing to read."""


def after_window(live):
    try:
        from repro_torch.core import replay
    except ImportError:
        return None
    t = replay.totals()
    if not t.get("run_iterations"):
        return None
    return t["replayed_iterations"] / t["run_iterations"]


def read(ctx):
    return ctx.extra.get("iter_replay_share")
