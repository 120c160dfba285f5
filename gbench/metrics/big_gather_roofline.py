"""The Big gathers' share of their roofline: the least bytes one
iteration's gathers ``vprops[unique_src]`` move, over ``big_gather_ms``'s
device time, at the card's memory rate (``roofline.hbm_bytes_per_s``).

The least bytes are 12 B a gathered source: its 4 B index read, its
4 B value read and its 4 B written to the compact window. The gathered
sources are the ``big_gathered`` counter of an executor of the newest
snapshot's plan (``Executor.dispatch_stats()``, :mod:`gbench.newest`),
read after the window; a program without that counter gives nothing to
read."""
from gbench import newest, roofline

BYTES_PER_SOURCE = 12


def after_window(live):
    ex = newest.executor(live)
    return None if ex is None else ex.dispatch_stats().get("big_gathered")


def read(ctx):
    n = ctx.extra.get("big_gather_roofline")
    ms = ctx.extra.get("big_gather_ms")
    rate = roofline.hbm_bytes_per_s(ctx.device_kind)
    if not n or not ms or rate is None:
        return None
    return 100.0 * BYTES_PER_SOURCE * n / rate / (ms / 1e3)
