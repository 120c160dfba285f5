"""Bytes the card holds for the graph, per live edge: the newest
snapshot's plan payloads (``Executor.dispatch_stats()["payload_bytes"]``
of an executor of that plan, :mod:`gbench.newest`) plus what the store
itself keeps on the card (``GraphStore.stats()["device_bytes"]``), over
the live edges those payloads stream (``kernel_edges``); read after the
window. A program whose store does not count its device bytes gives
nothing to read."""
from gbench import newest


def after_window(live):
    st = newest.store(live)
    device_bytes = None if st is None else st.stats().get("device_bytes")
    ex = newest.executor(live) if device_bytes is not None else None
    if ex is None:
        return None
    d = ex.dispatch_stats()
    if not d.get("kernel_edges"):
        return None
    return (d["payload_bytes"] + device_bytes) / d["kernel_edges"]


def read(ctx):
    return ctx.extra.get("card_bytes_per_edge")
