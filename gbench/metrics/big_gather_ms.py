"""Device ms of one iteration's Big-lane gathers (``vprops[unique_src]``
of every Big payload the newest snapshot's plan packed), timed with CUDA
events after the window: many iterations back to back, the card first
held busy so that the host has queued them all (the method of
``chip_smoke.py``'s phase 4)."""

REPS = 20
HOST_AHEAD_CYCLES = int(1e8)


def after_window(live):
    import torch
    if live.device.type != "cuda":
        return None
    key = (live.fp, live.svc.default_geom, live.svc.default_use_dbg)
    store = live.svc.cache.peek(key)
    bundle = store.peek_plan(live.config) if store is not None else None
    if bundle is None:
        return None
    ids = [p["unique_src"] for lane in bundle.packed_lanes(live.device)
           for p in lane if p["kind"] == "big"]
    if not ids:
        return None
    vprops = torch.rand(store.V_pad, device=live.device)

    def gathers():
        return [vprops[i] for i in ids]

    gathers()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(REPS):
        gathers()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def read(ctx):
    return ctx.extra.get("big_gather_ms")
