"""The newest snapshot's store and an executor of its plan, after the
window: what the readers of the program's own counters read.

An executor the service cached for the newest snapshot's plan is taken
as it is; where no request ran on that snapshot (an update can land
after the last one), an executor is made on the plan's payloads, which
the plan memoizes, so nothing is packed or uploaded again."""


def store(live):
    """The newest snapshot's store, or None."""
    return live.svc.cache.peek(
        (live.fp, live.svc.default_geom, live.svc.default_use_dbg))


def executor(live):
    """An executor of the newest snapshot's plan, or None."""
    skey = (live.fp, live.svc.default_geom, live.svc.default_use_dbg)
    want = live.config.cache_key()
    for key, (ex, _) in list(live.svc._executors.items()):
        if key[0] == skey and key[2] == want:
            return ex
    st = store(live)
    bundle = st.peek_plan(live.config) if st is not None else None
    if bundle is None:
        return None
    from repro_torch.core.executor import Executor
    from repro_torch.core.gas import BUILTIN_APPS
    return Executor(st, bundle, BUILTIN_APPS["pagerank"](),
                    device=live.device)
