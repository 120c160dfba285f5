"""Plan and pack of the first request: its ``t_total_ms`` less its queue,
store and execute stages (the plan, the executor's payload upload and
the service's own hand-off), by the service's clock."""


def read(ctx):
    m = ctx.warm[0]
    return (m.t_total_ms - m.t_queue_ms - m.t_store_ms
            - m.t_execute_ms) / 1e3
