"""The share of the GAS kernel's live edges folded by its order-free path
(the exact gather modes min, max and or): ``exact_edges`` over ``edges``
of the program's ``gas_tiles`` counters, read after the window. The
counters run from the process's start, so the warm-up's launches count
too, and a replayed iteration counts what its graph recorded. A program
without the ``exact_edges`` counter, or where the kernel streamed no
edge, gives nothing to read."""


def after_window(live):
    try:
        from repro_torch.kernels import gas_kernel
    except ImportError:
        return None
    k = gas_kernel.gas_tiles
    exact = getattr(k, "exact_edges", None)
    if exact is None or not getattr(k, "edges", 0):
        return None
    return exact / k.edges


def read(ctx):
    return ctx.extra.get("gas_exact_edge_share")
