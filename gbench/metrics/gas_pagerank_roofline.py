"""The GAS kernel's share of its roofline on PageRank's requests over the
profiled stretch: the least time their Scatter+Gather needs
(``roofline.pagerank_bytes`` of every iteration they ran, from the graph,
over the card's memory rate) divided by the device time of the kernel's
sum-mode launches (``MODE`` 0 of ``gas_kernel.cu``, which only PageRank
runs in these mixes) in the profiler trace."""
from gbench import roofline

KERNELS = ("gas_chunk_kernel<0,", "gas_combine_kernel<0,")


def read(ctx):
    rate = roofline.hbm_bytes_per_s(ctx.device_kind)
    if ctx.trace is None or rate is None:
        return None
    t = sum(hi - lo for lo, hi, name in ctx.trace["kernels"]
            if any(k in name for k in KERNELS)) / 1e6
    nbytes = sum(roofline.pagerank_bytes(ctx.num_vertices,
                                         ctx.edge_counts[r.snap],
                                         r.iterations)
                 for r in ctx.requests
                 if r.traced and r.error is None and r.app == "pagerank")
    if t <= 0 or nbytes == 0:
        return None
    return 100.0 * nbytes / rate / t
