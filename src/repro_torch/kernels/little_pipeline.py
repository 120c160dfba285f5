"""Little pipeline — dense-partition GAS input form (paper §III-C).

Dense partitions touch most source windows, so the kernel reads raw
vprops windows: ``vprops.view(-1, W)``, each edge's source indexing it
at ``window_id[b] * W + src_local``. No dedup, no compaction — the paper's argument
that locality makes those techniques dead weight for dense partitions.
Windows no block names are never read.
"""
from __future__ import annotations

from .gas_kernel import gas_tiles


def little_pipeline(vprops_padded, payload: dict, *, scatter_op, mode,
                    scatter_fn=None):
    """Run one Little payload (a plan entry or a packed lane) over the
    raw property windows. ``vprops_padded``: ``(V_pad,)``, V_pad % W == 0.
    Returns ``(n_out_tiles, T)`` tiles."""
    geom = payload["geom"]
    return gas_tiles(vprops_padded.view(-1, geom.W), *_blocked(payload),
                     scatter_op=scatter_op, mode=mode, t=geom.T,
                     scatter_fn=scatter_fn)


def _blocked(p: dict):
    """The payload arrays the kernel reads (its live-edge stream), in its
    argument order."""
    return (p["edge_src"], p["edge_dst"], p["edge_w"], p["tile_edge_start"],
            p["tile_chunk_start"])
