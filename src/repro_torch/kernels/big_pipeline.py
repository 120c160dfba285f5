"""Big pipeline — sparse-partition batched GAS input form (paper §III-B).

Sparse partitions have poor locality: reading whole vprops windows would
waste nearly all fetched bytes. The Vertex Loader's request dedup is the
offline unique-source compaction (``partition.block_big``); at run time
one torch gather ``vprops[unique_src]`` builds the compact windows the
kernel reads. Many sparse partitions share one launch, amortising the
partition switch as in the paper. For a packed lane ``unique_src`` is
the lane's concatenated compaction tables, gathered once per lane per
iteration.
"""
from __future__ import annotations

from .gas_kernel import gas_tiles
from .little_pipeline import _blocked


def big_pipeline(vprops_padded, payload: dict, *, scatter_op, mode,
                 scatter_fn=None):
    """Run one Big payload (a plan entry or a packed lane) over its
    compacted unique-source windows. Returns ``(n_out_tiles, T)``."""
    geom = payload["geom"]
    vwin = vprops_padded[payload["unique_src"]].view(-1, geom.W)
    return gas_tiles(vwin, *_blocked(payload), scatter_op=scatter_op,
                     mode=mode, t=geom.T, scatter_fn=scatter_fn)
