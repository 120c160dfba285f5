"""Graph serving subsystem: multi-tenant front-end over the layered API.

Layering (each piece usable on its own):

    fingerprint  — content identity of a Graph; (fp, Geometry, use_dbg)
                   keys one GraphStore
    store_cache  — byte-budgeted LRU of GraphStores with pinning
    service      — GraphService: FIFO request queue, worker draining,
                   coalescing of identical in-flight requests
    metrics      — per-request latency breakdown + service counters

Streaming graphs plug in through ``GraphService.update(fp, delta)``
(see repro_torch/streaming/): the cached store is spliced incrementally, the
cache re-keys to the chained snapshot fingerprint under lease-pinning,
and the delta chain is recorded for cold rebuilds.

The port of the reference package's ``serve_graph``: the same keys,
scheduling, caching, coalescing and Prometheus exposition, with every
executor on the service's ``device`` (default ``cuda``). See README.md
§"PyTorch / H100 port".
"""
from .fingerprint import StoreKey, graph_fingerprint, store_key
from .metrics import RequestMetrics, ServiceMetrics
from .service import (GraphService, RequestHandle, ServiceClosed,
                      UpdateResult)
from .store_cache import GraphStoreCache

__all__ = [
    "GraphService", "GraphStoreCache", "RequestHandle", "RequestMetrics",
    "ServiceClosed", "ServiceMetrics", "StoreKey", "UpdateResult",
    "graph_fingerprint", "store_key",
]
