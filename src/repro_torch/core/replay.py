"""One fused iteration captured as CUDA graphs and replayed.

Every iteration of :meth:`~.executor.Executor.run` issues the same
launches on the same payloads: each payload's Big gather and GAS kernel,
the merge and Apply. At kron20's size the host takes several times
longer to issue them than the card takes to run them. So the first run
of an iteration captures it once into two CUDA graphs over two static
property buffers A and B (A→B and B→A, sharing one private memory pool),
and every later iteration is one replay.

The captured iteration lives on the plan bundle
(:meth:`~.planner.PlanBundle.iteration_capture`), one per (device,
iteration key), and is dropped with the bundle. Every executor on the
bundle whose app has the same :attr:`~.gas.GASApp.iteration_key` shares
it: BFS and SSSP build an executor per root, and the root only changes
the initial vector, which each run copies into A.

A run replays when what it can observe allows it (:func:`eligible`: the
card, the kernel path, fused lanes, no per-lane tracing, an app with an
iteration key) and the shared capture is free: its lock is taken without
waiting, and a run that finds it held runs its iterations eagerly, bit
for bit the same. A capture that fails leaves its key eager on that
bundle. The capture itself runs the first iteration of the run that
takes it eagerly on a side stream (the warm-up: the kernel library is
loaded and its attributes set outside the capture), then records both
graphs with ``capture_error_mode="thread_local"``, since another worker
keeps issuing eager work meanwhile; one capture runs at a time in the
process.

:func:`count` adds a run's counts (:data:`COUNTS`) to its executor's,
which :meth:`~.executor.Executor.dispatch_stats` reports, and to the
process's, which :func:`totals` reads. ``gas_tiles.launches`` and
``gas_tiles.edges`` keep counting the kernel's launches: the calls
recorded into a graph count apart (``gas_tiles.recorded_launches``), and
each replay adds what its graph recorded (``exact_edges`` too).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from ..kernels import gas_kernel

# captures made, iterations replayed, iterations of eligible runs run
# eagerly (their capture busy or broken, or the capturing iteration
# itself), and every iteration Executor.run ran
COUNTS = ("iteration_captures", "replayed_iterations", "eager_iterations",
          "run_iterations")

_totals = dict.fromkeys(COUNTS, 0)
_totals_lock = threading.Lock()
_capture_lock = threading.Lock()      # one capture at a time in the process
_side_streams: dict = {}              # device -> the captures' side stream


def count(counts: dict, **add: int) -> None:
    """Add one run's counts to its executor's ``counts`` and to the
    process's."""
    with _totals_lock:
        for key, n in add.items():
            counts[key] += n
            _totals[key] += n


def totals() -> dict:
    """The :data:`COUNTS` of every run in the process since it started."""
    with _totals_lock:
        return dict(_totals)


def eligible(device: torch.device, path: str, fuse_lanes: bool,
             lane_detail: bool, app) -> bool:
    """Whether a run may replay its iterations: on a card, on the kernel
    path, with fused lanes, without a tracer that times each lane, for
    an app that names its iteration (a ``GASApp`` without a key, as a
    user's instance or a UDF app, stays eager)."""
    return (device.type == "cuda" and path == "cuda" and fuse_lanes
            and not lane_detail and app.iteration_key is not None)


@contextlib.contextmanager
def _side_stream(device: torch.device):
    """Run the block on the captures' side stream of ``device``, ordered
    after this thread's current stream and before what it issues next."""
    cur = torch.cuda.current_stream(device)
    side = _side_streams.get(device)
    if side is None:
        side = _side_streams[device] = torch.cuda.Stream(device)
    side.wait_stream(cur)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        cur.wait_stream(side)


def _record(fn: Callable, pool) -> torch.cuda.CUDAGraph:
    """``fn``'s work on the current stream, captured into a graph that
    allocates from ``pool``."""
    g = torch.cuda.CUDAGraph()
    g.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    finally:
        g.capture_end()
    return g


def _pool_bytes(pool) -> int:
    """Device bytes the allocator holds in the graph pool ``pool``."""
    want = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == want)


class CapturedIteration:
    """The two graphs of one (bundle, device, iteration key) and their
    static buffers. ``lock`` is held by the one run that uses them.

    Each graph comes with the GAS counts recorded into it
    (``gas_kernel.recorded_counts``: launches, edges, exact edges), which
    each of its replays adds to ``gas_tiles``'s counters; ``keep``
    holds what the graphs read outside their pool (the payloads and the
    store's aux), so that it outlives them; ``pool_bytes`` is what their
    pool holds, and :meth:`nbytes` that and the buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.graphs: Optional[tuple] = None
        self.bufs: Optional[tuple] = None
        self.cur = 0                  # the buffer that holds the props
        self.broken: Optional[str] = None
        self.pool_bytes = 0
        self._keep = None

    @property
    def captured(self) -> bool:
        return self.graphs is not None

    def nbytes(self) -> int:
        """Device bytes this capture holds: its graphs' pool and its two
        static property buffers."""
        bufs = self.bufs or ()
        return self.pool_bytes + sum(b.numel() * b.element_size()
                                     for b in bufs)

    def start(self, init: torch.Tensor) -> torch.Tensor:
        """Copy a run's initial properties into A; returns A."""
        if self.bufs is None:
            self.bufs = (torch.empty_like(init), torch.empty_like(init))
        self.bufs[0].copy_(init)
        self.cur = 0
        return self.bufs[0]

    def capture(self, iteration: Callable, keep) -> torch.Tensor:
        """Run ``iteration`` (props -> new props) eagerly from A into B
        on the side stream, then record A→B and B→A. Returns B, the
        iteration's result. A failed recording sets ``broken`` and
        leaves B as the eager iteration wrote it."""
        a, b = self.bufs
        with _capture_lock, _side_stream(self.device):
            b.copy_(iteration(a))
            pool = torch.cuda.graph_pool_handle()
            graphs = []
            try:
                for src, dst in ((a, b), (b, a)):
                    before = gas_kernel.recorded_counts()
                    g = _record(lambda s=src, d=dst: d.copy_(iteration(s)),
                                pool)
                    graphs.append((g, {
                        name: n - before[name] for name, n in
                        gas_kernel.recorded_counts().items()}))
            except RuntimeError as exc:     # the CUDA error: kept, eager
                self.broken = f"{type(exc).__name__}: {exc}"
        if self.broken is None:
            self.graphs = tuple(graphs)
            self._keep = keep
            self.pool_bytes = _pool_bytes(pool)
        self.cur = 1
        return b

    def replay(self) -> torch.Tensor:
        """One iteration from the current buffer into the other, on this
        thread's current stream; returns the new properties."""
        g, counts = self.graphs[self.cur]
        g.replay()
        self.cur ^= 1
        gas_kernel.add_counts(counts)
        return self.bufs[self.cur]
