"""Byte-budgeted LRU of GraphStores for multi-graph serving.

A production service holds many prepared graphs at once; each
GraphStore pins the partition-sorted edge arrays, memoized blockings,
and (via its plan LRU) device-resident lane entries. This cache bounds
that by bytes (``GraphStore.memory_footprint()``) and/or entry count,
evicting least-recently-used stores first.

Two safety properties the serving layer relies on:

* **Pinning** — a worker leases a store for the duration of a request
  (``with cache.lease(key): ...``). Pinned entries are never evicted,
  so an in-flight Executor's store can't be torn down under it; the
  budget is exceeded temporarily rather than breaking the request.
* **Eviction releases device memory** — evicting calls
  ``store.clear_plans()``, dropping the cached PlanBundles and the
  device lane entries they pin. Executors still running on an evicted
  store keep their own bundle references and finish normally.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from ..core.store import GraphStore
from .fingerprint import StoreKey

__all__ = ["GraphStoreCache"]


class _Entry:
    __slots__ = ("store", "nbytes", "pins", "ready", "retired")

    def __init__(self, store: Optional[GraphStore], nbytes: int):
        self.store = store
        self.nbytes = nbytes
        self.pins = 0
        # unset while a lease() build function is making the store OUTSIDE
        # the cache lock; waiters block on it instead of on the lock
        self.ready = threading.Event()
        # retire(): evict as soon as the last lease releases (streaming
        # re-key — the old snapshot drains, it is never torn down)
        self.retired = False
        if store is not None:
            self.ready.set()


class GraphStoreCache:
    """LRU of GraphStores keyed by (fingerprint, Geometry, use_dbg).

    Parameters
    ----------
    byte_budget: soft cap on the summed ``memory_footprint()`` of cached
        stores; None = unbounded. Exceeding the cap evicts unpinned LRU
        entries until back under (or until only pinned entries remain —
        the budget is a target, never a reason to break a request).
    max_stores: cap on the number of cached stores; None = unbounded.
    on_evict: optional callback ``(key, store) -> None`` (metrics).
    """

    def __init__(self, byte_budget: Optional[int] = None,
                 max_stores: Optional[int] = None,
                 on_evict: Optional[Callable] = None):
        if byte_budget is not None and byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got "
                             f"{byte_budget}")
        if max_stores is not None and max_stores < 1:
            raise ValueError(f"max_stores must be >= 1, got {max_stores}")
        self.byte_budget = byte_budget
        self.max_stores = max_stores
        self.on_evict = on_evict
        self._lock = threading.RLock()
        self._entries: "OrderedDict[StoreKey, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.freed_plan_bytes = 0   # device bytes released by evictions

    # -- core ops -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: StoreKey) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self):
        with self._lock:
            return list(self._entries)

    @property
    def current_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def get(self, key: StoreKey) -> Optional[GraphStore]:
        """Fetch + touch (counts as hit/miss). An entry still being
        built by a concurrent lease() is waited for; if that build
        fails, this falls through to a miss (never a None "hit")."""
        while True:
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    self.misses += 1
                    return None
                if e.ready.is_set():
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return e.store
                waiter = e
            waiter.ready.wait()     # then re-examine: ready or removed

    def peek(self, key: StoreKey) -> Optional[GraphStore]:
        """Non-counting, non-touching read: the store if it is cached
        and ready, else None. The scheduler's cost estimator uses this —
        an estimate must not distort hit rates or LRU order, and must
        never block on an in-flight build."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or not e.ready.is_set():
                return None
            return e.store

    def get_or_build(self, key: StoreKey,
                     build: Callable[[], GraphStore]
                     ) -> Tuple[GraphStore, bool]:
        """Return ``(store, was_hit)``; on miss, run ``build`` and
        insert. Concurrent misses on one key build exactly once (the
        first caller builds, the rest wait on its latch), and the build
        itself runs outside the cache lock."""
        with self.lease(key, build) as (store, hit):
            return store, hit

    def put(self, key: StoreKey, store: GraphStore) -> None:
        with self._lock:
            if key in self._entries:
                self._entries[key].store = store
                self.refresh_bytes(key)
                self._entries.move_to_end(key)
            else:
                self._insert(key, store)

    def refresh_bytes(self, key: StoreKey) -> None:
        """Re-measure one store's footprint (it grows as plans/blockings
        are cached on it) and re-enforce the budget. Measurement happens
        off-lock (it takes the store's plan lock — see lease())."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or not e.ready.is_set():
                return
            store = e.store
        nbytes = store.memory_footprint()["total_bytes"]
        with self._lock:
            if self._entries.get(key) is e:
                e.nbytes = nbytes
                self._evict_as_needed()

    # -- pinning --------------------------------------------------------
    @contextlib.contextmanager
    def lease(self, key: StoreKey,
              build: Optional[Callable[[], GraphStore]] = None):
        """Pin a store for the duration of a with-block; yields
        ``(store, was_hit)``. Pinned stores are never evicted, so the
        leased store outlives any concurrent budget pressure.

        On a miss ``build`` runs OUTSIDE the cache lock (store builds
        take seconds — serializing every worker behind one build would
        defeat ``workers > 1``): the missing key gets a pinned
        placeholder whose latch concurrent leases of the same key wait
        on, while leases of other keys proceed untouched.
        """
        e, hit, must_build = self._acquire(key, build)
        if must_build:
            try:
                store = build()
            except BaseException:
                with self._lock:
                    e.pins -= 1
                    if self._entries.get(key) is e:
                        del self._entries[key]
                e.ready.set()       # waiters retry, one of them builds
                raise
            # measure OUTSIDE the cache lock: memory_footprint() takes
            # the store's plan lock, which another worker may hold for
            # seconds while planning — blocking the whole cache on it
            # would stall every key
            nbytes = store.memory_footprint()["total_bytes"]
            with self._lock:
                e.store = store
                e.nbytes = nbytes
                e.ready.set()
                self._evict_as_needed()
        try:
            yield e.store, hit
        finally:
            # re-measure (plans/blockings accrued during the lease)
            # off-lock, then re-enforce the budget now it's evictable
            nbytes = e.store.memory_footprint()["total_bytes"]
            with self._lock:
                e.pins -= 1
                e.nbytes = nbytes
                if (e.retired and e.pins == 0
                        and self._entries.get(key) is e):
                    self._evict_one(key)   # deferred retire: drained now
                self._evict_as_needed()

    def _acquire(self, key: StoreKey, build) -> Tuple[_Entry, bool, bool]:
        """Pin an entry for lease(); returns (entry, was_hit,
        caller_must_build). Blocks (outside the lock) while another
        thread is building the same key."""
        while True:
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    if build is None:
                        raise KeyError(f"store {key!r} not cached and "
                                       f"no build function given")
                    self.misses += 1
                    e = _Entry(None, 0)        # building placeholder
                    self._entries[key] = e
                    e.pins += 1     # pinned before any budget check, so
                    return e, False, True      # it can't be the victim
                if e.ready.is_set():
                    self.hits += 1
                    self._entries.move_to_end(key)
                    e.pins += 1
                    return e, True, False
                waiter = e
            # build in flight: wait on its latch, then re-examine — the
            # entry is either ready (hit) or gone (failed build; we
            # build it next)
            waiter.ready.wait()

    def pin_count(self, key: StoreKey) -> int:
        with self._lock:
            e = self._entries.get(key)
            return e.pins if e is not None else 0

    # -- eviction -------------------------------------------------------
    def evict(self, key: StoreKey, force: bool = False) -> bool:
        """Explicitly drop one entry. Pinned entries are only dropped
        with ``force=True`` (the leasing worker keeps its reference, so
        even a forced drop never invalidates in-flight work)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return False
            if e.pins > 0 and not force:
                return False
            self._evict_one(key)
            return True

    def retire(self, key: StoreKey) -> str:
        """Streaming re-key: evict ``key`` as soon as it is unpinned.
        Unlike :meth:`evict`, a pinned (or still-building) entry is not
        skipped but *marked* — the last lease release evicts it, so
        in-flight requests finish against the old snapshot and the
        entry disappears the moment it drains. A re-lease racing the
        drain simply extends it: the old fingerprint remains a valid
        identity for the old graph until the entry actually goes.

        Returns ``"now"`` (evicted immediately), ``"deferred"``
        (pinned/building; will evict on drain) or ``"absent"``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return "absent"
            if e.pins == 0 and e.ready.is_set():
                self._evict_one(key)
                return "now"
            e.retired = True
            return "deferred"

    def clear(self) -> int:
        with self._lock:
            n = 0
            for key in list(self._entries):
                if self._entries[key].pins == 0:
                    self._evict_one(key)
                    n += 1
            return n

    def _insert(self, key: StoreKey, store: GraphStore) -> None:
        self._entries[key] = _Entry(
            store, store.memory_footprint()["total_bytes"])
        self._evict_as_needed()

    def _evict_one(self, key: StoreKey) -> None:
        e = self._entries.pop(key)
        if e.store is not None:    # release device-resident lane entries
            self.freed_plan_bytes += e.store.clear_plans()["freed_bytes"]
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(key, e.store)

    def _evict_as_needed(self) -> None:
        """LRU-evict until under both budgets. Callers hold the lock.
        Pinned entries and the MRU entry are never victims — a single
        store bigger than the whole budget is admitted (soft cap) rather
        than thrashing the cache empty; the budget is re-enforced on the
        next insert/release."""

        def over() -> bool:
            if (self.max_stores is not None
                    and len(self._entries) > self.max_stores):
                return True
            if self.byte_budget is not None:
                total = sum(e.nbytes for e in self._entries.values())
                return total > self.byte_budget
            return False

        while over():
            mru = next(reversed(self._entries))
            victim = next((k for k, e in self._entries.items()
                           if e.pins == 0 and k != mru), None)
            if victim is None:     # all pinned (or only MRU left)
                break
            self._evict_one(victim)

    # -- reporting ------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "stores": len(self._entries),
                "current_bytes": sum(e.nbytes
                                     for e in self._entries.values()),
                "byte_budget": self.byte_budget,
                "max_stores": self.max_stores,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "freed_plan_bytes": self.freed_plan_bytes,
                "hit_rate": (self.hits / (self.hits + self.misses)
                             if (self.hits + self.misses) else 0.0),
                "pinned": sum(1 for e in self._entries.values()
                              if e.pins > 0),
            }
