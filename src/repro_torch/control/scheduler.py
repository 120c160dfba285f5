"""Model-guided job scheduler: priority + deadline ordering with
admission control, replacing the serving layer's FIFO queue.

ReGraph's datapath routes each partition to the pipeline its cost
estimate says it belongs on; this is the same idea one level up. Every
queued job carries a *cost estimate* (seconds, from the perf model via
``PlanBundle.plan.est_makespan`` or a measured EWMA — the service
computes it, the scheduler just orders by it), a *priority* and an
optional *deadline*. The queue drains in

    (priority desc, deadline asc, estimated cost asc, arrival)

order: urgent work first, then earliest deadline, then
shortest-job-first among equals so cheap jobs never starve behind a
giant build of equal rank.

Admission control happens at push time and is *typed* — callers can
tell the difference and react (shed load, retry later, spill to
another service):

* :class:`QueueFull` — the bounded queue is at ``max_depth``.
* :class:`QuotaExceeded` — the tenant's token bucket is empty
  (:class:`TenantQuota` refills at ``rate`` jobs/s up to ``burst``).

Expired-deadline jobs are load-shed lazily when they surface at the
queue head (shed-on-pop): the scheduler never scans the heap, and a
worker never wastes a slot executing a job whose caller has already
given up. Shed entries fire the ``on_shed`` callback OUTSIDE the
scheduler lock — the serving layer resolves handles there and its
bookkeeping re-enters its own locks.

The heap uses lazy invalidation (``remove`` / ``reprioritize`` mark
entries dead rather than re-heapify), and sentinels — used by the
service's ``close()`` to stop workers — sort after every real job so a
drain always finishes queued work first.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

__all__ = ["JobScheduler", "TenantQuota", "RejectedJob", "QueueFull",
           "QuotaExceeded", "DeadlineExpired"]


class RejectedJob(RuntimeError):
    """Base of all typed admission rejections (catch this to mean
    'the scheduler refused the job, nothing was enqueued')."""


class QueueFull(RejectedJob):
    """push() on a queue already holding ``max_depth`` jobs."""


class QuotaExceeded(RejectedJob):
    """push() by a tenant whose token bucket is empty."""


class DeadlineExpired(RejectedJob):
    """The job was load-shed: its deadline passed while it waited.
    Never raised by push() — the serving layer sets it on the shed
    job's handles from the ``on_shed`` callback."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Token-bucket admission quota: ``rate`` jobs/second sustained,
    ``burst`` jobs instantaneously. A tenant with no quota is
    unlimited."""

    rate: float
    burst: float = 1.0

    def __post_init__(self):
        if self.rate <= 0 or self.burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, got "
                             f"rate={self.rate}, burst={self.burst}")


class _Entry:
    __slots__ = ("key", "item", "tenant", "deadline", "valid", "t_push")

    def __init__(self, key, item, tenant, deadline,
                 t_push: Optional[float] = None):
        self.key = key
        self.item = item
        self.tenant = tenant
        self.deadline = deadline
        self.valid = True
        # wall anchor for the queue-wait distribution (observability);
        # reprioritized entries inherit it so the wait stays honest
        self.t_push = time.perf_counter() if t_push is None else t_push

    def __lt__(self, other):        # heapq compares entries directly
        return self.key < other.key


class JobScheduler:
    """Priority + deadline + cost ordered job queue with per-tenant
    admission control.

    Parameters
    ----------
    max_depth: bound on queued (not yet popped) real jobs; pushes past
        it raise :class:`QueueFull`. None = unbounded.
    default_quota: :class:`TenantQuota` applied to every tenant without
        an explicit entry in ``quotas``; None = unlimited.
    quotas: per-tenant quota overrides (tenant name -> TenantQuota).
    clock: monotonic-seconds source; deadlines and bucket refills read
        it (injectable for tests).
    on_shed: callback ``(item) -> None`` fired — outside the scheduler
        lock — for each job load-shed because its deadline expired
        before a worker reached it.
    """

    def __init__(self, max_depth: Optional[int] = None,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_shed: Optional[Callable] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.default_quota = default_quota
        self.quotas = dict(quotas or {})
        self.on_shed = on_shed
        self._clock = clock
        self._cv = threading.Condition()
        self._heap: list = []
        self._index: Dict[object, _Entry] = {}   # queued item -> entry
        self._seq = 0
        # tenant -> [tokens, last_refill_time]; created lazily
        self._buckets: Dict[str, list] = {}
        self._depth_by_tenant: Dict[str, int] = {}
        self.pushed = self.popped = self.shed = 0
        self.rejected_full = self.rejected_quota = 0
        # recent queue-wait samples (ms), popped and shed separately —
        # shed waits are deadline-censored and would skew the pop p99
        self._wait_ms: deque = deque(maxlen=2048)
        self._shed_wait_ms: deque = deque(maxlen=512)

    # -- admission ------------------------------------------------------
    def _quota_for(self, tenant: str) -> Optional[TenantQuota]:
        return self.quotas.get(tenant, self.default_quota)

    def _admit(self, tenant: str) -> None:
        """Depth + token-bucket check; charges one token on success.
        Caller holds the lock."""
        if (self.max_depth is not None
                and len(self._index) >= self.max_depth):
            self.rejected_full += 1
            raise QueueFull(
                f"queue is at max_depth={self.max_depth}; retry later or "
                f"raise the bound")
        q = self._quota_for(tenant)
        if q is None:
            return
        now = self._clock()
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = [q.burst, now]
        tokens, last = b
        tokens = min(q.burst, tokens + (now - last) * q.rate)
        if tokens < 1.0:
            b[0], b[1] = tokens, now
            self.rejected_quota += 1
            raise QuotaExceeded(
                f"tenant {tenant!r} is over quota "
                f"(rate={q.rate}/s, burst={q.burst}); retry in "
                f"{(1.0 - tokens) / q.rate:.3f}s")
        b[0], b[1] = tokens - 1.0, now

    # -- producing ------------------------------------------------------
    def push(self, item, *, tenant: str = "default", priority: int = 0,
             deadline: Optional[float] = None, cost: float = 0.0) -> None:
        """Enqueue ``item``. ``priority``: larger drains first.
        ``deadline``: absolute clock() time after which the job is shed
        instead of run (None = never). ``cost``: estimated seconds of
        work — the SJF tie-break among equal priority/deadline.

        Raises :class:`QueueFull` / :class:`QuotaExceeded`; on
        rejection nothing is enqueued and no token is charged for a
        full queue."""
        with self._cv:
            self._admit(tenant)
            self._seq += 1
            key = (-priority, deadline if deadline is not None else math.inf,
                   cost, self._seq)
            e = _Entry(key, item, tenant, deadline)
            self._index[item] = e
            heapq.heappush(self._heap, e)
            self._depth_by_tenant[tenant] = \
                self._depth_by_tenant.get(tenant, 0) + 1
            self.pushed += 1
            self._cv.notify()

    def push_sentinel(self, item) -> None:
        """Enqueue a drain marker that sorts after every real job (and
        every other sentinel pushed earlier), bypassing admission —
        close() must always be able to stop the workers."""
        with self._cv:
            self._seq += 1
            e = _Entry((math.inf, math.inf, math.inf, self._seq), item,
                       None, None)
            heapq.heappush(self._heap, e)
            self._cv.notify()

    # -- mutating queued jobs -------------------------------------------
    def remove(self, item) -> bool:
        """Drop a queued job (e.g. every handle cancelled). Returns
        False if it was already popped, shed or never pushed."""
        with self._cv:
            e = self._index.pop(item, None)
            if e is None:
                return False
            e.valid = False
            self._depth_by_tenant[e.tenant] -= 1
            return True

    def reprioritize(self, item, priority: int) -> bool:
        """Raise/lower a queued job's priority in place (a coalesced
        twin with higher priority boosts the job it piggybacks on).
        Deadline, cost and arrival order are preserved."""
        with self._cv:
            e = self._index.get(item)
            if e is None:
                return False
            if e.key[0] == -priority:
                return True
            e.valid = False
            ne = _Entry((-priority,) + e.key[1:], item, e.tenant,
                        e.deadline, t_push=e.t_push)
            self._index[item] = ne
            heapq.heappush(self._heap, ne)
            self._cv.notify()
            return True

    def deadline_of(self, item) -> Optional[float]:
        with self._cv:
            e = self._index.get(item)
            return e.deadline if e is not None else None

    # -- consuming ------------------------------------------------------
    def _try_pop_locked(self, shed_out: list):
        """Pop the best live entry; expired ones go to ``shed_out``.
        Returns (found, item). Caller holds the lock."""
        while self._heap:
            e = self._heap[0]
            if not e.valid:             # lazily invalidated
                heapq.heappop(self._heap)
                continue
            if (e.deadline is not None and self._clock() >= e.deadline):
                heapq.heappop(self._heap)
                e.valid = False
                self._index.pop(e.item, None)
                self._depth_by_tenant[e.tenant] -= 1
                self.shed += 1
                self._shed_wait_ms.append(
                    (time.perf_counter() - e.t_push) * 1e3)
                shed_out.append(e.item)
                continue
            heapq.heappop(self._heap)
            e.valid = False
            if e.tenant is not None:    # sentinels aren't indexed
                self._index.pop(e.item, None)
                self._depth_by_tenant[e.tenant] -= 1
                self.popped += 1
                self._wait_ms.append(
                    (time.perf_counter() - e.t_push) * 1e3)
            return True, e.item
        return False, None

    def pop(self, timeout: Optional[float] = None):
        """Dequeue the best job, blocking up to ``timeout`` seconds
        (None = forever, 0 = non-blocking). Returns None on timeout.
        Jobs whose deadline passed while queued are shed on the way —
        their ``on_shed`` callbacks fire before this returns."""
        end = None if timeout is None else self._clock() + timeout
        while True:
            shed: list = []
            with self._cv:
                while True:
                    found, item = self._try_pop_locked(shed)
                    if found or shed:
                        break
                    if end is not None:
                        remaining = end - self._clock()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    else:
                        self._cv.wait()
            if shed and self.on_shed is not None:
                for it in shed:         # outside the lock: callbacks
                    self.on_shed(it)    # take the service's own locks
            if found:
                return item
            if not shed:                # timed out with nothing to shed
                return None

    # -- reporting ------------------------------------------------------
    def qsize(self) -> int:
        """Queued real jobs (sentinels and invalidated entries don't
        count)."""
        with self._cv:
            return len(self._index)

    @staticmethod
    def _pct(xs, p: float) -> Optional[float]:
        """Nearest-rank percentile of a sample sequence; None if empty."""
        if not xs:
            return None
        xs = sorted(xs)
        rank = max(0, min(len(xs) - 1,
                          int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[rank]

    def stats(self) -> dict:
        with self._cv:
            waits = list(self._wait_ms)
            shed_waits = list(self._shed_wait_ms)
            return {
                "depth": len(self._index),
                "depth_by_tenant": {t: n for t, n
                                    in self._depth_by_tenant.items() if n},
                "pushed": self.pushed,
                "popped": self.popped,
                "shed": self.shed,
                "rejected_queue_full": self.rejected_full,
                "rejected_quota": self.rejected_quota,
                "max_depth": self.max_depth,
                # queue-wait distribution over the recent sample window
                # (popped jobs; shed waits reported separately — they
                # are deadline-censored)
                "queue_wait_p50_ms": self._pct(waits, 50),
                "queue_wait_p99_ms": self._pct(waits, 99),
                "shed_wait_p50_ms": self._pct(shed_waits, 50),
            }
