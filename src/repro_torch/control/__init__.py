"""Job-oriented control plane for the serving layer.

Promotes :class:`~repro_torch.serve_graph.GraphService` from worker threads
draining a FIFO to a managed fleet:

* :mod:`~repro_torch.control.scheduler` — priority + deadline + model-cost
  ordered queue with per-tenant token-bucket admission control and
  expired-deadline load-shed (the FIFO replacement; the service uses
  it internally).
* :mod:`~repro_torch.control.pool` — process-pool worker tier for CPU-heavy
  store builds and delta splices (the GIL relief; pass ``pool=`` to
  the service).
* :mod:`~repro_torch.control.jobs` — persistent job-status records
  (submitted → queued → running → done/failed/cancelled/expired) with
  per-stage timestamps and bounded logs.
* :mod:`~repro_torch.control.manager` — :class:`ControlPlane`, tying a
  service to a job store and an observer pipeline.
* :mod:`~repro_torch.control.http_api` — minimal stdlib JSON API over the
  manager (``POST /jobs``, ``GET /jobs/{id}``, chunked
  ``GET /jobs/{id}/logs``, Prometheus ``GET /metrics``), modeled on
  Ray's dashboard job API.

The scheduler and pool are imported eagerly (the service layers on
them); the manager stack is loaded lazily via PEP 562 because it
imports the serving layer back.

The port of the reference package's ``control``; the scheduler, job
store, HTTP routes and dashboard are framework-free copies.
"""
from .pool import WorkerCrashed, WorkerPool
from .scheduler import (DeadlineExpired, JobScheduler, QueueFull,
                        QuotaExceeded, RejectedJob, TenantQuota)

__all__ = [
    "ControlPlane", "DeadlineExpired", "JobRecord", "JobScheduler",
    "JobStore", "QueueFull", "QuotaExceeded", "RejectedJob", "TenantQuota",
    "WorkerCrashed", "WorkerPool", "serve_jobs",
]

_LAZY = {
    "ControlPlane": "manager",
    "JobRecord": "jobs",
    "JobStore": "jobs",
    "serve_jobs": "http_api",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
