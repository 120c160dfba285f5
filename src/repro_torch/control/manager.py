"""ControlPlane — a GraphService with job records and an HTTP face.

Ties the pieces together: every submission becomes a
:class:`~repro_torch.control.jobs.JobRecord` whose lifecycle is driven by
the service's observer callbacks (queued → running → done/failed/
expired), results are fetched by job id, and the whole thing exposes
one merged metrics snapshot (service + scheduler + pool + store cache
+ job store) for ``GET /metrics``. The service can be passed in (the
control plane then shares it and leaves closing it to the owner) or
constructed from kwargs (owned, closed with the plane).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .. import obs
from ..graphs.formats import Graph
from ..serve_graph.metrics import merge_expositions
from ..serve_graph.service import GraphService, RequestHandle
from ..streaming import GraphDelta
from .jobs import JobRecord, JobState, JobStore
from .scheduler import QueueFull, RejectedJob

__all__ = ["ControlPlane"]

# observer event -> job state (shed maps to EXPIRED: the deadline
# passed; cancelled is driven by cancel_job, not the observer)
_EVENT_STATE = {
    "queued": JobState.QUEUED,
    "running": JobState.RUNNING,
    "done": JobState.DONE,
    "failed": JobState.FAILED,
    "shed": JobState.EXPIRED,
    "cancelled": JobState.CANCELLED,
}


class ControlPlane:
    """Job-oriented management layer over a :class:`GraphService`.

    Parameters
    ----------
    service: an existing service to manage (not closed by this plane);
        None builds one from ``service_kwargs`` (owned) — on ``cuda``
        unless they name ``device="cpu"``, and raising when there is no
        CUDA device and no ``device="cpu"``.
    jobs: a :class:`JobStore` (e.g. with ``persist_path`` set); None
        builds a default one.
    tracer: the :class:`~repro_torch.obs.Tracer` for end-to-end job traces.
        None reuses the service's tracer, or installs a fresh one without
        lane detail on a service that has none (the fused run, with no
        added synchronization) — the plane always traces, so
        ``GET /jobs/{id}/trace`` works out of the box.
    """

    def __init__(self, service: Optional[GraphService] = None, *,
                 jobs: Optional[JobStore] = None,
                 tracer: Optional[obs.Tracer] = None, **service_kwargs):
        self._owns_service = service is None
        if service is None and tracer is not None:
            service_kwargs.setdefault("tracer", tracer)
        self.service = service or GraphService(**service_kwargs)
        if self.service.tracer is None:
            self.service.tracer = tracer or obs.Tracer(lane_detail=False)
        self.tracer = self.service.tracer
        self.jobs = jobs or JobStore()
        self._lock = threading.Lock()
        self._handles: Dict[str, RequestHandle] = {}
        self._http_server = None

    # -- lifecycle ------------------------------------------------------
    def __enter__(self) -> "ControlPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, wait: bool = True) -> None:
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server = None
        if self._owns_service:
            self.service.close(wait=wait)

    # -- job submission -------------------------------------------------
    def register(self, graph: Graph, **kw) -> str:
        return self.service.register(graph, **kw)

    def submit_job(self, graph=None, app: str = "pagerank", *,
                   fingerprint: Optional[str] = None,
                   tenant: str = "default", priority: int = 0,
                   deadline: Optional[float] = None,
                   **submit_kwargs) -> JobRecord:
        """Submit a run as a tracked job. Returns its record
        immediately; fetch the outcome with :meth:`result`. Admission
        rejections and bad requests still raise (typed), but the
        record survives in state ``rejected``/``failed`` so the
        refusal is queryable afterwards."""
        t_submit = time.time()
        rec = self.jobs.create(
            kind="run", tenant=tenant, priority=priority,
            deadline=deadline, app=app if isinstance(app, str) else app.name,
            fingerprint=(fingerprint if fingerprint is not None
                         else graph if isinstance(graph, str) else None))
        jid = rec.id
        handle_stored = threading.Event()

        def observer(event: str, info: dict) -> None:
            state = _EVENT_STATE.get(event)
            if event == "coalesced":
                self.jobs.mark_coalesced(jid)
                self.jobs.transition(jid, JobState.QUEUED,
                                     log="queued (coalesced)")
            elif state is not None:
                metrics = None
                if state in JobState.TERMINAL:
                    # a job can finish before submit_job() stores the
                    # handle — wait for it so terminal records always
                    # carry their request metrics
                    handle_stored.wait(5.0)
                    metrics = self._metrics_of(jid)
                self.jobs.transition(jid, state,
                                     error=info.get("error"),
                                     metrics=metrics)
        try:
            handle = self.service.submit(
                graph, app, fingerprint=fingerprint, tenant=tenant,
                priority=priority, deadline=deadline, observer=observer,
                **submit_kwargs)
        except RejectedJob as exc:
            kind = ("queue full" if isinstance(exc, QueueFull)
                    else "quota exceeded")
            self.jobs.transition(jid, JobState.REJECTED, error=str(exc),
                                 log=f"rejected at admission: {kind}")
            raise
        except Exception as exc:
            self.jobs.transition(jid, JobState.FAILED, error=str(exc))
            raise
        ctx = getattr(handle, "trace_ctx", None)
        if ctx is not None:
            self.jobs.set_trace(jid, ctx.trace_id)
            # backdated so the span covers record creation + admission
            self.tracer.start_span("control.submit", "control", parent=ctx,
                                   t_start=t_submit, job_id=jid).end()
        with self._lock:
            self._handles[jid] = handle
        handle_stored.set()
        with self._lock:
            if len(self._handles) > 4 * self.jobs.max_records:
                # results of long-forgotten jobs: drop oldest resolved
                for k in list(self._handles):
                    if len(self._handles) <= self.jobs.max_records:
                        break
                    if self._handles[k].done():
                        del self._handles[k]
        return rec

    def _metrics_of(self, job_id: str) -> Optional[dict]:
        with self._lock:
            h = self._handles.get(job_id)
        return h.metrics.as_dict() if h is not None else None

    def result(self, job_id: str, timeout: Optional[float] = None):
        """Block for a job's (props, meta); raises its failure (typed
        scheduler errors included) like ``RequestHandle.result``."""
        with self._lock:
            h = self._handles.get(job_id)
        if h is None:
            raise KeyError(f"unknown or unretained job {job_id!r}")
        return h.result(timeout=timeout)

    def cancel_job(self, job_id: str) -> bool:
        with self._lock:
            h = self._handles.get(job_id)
        if h is None or not self.service.cancel(h):
            return False
        self.jobs.transition(job_id, JobState.CANCELLED,
                             error="cancelled",
                             log="cancelled by request")
        return True

    # -- streaming updates as jobs --------------------------------------
    def update_job(self, fingerprint: str, delta: GraphDelta,
                   *, tenant: str = "default", **kw) -> JobRecord:
        """Run a streaming update synchronously as a tracked job (an
        update re-keys shared cache state; callers need the new
        fingerprint before their next submit, so there is no async
        form). The record's metrics carry the apply stats."""
        rec = self.jobs.create(kind="update", tenant=tenant,
                               app="update", fingerprint=fingerprint)
        self.jobs.transition(rec.id, JobState.RUNNING)
        try:
            res = self.service.update(fingerprint, delta, **kw)
        except Exception as exc:
            self.jobs.transition(rec.id, JobState.FAILED, error=str(exc))
            raise
        self.jobs.set_trace(rec.id, res.trace_id)
        self.jobs.transition(
            rec.id, JobState.DONE,
            metrics={"fingerprint": res.fingerprint, "mode": res.mode,
                     "retired": res.retired,
                     "t_update_ms": res.t_update_ms,
                     "stats": res.stats},
            log=f"update applied: {fingerprint[:12]}… -> "
                f"{res.fingerprint[:12]}… ({res.mode})")
        return self.jobs.get(rec.id)

    def compact_job(self, fingerprint: str, *,
                    tenant: str = "default") -> JobRecord:
        """Squash the delta chain behind a served snapshot
        (GraphService.compact_chain) as a tracked admin job; the
        record's metrics carry the before/after chain depth and the
        composed delta's change count."""
        rec = self.jobs.create(kind="compact", tenant=tenant,
                               app="compact", fingerprint=fingerprint)
        self.jobs.transition(rec.id, JobState.RUNNING)
        try:
            event = self.service.compact_chain(fingerprint)
        except Exception as exc:
            self.jobs.transition(rec.id, JobState.FAILED, error=str(exc))
            raise
        self.jobs.transition(
            rec.id, JobState.DONE, metrics=event,
            log=(f"chain compacted: depth {event['depth_before']} -> "
                 f"{event['depth_after']}") if event.get("compacted")
                else f"nothing to compact (depth "
                     f"{event['depth_before']})")
        return self.jobs.get(rec.id)

    def regroup_job(self, graph=None, *,
                    fingerprint: Optional[str] = None,
                    tenant: str = "default", force: bool = False,
                    **kw) -> JobRecord:
        """Run a grouping-drift check — and, past the threshold or
        with ``force=True``, the fresh-DBG re-registration swap
        (GraphService.regroup_now) — as a tracked admin job. The
        record's metrics carry the drift event (misclassification
        rate, dense frontier before/after, applied flag)."""
        rec = self.jobs.create(kind="regroup", tenant=tenant,
                               app="regroup",
                               fingerprint=fingerprint or "")
        self.jobs.transition(rec.id, JobState.RUNNING)
        try:
            event = self.service.regroup_now(graph,
                                             fingerprint=fingerprint,
                                             force=force, **kw)
        except Exception as exc:
            self.jobs.transition(rec.id, JobState.FAILED, error=str(exc))
            raise
        self.jobs.transition(
            rec.id, JobState.DONE, metrics=event,
            log=(f"regroup applied: drift {event['drift']:.3f}")
                if event.get("applied")
                else f"regroup skipped: drift {event['drift']:.3f} "
                     f"under threshold")
        return self.jobs.get(rec.id)

    def retune_job(self, graph=None, *, fingerprint: Optional[str] = None,
                   app: str = "pagerank", tenant: str = "default",
                   **kw) -> JobRecord:
        """Force a calibrate-and-replan cycle (GraphService.retune_now)
        as a tracked admin job. Requires the service to have been built
        with ``autotune=``; the record's metrics carry the retune event
        (fit diagnostics, candidate scores, chosen plan)."""
        rec = self.jobs.create(kind="retune", tenant=tenant, app=app,
                               fingerprint=fingerprint or "")
        self.jobs.transition(rec.id, JobState.RUNNING)
        try:
            event = self.service.retune_now(graph, fingerprint=fingerprint,
                                            app=app, **kw)
        except Exception as exc:
            self.jobs.transition(rec.id, JobState.FAILED, error=str(exc))
            raise
        chosen = event.get("chosen") or {}
        self.jobs.transition(
            rec.id, JobState.DONE, metrics=event,
            log=("retune applied: " + str(chosen)) if event.get("applied")
                else f"retune rejected: {event.get('rejected')}")
        return self.jobs.get(rec.id)

    # -- reporting ------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        snap = self.service.stats()
        snap["jobs"] = self.jobs.stats()
        return snap

    def ready(self) -> dict:
        """Readiness probe body for ``GET /readyz``: the plane can take
        and execute work — the scheduler is accepting submissions AND
        (when a process pool exists) every pool worker slot is usable.
        Liveness (``/healthz``) stays unconditional; this is the
        load-balancer signal to stop routing before close()."""
        accepting = self.service.accepting
        pool = self.service._pool
        pool_alive = pool.alive() if pool is not None else True
        return {
            "ready": bool(accepting and pool_alive),
            "scheduler_accepting": bool(accepting),
            "pool_alive": bool(pool_alive),
            "queue_depth": int(
                self.service._scheduler.stats()["depth"]),
        }

    def trace(self, job_id: str) -> Optional[dict]:
        """The job's distributed trace as a Chrome-trace dict (load it
        at ``chrome://tracing`` or https://ui.perfetto.dev), or None if
        the job is unknown, predates tracing, or its trace was evicted
        from the tracer's bounded ring."""
        rec = self.jobs.get(job_id)
        if rec is None or rec.trace_id is None:
            return None
        if rec.trace_id not in self.tracer.trace_ids():
            return None
        return self.tracer.to_chrome_trace(trace_id=rec.trace_id)

    def prometheus(self) -> str:
        """Service metrics in Prometheus text form, merged with the
        control-plane gauges (scheduler depth, pool and job-store
        state) into one exposition — families are deduped so a scraper
        never sees a repeated HELP/TYPE header."""
        sched = self.service._scheduler.stats()
        blocks = [self.service.metrics.render_prometheus(),
                  "# HELP regraph_scheduler_depth Queued jobs.\n"
                  "# TYPE regraph_scheduler_depth gauge\n"
                  f"regraph_scheduler_depth {sched['depth']}\n"]
        pool = self.service._pool
        if pool is not None:
            p = pool.stats()
            blocks.append("# HELP regraph_pool_jobs_total Jobs run in "
                          "the process pool.\n"
                          "# TYPE regraph_pool_jobs_total counter\n"
                          f"regraph_pool_jobs_total {p['jobs']}\n"
                          "# HELP regraph_pool_crashes_total Worker "
                          "process crashes.\n"
                          "# TYPE regraph_pool_crashes_total counter\n"
                          f"regraph_pool_crashes_total {p['crashes']}\n")
        j = self.jobs.stats()
        job_lines = ["# HELP regraph_jobs Jobs by lifecycle state.",
                     "# TYPE regraph_jobs gauge"]
        for state, n in sorted(j["by_state"].items()):
            job_lines.append(f'regraph_jobs{{state="{state}"}} {n}')
        blocks.append("\n".join(job_lines) + "\n")
        return merge_expositions(*blocks)

    # -- HTTP -----------------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the JSON job API on a daemon thread; returns
        ``(server, base_url)``. ``port=0`` picks a free port."""
        from .http_api import serve_jobs
        server, url = serve_jobs(self, host=host, port=port)
        self._http_server = server
        return server, url
