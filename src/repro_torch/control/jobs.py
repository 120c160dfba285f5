"""Persistent job-status records for the control plane.

Every submitted job gets a :class:`JobRecord` that tracks its lifecycle

    submitted → queued → running → done
                   \\          \\→ failed
                    \\→ expired (deadline load-shed)
                    \\→ cancelled
    (rejected: refused at admission, never queued)

with a per-stage timestamp for each transition, a bounded log buffer
(each line stamped ``[<epoch seconds>] <LEVEL> <message>`` so lines
from different processes/machines sort and diff without timezone
games), and — once terminal — the request's latency/cache metrics. The
:class:`JobStore` holds the records thread-safely, bounds retention by
evicting the oldest *terminal* records, serves chunked log reads for
the HTTP API's streaming endpoint, and can mirror terminal records to
a JSONL file so job history survives the process (the "persistent" in
persistent job-status store; modeled on Ray's dashboard job records).
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["JobRecord", "JobState", "JobStore"]


class JobState:
    """String constants for the lifecycle states (kept as plain strings
    so records JSON-serialize without an enum layer)."""

    SUBMITTED = "submitted"
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    EXPIRED = "expired"          # deadline load-shed while queued
    REJECTED = "rejected"        # typed admission refusal; never queued

    TERMINAL = frozenset({DONE, FAILED, CANCELLED, EXPIRED, REJECTED})
    ALL = frozenset({SUBMITTED, QUEUED, RUNNING}) | TERMINAL


_RANK = {JobState.SUBMITTED: 0, JobState.QUEUED: 1, JobState.RUNNING: 2}
_RANK.update({s: 3 for s in JobState.TERMINAL})


class JobRecord:
    """One job's lifecycle. Mutated only through :class:`JobStore`
    methods (which hold the store lock); readers get copies via
    :meth:`to_dict`."""

    __slots__ = ("id", "kind", "tenant", "priority", "deadline", "app",
                 "fingerprint", "state", "error", "coalesced",
                 "timestamps", "metrics", "logs", "trace_id")

    def __init__(self, id: str, kind: str, tenant: str, priority: int,
                 deadline: Optional[float], app: str,
                 fingerprint: Optional[str], log_lines: int = 256):
        self.id = id
        self.kind = kind                  # "run" | "update"
        self.tenant = tenant
        self.priority = priority
        self.deadline = deadline          # relative seconds, as submitted
        self.app = app
        self.fingerprint = fingerprint
        self.state = JobState.SUBMITTED
        self.error: Optional[str] = None
        self.coalesced = False
        # state -> unix time of the transition INTO it
        self.timestamps: Dict[str, float] = {
            JobState.SUBMITTED: time.time()}
        self.metrics: Optional[dict] = None
        self.logs: Deque[str] = deque(maxlen=log_lines)
        self.trace_id: Optional[str] = None

    def to_dict(self, with_logs: bool = False) -> dict:
        d = {
            "id": self.id, "kind": self.kind, "tenant": self.tenant,
            "priority": self.priority, "deadline": self.deadline,
            "app": self.app, "fingerprint": self.fingerprint,
            "state": self.state, "error": self.error,
            "coalesced": self.coalesced, "trace_id": self.trace_id,
            "timestamps": dict(self.timestamps),
            "metrics": self.metrics,
            "terminal": self.state in JobState.TERMINAL,
        }
        if with_logs:
            d["logs"] = list(self.logs)
        return d


class JobStore:
    """Thread-safe registry of :class:`JobRecord`, bounded by evicting
    the oldest terminal records past ``max_records``.

    Parameters
    ----------
    max_records: retention bound. Live (non-terminal) records are never
        evicted — the bound is exceeded rather than forgetting a
        running job.
    log_lines: per-job log ring size.
    persist_path: optional JSONL file; each record is appended once, on
        reaching a terminal state (job history survives the process).
    """

    def __init__(self, max_records: int = 1024, log_lines: int = 256,
                 persist_path: Optional[str] = None):
        if max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.max_records = max_records
        self.log_lines = log_lines
        self.persist_path = persist_path
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, JobRecord]" = OrderedDict()
        self._seq = 0
        # log readers need a stable offset across the deque's rotation:
        # dropped_of[id] counts lines that fell off the ring's left edge
        self._dropped: Dict[str, int] = {}

    # -- creation & transitions -----------------------------------------
    def create(self, *, kind: str, tenant: str = "default",
               priority: int = 0, deadline: Optional[float] = None,
               app: str = "", fingerprint: Optional[str] = None
               ) -> JobRecord:
        with self._lock:
            self._seq += 1
            jid = f"job-{self._seq:08d}"
            rec = JobRecord(jid, kind, tenant, priority, deadline, app,
                            fingerprint, log_lines=self.log_lines)
            self._records[jid] = rec
            self._dropped[jid] = 0
            self._evict_locked()
            self._append_log_locked(
                rec, f"submitted app={app} tenant={tenant} "
                     f"priority={priority}")
            return rec

    def transition(self, job_id: str, state: str,
                   error: Optional[str] = None,
                   metrics: Optional[dict] = None,
                   log: Optional[str] = None) -> Optional[JobRecord]:
        """Move a job to ``state`` (stamping the transition time).
        Transitions never move backwards: a job already terminal stays
        put (late observer callbacks after a cancel must not resurrect
        it), and a "queued" racing in after "running" — observers fire
        outside the service locks — is dropped. Returns the record or
        None."""
        if state not in JobState.ALL:
            raise ValueError(f"unknown job state {state!r}")
        persist = None
        with self._lock:
            rec = self._records.get(job_id)
            if (rec is None or rec.state in JobState.TERMINAL
                    or _RANK[state] < _RANK[rec.state]):
                return rec
            rec.state = state
            rec.timestamps[state] = time.time()
            if error is not None:
                rec.error = error
            if metrics is not None:
                rec.metrics = metrics
            self._append_log_locked(
                rec, log if log is not None else f"-> {state}",
                level=("error" if error is not None
                       or state == JobState.FAILED else "info"))
            if state in JobState.TERMINAL and self.persist_path:
                persist = rec.to_dict(with_logs=True)
        if persist is not None:
            self._persist(persist)
        return rec

    def set_trace(self, job_id: str, trace_id: Optional[str]) -> None:
        """Attach the distributed-trace id once the service hands the
        submission's context back (coalesced jobs get the id of the
        in-flight job they merged into)."""
        if trace_id is None:
            return
        with self._lock:
            rec = self._records.get(job_id)
            if rec is not None:
                rec.trace_id = trace_id

    def mark_coalesced(self, job_id: str) -> None:
        with self._lock:
            rec = self._records.get(job_id)
            if rec is not None:
                rec.coalesced = True
                self._append_log_locked(
                    rec, "coalesced onto an identical in-flight job")

    def append_log(self, job_id: str, line: str,
                   level: str = "info") -> None:
        with self._lock:
            rec = self._records.get(job_id)
            if rec is not None:
                self._append_log_locked(rec, line, level=level)

    def _append_log_locked(self, rec: JobRecord, line: str,
                           level: str = "info") -> None:
        # lines stay plain strings (streamed verbatim over the chunked
        # /logs endpoint): epoch-seconds stamp + upper-case level prefix
        if len(rec.logs) == rec.logs.maxlen:
            self._dropped[rec.id] = self._dropped.get(rec.id, 0) + 1
        rec.logs.append(f"[{time.time():.3f}] {level.upper()} {line}")

    # -- queries --------------------------------------------------------
    def get(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._records.get(job_id)

    def list(self, tenant: Optional[str] = None,
             state: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [r.to_dict() for r in self._records.values()
                    if (tenant is None or r.tenant == tenant)
                    and (state is None or r.state == state)]

    def read_logs(self, job_id: str, offset: int = 0,
                  limit: int = 64) -> Tuple[List[str], int, bool]:
        """Chunked log read: lines ``[offset, offset+limit)`` in the
        job's absolute line numbering. Returns ``(lines, next_offset,
        done)`` — ``done`` once the job is terminal and the reader has
        caught up, so a streaming client knows to stop following. An
        ``offset`` older than the ring's left edge skips forward (those
        lines are gone)."""
        with self._lock:
            rec = self._records.get(job_id)
            if rec is None:
                raise KeyError(f"unknown job {job_id!r}")
            base = self._dropped.get(job_id, 0)
            if offset < base:
                offset = base
            lines = list(rec.logs)[offset - base: offset - base + limit]
            next_offset = offset + len(lines)
            done = (rec.state in JobState.TERMINAL
                    and next_offset >= base + len(rec.logs))
            return lines, next_offset, done

    def stats(self) -> dict:
        with self._lock:
            by_state: Dict[str, int] = {}
            for r in self._records.values():
                by_state[r.state] = by_state.get(r.state, 0) + 1
            return {"records": len(self._records), "by_state": by_state,
                    "max_records": self.max_records}

    # -- retention & persistence ----------------------------------------
    def _evict_locked(self) -> None:
        if len(self._records) <= self.max_records:
            return
        for jid in list(self._records):
            if len(self._records) <= self.max_records:
                break
            if self._records[jid].state in JobState.TERMINAL:
                del self._records[jid]
                self._dropped.pop(jid, None)

    def _persist(self, record_dict: dict) -> None:
        try:
            with open(self.persist_path, "a") as f:
                f.write(json.dumps(record_dict, default=str) + "\n")
        except OSError:
            pass    # history is best-effort; serving must not fail on it
