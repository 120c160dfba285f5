"""Minimal stdlib JSON API over the ControlPlane (Ray-dashboard style).

Endpoints (all JSON unless noted):

* ``POST /jobs`` — submit a run by fingerprint::

      {"fingerprint": "...", "app": "pagerank", "tenant": "t",
       "priority": 5, "deadline": 2.5, "app_kwargs": {...},
       "max_iters": 10, "path": "ref"}

  → 201 with the job record. Typed admission rejections come back as
  429 with ``{"error": "queue_full" | "quota", ...}``; an unknown
  fingerprint is 404. Graph payloads never travel over HTTP — register
  graphs in-process and submit by fingerprint (jobs are keyed by it).

  ``"kind"`` selects non-run jobs on the same route:

  - ``{"kind": "update", "fingerprint": fp, "delta": {...}}`` — a
    streaming delta update (synchronous; the record carries the NEW
    chained fingerprint). The delta object takes ``add`` / ``remove``
    / ``update`` edge lists (each ``{"src": [...], "dst": [...]}``
    plus optional ``"weights"``, or a positional ``[src, dst,
    weights?]`` array) and an optional vertex-growth floor
    ``"grow_to"``; adds may reference ids past the current vertex
    count to GROW the graph. A malformed delta — wrong shapes,
    unknown fields, or a remove/update referencing an unknown (e.g.
    not-yet-grown) vertex — is a typed 400 ``bad_delta``; an unknown
    base fingerprint stays 404.
  - ``{"kind": "compact", "fingerprint": fp}`` — squash the delta
    chain behind a snapshot into one composed delta (lineage kept).
  - ``{"kind": "regroup", "fingerprint": fp, "force": true}`` — run a
    grouping-drift check and (past the threshold, or forced) the
    fresh-DBG re-registration swap.
* ``GET /jobs`` — list records (``?tenant=`` / ``?state=`` filters).
* ``GET /jobs/{id}`` — one record, with logs.
* ``GET /jobs/{id}/result?timeout=`` — block for the outcome (meta
  only; property arrays stay server-side).
* ``GET /jobs/{id}/logs?offset=&follow=1`` — **chunked
  transfer-encoding** log stream: each chunk is a JSON line batch;
  with ``follow=1`` the connection stays open until the job is
  terminal and the reader has caught up.
* ``GET /jobs/{id}/trace`` — the job's distributed trace as
  Chrome-trace JSON (open in ``chrome://tracing`` / Perfetto); 404
  until the job has a trace or after the tracer evicted it.
* ``POST /jobs/{id}/cancel`` — cancel a queued job.
* ``GET /metrics`` — Prometheus text; ``GET /metrics.json`` — the full
  merged snapshot. ``GET /healthz`` — liveness; ``GET /readyz`` —
  readiness (200 only while the scheduler accepts submissions and all
  pool workers are alive, 503 otherwise — the load-balancer signal).
* ``GET /dashboard`` — self-contained HTML ops page (stdlib-served,
  no assets) that polls ``/metrics.json``: queue depth, per-stage
  latency percentiles, perf-model drift, retunes, and the per-lane
  pipeline-utilization bars.

Built on :class:`http.server.ThreadingHTTPServer` — no dependencies,
one daemon thread per connection, fine for the control plane's request
rates (the data plane never goes through HTTP).
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .scheduler import QueueFull, QuotaExceeded, RejectedJob

__all__ = ["serve_jobs"]

_JOB_PATH = re.compile(r"^/jobs/([^/]+)(/logs|/result|/cancel|/trace)?$")

_DELTA_FIELDS = frozenset({"add", "remove", "update", "grow_to"})


def _delta_from_json(base_fp: str, spec) -> "GraphDelta":
    """Parse a JSON delta body into a validated
    :class:`~repro_torch.streaming.GraphDelta` against ``base_fp``.

    Each of ``add``/``remove``/``update`` is either an object
    ``{"src": [...], "dst": [...], "weights": [...]?}`` or a
    positional ``[src, dst]`` / ``[src, dst, weights]`` array; an
    integer ``grow_to`` sets the vertex-growth floor. Every shape or
    type problem raises ValueError/TypeError, which the route maps to
    a typed 400 — make_delta's own validation (array lengths, dtypes,
    negative ids, non-int grow_to) rides the same path."""
    from ..streaming import make_delta
    if not isinstance(spec, dict):
        raise ValueError(
            "update jobs need a 'delta' object with add/remove/update "
            "edge lists (and an optional grow_to)")
    unknown = set(spec) - _DELTA_FIELDS
    if unknown:
        raise ValueError(f"unknown delta fields {sorted(unknown)}; "
                         f"expected {sorted(_DELTA_FIELDS)}")

    def edges(name):
        v = spec.get(name)
        if v is None:
            return None
        if isinstance(v, dict):
            bad = set(v) - {"src", "dst", "weights"}
            if bad:
                raise ValueError(f"delta {name!r} has unknown keys "
                                 f"{sorted(bad)}")
            if "src" not in v or "dst" not in v:
                raise ValueError(f"delta {name!r} needs both 'src' and "
                                 f"'dst' lists")
            parts = [v["src"], v["dst"]]
            if v.get("weights") is not None:
                parts.append(v["weights"])
            return tuple(parts)
        if isinstance(v, (list, tuple)) and len(v) in (2, 3):
            return tuple(v)
        raise ValueError(f"delta {name!r} must be an object with "
                         f"src/dst(/weights) or a [src, dst(, weights)] "
                         f"array")

    return make_delta(base_fp, add=edges("add"), remove=edges("remove"),
                      update=edges("update"), grow_to=spec.get("grow_to"))


class _Handler(BaseHTTPRequestHandler):
    # the control plane is attached to the server instance
    protocol_version = "HTTP/1.1"    # required for chunked encoding

    # -- plumbing -------------------------------------------------------
    def log_message(self, fmt, *args):   # quiet by default
        pass

    @property
    def plane(self):
        return self.server.control_plane

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, text: str,
              ctype: str = "text/plain; version=0.0.4") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    # -- routes ---------------------------------------------------------
    def do_GET(self) -> None:
        url = urlparse(self.path)
        q = {k: v[-1] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/healthz":
                return self._json(200, {"status": "ok"})
            if url.path == "/readyz":
                info = self.plane.ready()
                return self._json(200 if info["ready"] else 503, info)
            if url.path == "/dashboard":
                from .dashboard import DASHBOARD_HTML
                return self._text(200, DASHBOARD_HTML,
                                  ctype="text/html; charset=utf-8")
            if url.path == "/metrics":
                return self._text(200, self.plane.prometheus())
            if url.path == "/metrics.json":
                return self._json(200, self.plane.metrics_snapshot())
            if url.path == "/jobs":
                return self._json(200, {"jobs": self.plane.jobs.list(
                    tenant=q.get("tenant"), state=q.get("state"))})
            m = _JOB_PATH.match(url.path)
            if m and m.group(2) in (None, "/logs", "/result", "/trace"):
                jid, sub = m.group(1), m.group(2)
                if sub == "/logs":
                    return self._stream_logs(jid,
                                             int(q.get("offset", 0)),
                                             q.get("follow") == "1")
                if sub == "/result":
                    return self._result(jid, q.get("timeout"))
                if sub == "/trace":
                    trace = self.plane.trace(jid)
                    if trace is None:
                        return self._json(404, {"error": "no_trace",
                                                "job_id": jid})
                    return self._json(200, trace)
                rec = self.plane.jobs.get(jid)
                if rec is None:
                    return self._json(404, {"error": "not_found",
                                            "job_id": jid})
                return self._json(200, rec.to_dict(with_logs=True))
            self._json(404, {"error": "no_such_route",
                             "path": url.path})
        except BrokenPipeError:
            pass
        except Exception as exc:        # a handler bug must not kill the
            try:                        # connection thread silently
                self._json(500, {"error": "internal",
                                 "message": str(exc)})
            except Exception:
                pass

    def do_POST(self) -> None:
        url = urlparse(self.path)
        try:
            if url.path == "/jobs":
                return self._submit(self._read_body())
            m = _JOB_PATH.match(url.path)
            if m and m.group(2) == "/cancel":
                ok = self.plane.cancel_job(m.group(1))
                return self._json(200 if ok else 409,
                                  {"job_id": m.group(1),
                                   "cancelled": ok})
            self._json(404, {"error": "no_such_route", "path": url.path})
        except Exception as exc:
            try:
                self._json(500, {"error": "internal",
                                 "message": str(exc)})
            except Exception:
                pass

    # -- handlers -------------------------------------------------------
    def _submit(self, body: dict) -> None:
        fp = body.get("fingerprint")
        if not fp:
            return self._json(400, {"error": "bad_request",
                                    "message": "fingerprint is required "
                                    "(register graphs in-process)"})
        kind = body.get("kind", "run")
        if kind == "update":
            return self._update(fp, body)
        if kind == "compact":
            return self._compact(fp, body)
        if kind == "regroup":
            return self._regroup(fp, body)
        if kind != "run":
            return self._json(400, {"error": "bad_request",
                                    "message": f"unknown job kind "
                                    f"{kind!r}; expected run, update, "
                                    f"compact, or regroup"})
        kwargs = {}
        for k in ("app_kwargs", "max_iters", "path", "n_lanes"):
            if k in body:
                kwargs[k] = body[k]
        try:
            rec = self.plane.submit_job(
                fingerprint=fp, app=body.get("app", "pagerank"),
                tenant=body.get("tenant", "default"),
                priority=int(body.get("priority", 0)),
                deadline=body.get("deadline"), **kwargs)
        except QueueFull as exc:
            return self._json(429, {"error": "queue_full",
                                    "message": str(exc)})
        except QuotaExceeded as exc:
            return self._json(429, {"error": "quota",
                                    "message": str(exc)})
        except RejectedJob as exc:
            return self._json(429, {"error": "rejected",
                                    "message": str(exc)})
        except KeyError as exc:
            return self._json(404, {"error": "unknown_fingerprint",
                                    "message": str(exc)})
        except (ValueError, TypeError) as exc:
            return self._json(400, {"error": "bad_request",
                                    "message": str(exc)})
        self._json(201, rec.to_dict())

    def _update(self, fp: str, body: dict) -> None:
        """A streaming delta update as a job. Delta parsing and the
        apply-side validation both surface as typed 400s — a malformed
        growth delta (e.g. a remove referencing a vertex only a LATER
        add would create) must fail the HTTP call, not a worker."""
        try:
            delta = _delta_from_json(fp, body.get("delta"))
            rec = self.plane.update_job(
                fp, delta, tenant=body.get("tenant", "default"))
        except KeyError as exc:
            return self._json(404, {"error": "unknown_fingerprint",
                                    "message": str(exc)})
        except (ValueError, TypeError) as exc:
            return self._json(400, {"error": "bad_delta",
                                    "message": str(exc)})
        self._json(201, rec.to_dict())

    def _compact(self, fp: str, body: dict) -> None:
        try:
            rec = self.plane.compact_job(
                fp, tenant=body.get("tenant", "default"))
        except KeyError as exc:
            return self._json(404, {"error": "unknown_fingerprint",
                                    "message": str(exc)})
        except (ValueError, TypeError) as exc:
            return self._json(400, {"error": "bad_request",
                                    "message": str(exc)})
        self._json(201, rec.to_dict())

    def _regroup(self, fp: str, body: dict) -> None:
        try:
            rec = self.plane.regroup_job(
                fingerprint=fp, tenant=body.get("tenant", "default"),
                force=bool(body.get("force", False)))
        except KeyError as exc:
            return self._json(404, {"error": "unknown_fingerprint",
                                    "message": str(exc)})
        except (ValueError, TypeError) as exc:
            return self._json(400, {"error": "bad_request",
                                    "message": str(exc)})
        self._json(201, rec.to_dict())

    def _result(self, jid: str, timeout: Optional[str]) -> None:
        try:
            props, meta = self.plane.result(
                jid, timeout=float(timeout) if timeout else None)
        except KeyError as exc:
            return self._json(404, {"error": "not_found",
                                    "message": str(exc)})
        except TimeoutError as exc:
            return self._json(408, {"error": "timeout",
                                    "message": str(exc)})
        except Exception as exc:
            return self._json(500, {"error": type(exc).__name__,
                                    "message": str(exc)})
        # meta only: property arrays can be huge and live server-side
        return self._json(200, {"job_id": jid, "meta": meta,
                                "num_properties": len(props)
                                if hasattr(props, "__len__") else None})

    def _stream_logs(self, jid: str, offset: int, follow: bool) -> None:
        """Chunked transfer: one JSON document per chunk, each a batch
        of log lines plus the next offset. With ``follow``, poll until
        the job is terminal AND fully read."""
        try:
            lines, next_off, done = self.plane.jobs.read_logs(jid, offset)
        except KeyError:
            return self._json(404, {"error": "not_found", "job_id": jid})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(payload) -> None:
            data = (json.dumps(payload) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data
                             + b"\r\n")

        try:
            while True:
                if lines or done or not follow:
                    chunk({"lines": lines, "next_offset": next_off,
                           "done": done})
                if done or not follow:
                    break
                threading.Event().wait(0.05)    # poll cadence
                lines, next_off, done = self.plane.jobs.read_logs(
                    jid, next_off)
            self.wfile.write(b"0\r\n\r\n")      # last-chunk
        except BrokenPipeError:
            pass


def serve_jobs(plane, host: str = "127.0.0.1",
               port: int = 0) -> Tuple[ThreadingHTTPServer, str]:
    """Serve the job API for ``plane`` on a daemon thread. Returns
    ``(server, base_url)``; ``port=0`` binds a free port. Stop with
    ``server.shutdown()`` (ControlPlane.close does)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.control_plane = plane
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="control-http")
    t.start()
    return server, f"http://{host}:{server.server_address[1]}"
