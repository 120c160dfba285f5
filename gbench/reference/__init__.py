"""The plain reference: one module per app, each with

* ``solve(edges, kwargs, dtype=...)``: the exact answer (``dtype`` of a
  lower precision gives the control's);
* ``answer(solution)``: the solution as the port returns an answer
  (float32 per vertex, original ids);
* ``judge(got, iterations, solution)``: the numbers compared, by name;
* ``LIMITS``: each number's limit (``PERF.md`` gives the readings).

It imports nothing of the port and takes nothing the port made: the
edges are the arrays the benchmark generated, and each delta is applied
by :func:`.edges.apply_delta`.
"""
from __future__ import annotations

import importlib


def load(app: str):
    """The reference module of ``app``."""
    return importlib.import_module(f"{__name__}.{app}")
