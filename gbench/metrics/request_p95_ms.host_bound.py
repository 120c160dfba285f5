"""``request_p95_ms`` in the cells whose host sets the pace, where it is a
per-layer metric: there the scheduler's starved requests make the tail
swing from run to run (PERF.md, section 2). The same reader."""
from pathlib import Path

from gbench.harness import load_module

read = load_module("metrics", "request_p95_ms",
                   Path(__file__).resolve().parents[2]).read
