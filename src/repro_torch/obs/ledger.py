"""Append-only JSONL perf-regression ledger (a framework-free copy of
the reference package's ``obs/ledger.py``).

Every benchmark run APPENDS one record per suite, keyed by

    (git sha, bench name, geometry key, device-spec version)

with the suite's flattened gate metrics, and :meth:`PerfLedger.compare`
flags the latest record's metrics that drifted beyond a tolerance vs
the rolling median of prior records of the same bench; the report is
informational, callers decide whether to fail on it.

Records are plain JSON objects, one per line; readers are tolerant of
corrupt/partial lines (a truncated append must never break the next
run). Regression *direction* uses a name heuristic — metrics that look
like times/latencies/overheads (``*_s``, ``*_ms``, ``p50*``,
``overhead*``, ``ratio*``) are worse when higher, throughputs
(``*gbps*``, ``*teps*``, ``*rate*``) worse when lower; everything else
is reported as neutral "drift".
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

__all__ = ["PerfLedger", "flatten_metrics", "git_sha"]

DEFAULT_TOLERANCE = 0.25       # |relative change| that flags a metric
DEFAULT_WINDOW = 8             # prior records in the rolling median

_WORSE_HIGHER = ("_s", "_ms", "_us")
_WORSE_HIGHER_SUB = ("p50", "p99", "overhead", "latency", "time",
                     "ratio", "makespan")
_WORSE_LOWER_SUB = ("gbps", "teps", "rate", "throughput", "utilization",
                    "speedup", "efficiency")


def git_sha(cwd: Optional[str] = None) -> str:
    """Best-effort commit id: ``git rev-parse`` → ``REGRAPH_GIT_SHA`` /
    CI-provided ``GITHUB_SHA`` → ``"unknown"``. Never raises."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:
        pass
    return (os.environ.get("REGRAPH_GIT_SHA")
            or os.environ.get("GITHUB_SHA", "unknown")[:12] or "unknown")


def flatten_metrics(obj: Any, prefix: str = "",
                    max_keys: int = 128) -> Dict[str, float]:
    """Flatten a BENCH_*.json-style document into dotted-key numeric
    leaves (bools excluded; list items indexed). Non-numeric leaves are
    dropped — the ledger stores gate METRICS, not blobs. Bounded to
    ``max_keys`` in first-traversal order so a pathological artifact
    cannot bloat every future compare."""
    out: Dict[str, float] = {}

    def walk(node, pre):
        if len(out) >= max_keys:
            return
        if isinstance(node, bool):
            return
        if isinstance(node, (int, float)):
            out[pre] = float(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{pre}.{k}" if pre else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{pre}.{i}" if pre else str(i))

    walk(obj, prefix)
    return out


def _direction(name: str) -> str:
    """"higher_is_worse" | "lower_is_worse" | "neutral" by key name."""
    low = name.lower()
    leaf = low.rsplit(".", 1)[-1]
    if any(s in low for s in _WORSE_LOWER_SUB):
        return "lower_is_worse"
    if leaf.endswith(_WORSE_HIGHER) \
            or any(s in low for s in _WORSE_HIGHER_SUB):
        return "higher_is_worse"
    return "neutral"


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    return ys[mid] if n % 2 else 0.5 * (ys[mid - 1] + ys[mid])


class PerfLedger:
    """Append-only JSONL ledger of benchmark gate metrics."""

    def __init__(self, path: str = "BENCH_ledger.jsonl"):
        self.path = str(path)

    # -- writing --------------------------------------------------------
    def append(self, bench: str, metrics: Dict[str, float], *,
               sha: Optional[str] = None,
               geom_key: Optional[str] = None,
               spec_version: Optional[int] = None,
               meta: Optional[dict] = None) -> dict:
        """Append one record; returns the record dict. The write is a
        single ``write()`` of one line on an append-mode handle, so
        concurrent benches interleave whole lines."""
        rec = {
            "sha": sha if sha is not None else git_sha(),
            "bench": str(bench),
            "geom_key": geom_key,
            "spec_version": (int(spec_version)
                             if spec_version is not None else None),
            "created_at": time.time(),
            "metrics": {str(k): float(v)
                        for k, v in (metrics or {}).items()},
        }
        if meta:
            rec["meta"] = meta
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    # -- reading --------------------------------------------------------
    def records(self, bench: Optional[str] = None) -> List[dict]:
        """All parseable records, file order; corrupt lines skipped."""
        out: List[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(rec, dict) or "bench" not in rec:
                        continue
                    if bench is None or rec.get("bench") == bench:
                        out.append(rec)
        except OSError:
            pass
        return out

    def compare(self, bench: Optional[str] = None,
                tolerance: float = DEFAULT_TOLERANCE,
                window: int = DEFAULT_WINDOW) -> dict:
        """Latest record per bench vs the rolling median of up to
        ``window`` prior records of the same bench.

        Returns ``{"benches": {name: {"sha", "n_prior", "flagged":
        [...], "checked": int}}, "regressions": int, "flagged": int}``.
        Each flagged entry carries the metric, latest value, prior
        median, relative change, direction heuristic and whether it
        counts as a regression. Purely a report — callers decide
        whether to fail on it (CI does not)."""
        by_bench: Dict[str, List[dict]] = {}
        for rec in self.records(bench):
            by_bench.setdefault(rec["bench"], []).append(rec)
        report: dict = {"benches": {}, "flagged": 0, "regressions": 0,
                        "tolerance": tolerance}
        for name, recs in sorted(by_bench.items()):
            latest, prior = recs[-1], recs[:-1][-window:]
            entry = {"sha": latest.get("sha"), "n_prior": len(prior),
                     "checked": 0, "flagged": []}
            if prior:
                latest_m = latest.get("metrics") or {}
                for key, val in sorted(latest_m.items()):
                    hist = [r["metrics"][key] for r in prior
                            if isinstance(r.get("metrics"), dict)
                            and isinstance(r["metrics"].get(key),
                                           (int, float))]
                    if not hist:
                        continue
                    entry["checked"] += 1
                    med = _median(hist)
                    denom = max(abs(med), 1e-12)
                    rel = (val - med) / denom
                    if abs(rel) <= tolerance:
                        continue
                    direction = _direction(key)
                    regression = (
                        (direction == "higher_is_worse" and rel > 0)
                        or (direction == "lower_is_worse" and rel < 0))
                    entry["flagged"].append({
                        "metric": key, "value": val, "median": med,
                        "rel_change": rel, "direction": direction,
                        "regression": regression,
                    })
                    report["flagged"] += 1
                    if regression:
                        report["regressions"] += 1
            report["benches"][name] = entry
        return report

    def render_report(self, report: dict) -> str:
        """Human-readable compare report (the CI step's stdout)."""
        lines = [f"perf ledger: {self.path}  "
                 f"(tolerance ±{report['tolerance'] * 100:.0f}% "
                 f"vs rolling median)"]
        for name, entry in report["benches"].items():
            if not entry["n_prior"]:
                lines.append(f"  {name}: first record "
                             f"(sha {entry['sha']}) — no history yet")
                continue
            if not entry["flagged"]:
                lines.append(
                    f"  {name}: ok — {entry['checked']} metrics within "
                    f"tolerance of {entry['n_prior']} prior record(s)")
                continue
            lines.append(f"  {name}: {len(entry['flagged'])} metric(s) "
                         f"beyond tolerance (sha {entry['sha']})")
            for f in entry["flagged"]:
                tag = ("REGRESSION" if f["regression"]
                       else "drift" if f["direction"] == "neutral"
                       else "improvement")
                lines.append(
                    f"    [{tag}] {f['metric']}: {f['value']:.6g} "
                    f"vs median {f['median']:.6g} "
                    f"({f['rel_change'] * 100:+.1f}%)")
        lines.append(f"summary: {report['regressions']} regression(s), "
                     f"{report['flagged']} flagged metric(s)")
        return "\n".join(lines)
