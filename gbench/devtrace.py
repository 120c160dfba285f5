"""The device trace of a profiled stretch, read from ``torch.profiler``.

The profiler traces the card's kernels, copies and fills with CUPTI and
the host's operations beside them. The trace is written as Chrome JSON to
a temporary file under ``TMPDIR``, read back and deleted.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Profile:
    """``prime()`` in set-up, then ``start()`` and ``stop()`` around the
    stretch; then ``summary``."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def prime(self) -> None:
        """Profile one small operation on this thread, so that the
        tracer is set up before the clients' threads run."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events, self.t1 - self.t0)


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, namespace noise and
    parameter list, at most ``limit`` characters."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return re.split(r"(?<=\S)\(", name, maxsplit=1)[0][:limit]


def _intervals(events, cats):
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            ts = float(e["ts"])
            out.append((ts, ts + float(e["dur"]), e.get("name", "?")))
    return out


def _union(spans):
    merged = []
    for lo, hi, _ in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def summarize(trace: dict, window_s: float, top: int = 10) -> dict:
    """Device intervals (µs, trace clock) by name, the busy seconds (the
    union of every kernel, copy and fill), the window, the device
    operations that took most time, and the longest idle gaps with the
    host operation that covered most of each."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev = _intervals(events, DEVICE_CATS)
    busy = _union(dev)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    by_name = {}
    for lo, hi, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    host = _intervals(events, HOST_CATS)
    idle = []
    for dur, lo, hi in gaps:
        cover = {}
        for h_lo, h_hi, name in host:
            ov = min(hi, h_hi) - max(lo, h_lo)
            if ov > 0:
                cover[name] = cover.get(name, 0.0) + ov
        label = max(cover, key=cover.get) if cover else "no host operation"
        idle.append([label, dur / 1e6])
    return {"kernels": dev, "busy_s": busy_s, "window_s": window_s,
            "events": len(events), "host_events": len(host),
            "device_ops": [[short_name(n), s] for n, s in ops],
            "idle_gaps": idle}
