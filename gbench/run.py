#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 gbench/run.py --workload kron20.mixed --seed 7 --seconds 51 \\
        --trace 0

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is one JSON object (see
``gbench/README.md``); the last lines of standard error give each number
the check compared beside its limit. Exits non-zero, and prints no
result, where there is no such card, where the program cannot be found,
or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths, and no JAX pulled in
    by a library."""
    cache = ROOT / "gbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()

    import torch

    from gbench import harness

    cell = harness.find_cell(harness.load_bench(ROOT), a.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    out, lines = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                             base=ROOT, device="cuda", t_start=T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
