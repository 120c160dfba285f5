#!/usr/bin/env python3
"""The control of the check: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 that the
apps state. It answers the requests a run would judge, on the cell's own
graph, and the check judges those answers as it judges the program's. It
has to come out not correct.

    python3 gbench/control.py --workload kron20.mixed --seeds 1 2 3

Prints one JSON line per seed: the numbers beside their limits and
whether the control passed. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(workload: str, seed: int, *, base: Path = ROOT,
            device: str = "cuda", per_app: int = 33,
            deltas: int = 4) -> dict:
    """The control's numbers for one seed: ``per_app`` requests of each
    client (the size of a run's sample) on the base snapshot and, for a
    mix with an updater, on each of ``deltas`` later snapshots."""
    import torch

    from gbench import gen, harness, judge
    from gbench.reference import edges as redges

    bench = harness.load_bench(base)
    cell = harness.find_cell(bench, workload)
    cfg = harness.load_config(bench, cell["config"], base)
    mix = harness.load_traffic(cell["traffic"], base)
    dev = torch.device(device)
    edges = gen.make_graph(cfg, seed, dev, base)
    args = gen.RequestArgs(seed, gen.root_candidates(edges))
    made = []
    if mix.get("updater"):
        g = gen.generator(seed, 1, dev)
        cur = edges
        for _ in range(deltas):
            d = gen.skewed_churn(cur, mix["updater"]["churn"],
                                 mix["updater"]["hot_frac"], cfg["weights"],
                                 g)
            cur = gen.apply(cur, d)
            made.append(d)
    entries = []
    for i, spec in enumerate(mix["clients"]):
        stream = args.stream(i, spec)
        for snap in range(len(made) + 1):
            n = per_app if "root" in spec else 1
            entries += [(snap, spec["app"], next(stream), None, None, 1)
                        for _ in range(n)]

    def lower(mod, g, kwargs):
        sol = mod.solve(g, kwargs, dtype=torch.bfloat16)
        return mod.answer(sol), (sol["stop"] if isinstance(sol, dict) else 0)

    base_edges = redges.Edges(edges.num_vertices, edges.src, edges.dst,
                              edges.weights)
    numbers, judged = judge.judge(entries, base_edges, made, solve=lower)
    lim = judge.limits(s["app"] for s in mix["clients"])
    return {"workload": workload, "seed": seed, "judged": judged,
            "numbers": {k: {"value": numbers[k], "limit": lim[k]}
                        for k in sorted(lim)},
            "correct": all(numbers[k] <= lim[k] for k in lim)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    for seed in a.seeds:
        print(json.dumps(control(a.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
