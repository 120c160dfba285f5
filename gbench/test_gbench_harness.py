"""The harness's arithmetic and its lookup by name, on the CPU."""
import json
import shutil
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from gbench import devtrace, harness, roofline  # noqa: E402


def _reader(name):
    return harness.load_reader(name, ROOT)


def _req(t_submit, latency, error=None, traced=False, app="bfs", snap=0,
         iterations=4, stages=None):
    return types.SimpleNamespace(
        t_submit=t_submit, t_done=t_submit + latency, error=error,
        traced=traced, app=app, snap=snap, iterations=iterations,
        stages=stages)


def test_rate_and_p95_over_a_window_with_a_stall():
    # 10 s window; 90 requests of 10 ms, then a stall that holds 10
    # requests for 1 s each; the last of them answers after the close
    reqs = [_req(0.1 * i, 0.010) for i in range(90)]
    reqs += [_req(9.0 + 0.01 * i, 1.0) for i in range(10)]
    reqs.append(_req(9.5, 0.2, error="boom"))
    ctx = types.SimpleNamespace(requests=reqs, t_open=0.0, t_close=10.0)
    # answered without error by the close: 90 + the 9 stalled ones that
    # end before 10.0 (9.0 + 0.01 * i + 1.0 <= 10.0 only for i == 0)
    assert _reader("requests_per_s").read(ctx) == pytest.approx(91 / 10)
    p95 = _reader("request_p95_ms").read(ctx)
    assert p95["samples"] == 100
    assert p95["value"] == pytest.approx(1000.0)
    assert _reader("request_p95_ms.host_bound").read(ctx) == p95
    ctx.requests = reqs[:90]
    assert _reader("request_p95_ms").read(ctx)["value"] == pytest.approx(10.0)


def test_update_s_counts_updates_answered_in_the_window():
    u = [types.SimpleNamespace(t_call=0.0, t_first=8.0),
         types.SimpleNamespace(t_call=9.0, t_first=19.0),
         types.SimpleNamespace(t_call=20.0, t_first=52.0),
         types.SimpleNamespace(t_call=41.0, t_first=None)]
    ctx = types.SimpleNamespace(updates=u, t_close=51.0)
    got = _reader("update_s").read(ctx)
    assert got == {"value": pytest.approx(9.0), "samples": 2}
    ctx.updates = u[2:]
    assert _reader("update_s").read(ctx) is None


def test_gas_bytes_are_counted_from_the_graph():
    # per iteration: a 4 B id per edge, a 4 B offset, a value read and an
    # output written per vertex
    assert roofline.pagerank_bytes(10, 100, 3) == 3 * (400 + 120)
    assert roofline.pagerank_bytes(10, 100, 0) == 0
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None


def test_gas_roofline_and_idle_from_a_trace():
    ev = [{"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 100.0,
           "name": "void (anonymous namespace)::gas_chunk_kernel<0, 0, "
                   "float>(float const*)"},
          {"ph": "X", "cat": "kernel", "ts": 50.0, "dur": 100.0,
           "name": "gas_combine_kernel<0, float>(float const*)"},
          {"ph": "X", "cat": "kernel", "ts": 120.0, "dur": 20.0,
           "name": "gas_chunk_kernel<1, 1, float>(float const*)"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 400.0, "dur": 100.0,
           "name": "Memcpy DtoH (Device -> Pageable)"},
          {"ph": "X", "cat": "cuda_runtime", "ts": 140.0, "dur": 300.0,
           "name": "cudaMemcpyAsync"},
          {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 5.0, "name": "x"}]
    s = devtrace.summarize({"traceEvents": ev}, window_s=1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)     # [0, 150] + [400, 500]
    assert s["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(250e-6)]]
    assert s["device_ops"][0] == ["gas_chunk_kernel<0, 0, float>",
                                  pytest.approx(1e-4)]
    # only PageRank's requests and the sum-mode launches it runs count
    ctx = types.SimpleNamespace(
        trace=s, device_kind="NVIDIA H100 80GB HBM3", num_vertices=10,
        edge_counts=[100, 120],
        requests=[_req(0, 1, traced=True, app="pagerank", snap=1,
                       iterations=2),
                  _req(0, 1, traced=True, app="sssp", iterations=7),
                  _req(0, 1, traced=False, app="pagerank", iterations=9)])
    nbytes = roofline.pagerank_bytes(10, 120, 2)
    want = 100 * nbytes / 3.35e12 / 200e-6
    roof = _reader("gas_pagerank_roofline")
    assert roof.read(ctx) == pytest.approx(want)
    assert _reader("device_idle_pct").read(ctx) == pytest.approx(75.0)
    ctx.requests = ctx.requests[1:2]
    assert roof.read(ctx) is None
    ctx.trace = None
    assert roof.read(ctx) is None


def test_stage_readers():
    st = {"t_queue_ms": 4.0, "t_store_ms": 0.1, "t_plan_ms": 0.0,
          "t_execute_ms": 10.0, "t_total_ms": 15.0}
    reqs = [_req(0, 1, stages=st, iterations=5),
            _req(0, 1, stages=dict(st, t_queue_ms=8.0), iterations=5),
            _req(0, 1, stages=dict(st, t_queue_ms=99.0), traced=True)]
    ctx = types.SimpleNamespace(requests=reqs)
    assert _reader("queue_ms").read(ctx) == pytest.approx(6.0)
    assert _reader("serve_overhead_ms").read(ctx) == pytest.approx(
        (1.0 + -3.0) / 2)
    assert _reader("execute_ms_per_iter").read(ctx) == pytest.approx(2.0)


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A cell made only of new files: a graph generator, a configuration
    that names it, a traffic mix that needs code (its data and a module
    whose ``Session`` paces the client), and a per-layer reader, each
    found by the name BENCHMARK.json or the configuration gives, and the
    whole run driven on the CPU."""
    shutil.copytree(ROOT / "gbench", tmp_path / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "gbench/generators/near.py").write_text(
        "import torch\n"
        "def edges(cfg, n_edges, gen, device):\n"
        "    n = 1 << int(cfg['scale'])\n"
        "    src = torch.randint(0, n, (n_edges,), generator=gen,\n"
        "                        device=device)\n"
        "    hop = torch.randint(1, 4, (n_edges,), generator=gen,\n"
        "                        device=device)\n"
        "    return src, (src + hop) % n\n")
    cfg = json.loads((ROOT / "gbench/configs/urand20.json").read_text())
    cfg.update(name="near_tiny", generator="near", scale=8, geometry={
        "U": 128, "W": 128, "T": 128, "E_BLK": 128, "big_batch": 2})
    (tmp_path / "gbench/configs/near_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "gbench/traffic/paced.json").write_text(json.dumps(
        {"clients": [{"app": "pagerank",
                      "app_kwargs": {"damping": 0.85, "max_iters": 16}}],
         "updater": None, "period_s": 0.25}))
    (tmp_path / "gbench/traffic/paced.py").write_text(
        "import time\n"
        "from gbench import loadgen\n"
        "class Session(loadgen.Session):\n"
        "    def _one(self, spec, kwargs, traced):\n"
        "        due = self.t_open + self.mix['period_s'] * len(\n"
        "            self.requests)\n"
        "        time.sleep(max(0.0, due - time.perf_counter()))\n"
        "        if time.perf_counter() < self.t_close:\n"
        "            super()._one(spec, kwargs, traced)\n")
    (tmp_path / "gbench/metrics/iterations_mean.py").write_text(
        "def read(ctx):\n"
        "    its = [r.iterations for r in ctx.requests if r.iterations]\n"
        "    return sum(its) / len(its) if its else None\n")
    bench["configs"].append({"name": "near_tiny", "source": "test",
                             "file": "gbench/configs/near_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "near_tiny.paced",
                               "config": "near_tiny", "traffic": "paced",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "iterations_mean", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "executor iteration",
        "moves": "requests_per_s", "workloads": ["near_tiny.paced"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = harness.load_bench(tmp_path)
    cell = harness.find_cell(b, "near_tiny.paced")
    assert harness.load_config(b, cell["config"], tmp_path)["scale"] == 8
    mix = harness.load_traffic("paced", tmp_path)
    assert mix["updater"] is None and hasattr(mix["driver"], "Session")
    assert "driver" not in harness.load_traffic("mixed", tmp_path)
    names = [m["name"] for m in
             harness.cell_metrics(b, "near_tiny.paced", "per_layer")]
    assert "iterations_mean" in names and "delta_splice_ms" not in names
    with pytest.raises(KeyError):
        harness.find_cell(b, "nope")
    with pytest.raises(KeyError):
        harness.load_module("generators", "nope", tmp_path)
    out, _ = harness.run("near_tiny.paced", 9, 0.6, True, base=tmp_path,
                         device="cpu", log=lambda m: None)
    assert out["correct"], out["checks"]
    # sent at 0, 0.25 and 0.5 s at the most: the paced driver ran
    assert 1 <= out["attempted"] <= 3
    assert out["metrics"]["iterations_mean"]["value"] >= 1
    assert list(out["checks"]) == ["pagerank_rel_err"]
