"""The check that decides ``correct``, driven end to end on the CPU at a
tiny size: a sound run passes; the bfloat16 control and each fault the
cells can have, planted under the timed path, fail. (The cells run on one
card, so there is no exchange between cards to leave out.)"""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from gbench import control, harness  # noqa: E402

SEED = 3_000_000_123


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark whose graphs have 512 vertices, on a
    geometry with a few partitions."""
    base = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "gbench", base / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(scale=9, geometry={"U": 128, "W": 128, "T": 128,
                                      "E_BLK": 128, "big_batch": 2})
        (base / c["file"]).write_text(json.dumps(cfg))
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def _run(base, cell, seconds=0.6):
    out, lines = harness.run(cell, SEED, seconds, False, base=base,
                             device="cpu", log=lambda m: None)
    assert len(lines) == len(out["checks"])
    return out


@pytest.mark.parametrize("cell", ["kron20.mixed", "urand20.mixed",
                                  "kron20.churn"])
def test_sound_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"requests_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["kron20.mixed", "kron20.churn"])
def test_control_is_not_correct(tiny, cell):
    res = control.control(cell, SEED, base=tiny, device="cpu", per_app=3,
                          deltas=2)
    assert not res["correct"], res
    assert res["numbers"]["pagerank_rel_err"]["value"] > 1e-2


def _unchanged(monkeypatch):
    from repro_torch.core.executor import Executor
    monkeypatch.setattr(Executor, "iteration",
                        lambda self, vprops, it: vprops.clone())


def _half_left_out(monkeypatch):
    from repro_torch.core.executor import Executor

    def gather(self, vprops):
        kept = self._payloads[:len(self._payloads) // 2]
        return self._merge([self._run_payload(p, vprops) for p in kept])
    monkeypatch.setattr(Executor, "gather", gather)


def _answer_altered(monkeypatch):
    from repro_torch.core.executor import Executor
    run = Executor.run

    def altered(self, *a, **kw):
        out, meta = run(self, *a, **kw)
        out = out.copy()
        out[np.argmax(out < 1e38)] += 1.0
        return out, meta
    monkeypatch.setattr(Executor, "run", altered)


def _update_unchanged(monkeypatch):
    from repro_torch.serve_graph import service
    apply = service.apply_delta

    def same_store(store, delta, **kw):
        res = apply(store, delta, **kw)
        res.store = store
        return res
    monkeypatch.setattr(service, "apply_delta", same_store)


@pytest.mark.parametrize("cell,fault", [
    ("kron20.mixed", _unchanged), ("kron20.mixed", _half_left_out),
    ("kron20.mixed", _answer_altered), ("urand20.mixed", _answer_altered),
    ("kron20.churn", _unchanged), ("kron20.churn", _answer_altered),
    ("kron20.churn", _update_unchanged)])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(tiny, cell, seconds=0.6 if fault is not _update_unchanged
               else 2.0)
    assert not out["correct"], out["checks"]
