"""Nothing the harness runs loads JAX or the JAX package, and the reference
loads nothing of the port. Each check runs in a fresh interpreter, since
the test process itself may hold modules that other tests imported."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}

# a whole run on the CPU at a tiny size, then every module it loaded
RUN = f"""
import json, shutil, sys, tempfile
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from gbench import control, harness
root = Path({str(ROOT)!r})
base = Path(tempfile.mkdtemp())
shutil.copytree(root / "gbench", base / "gbench",
                ignore=shutil.ignore_patterns("__pycache__", ".cache"))
bench = json.loads((root / "BENCHMARK.json").read_text())
for c in bench["configs"]:
    cfg = json.loads((root / c["file"]).read_text())
    cfg.update(scale=8, geometry=dict(U=128, W=128, T=128, E_BLK=128,
                                      big_batch=2))
    (base / c["file"]).write_text(json.dumps(cfg))
(base / "BENCHMARK.json").write_text(json.dumps(bench))
for cell in bench["workloads"]:
    for trace in (False, True):
        harness.run(cell["name"], 5, 0.3, trace, base=base, device="cpu",
                    log=lambda m: None)
import gbench.run
shutil.rmtree(base)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
from gbench import reference
from gbench.reference import edges
for app in ("pagerank", "bfs", "sssp", "wcc"):
    reference.load(app)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN)
    assert "repro_torch" in loaded and "gbench" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_reference_loads_nothing_of_the_port():
    loaded = _top_level(REF)
    assert not loaded & (BANNED | {"repro_torch"})


def test_no_source_names_the_jax_package_or_its_benchmarks():
    for path in sorted((ROOT / "gbench").rglob("*.py")):
        if path.name.startswith("test_"):
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in BANNED, (path, name)
                if "reference" in path.parts:
                    assert top != "repro_torch", (path, name)
        assert "benchmarks/" not in path.read_text(), path
