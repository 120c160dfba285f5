"""Custom scatter UDFs: the port's code generator against torch, and
custom apps end to end against the JAX package.

* Apps that are not builtins (widest path: max of ``minimum(src, w)``; a
  sum-mode UDF with constants and products; an ``or``-mode UDF on int32)
  as a JAX ``GASApp`` (jnp scatter) and as a port ``GASApp`` (torch
  scatter, no ``scatter_op``), through both packages'
  ``api.compile(...).run()`` on the CPU: max and or exactly equal, sum
  within rtol 1e-5 / atol 1e-7.
* ``udf_codegen.scatter_expr``'s C++, compiled by the host ``g++`` as
  plain C++ (the CUDA rounding intrinsics defined as plain float
  operations, FMA contraction off), bit for bit against the torch UDF
  on float32 edge values: signed zeros, infinities, NaN, subnormals,
  the ``INF`` sentinel 3e38. NaNs compare as NaN whatever their payload
  (torch's own CPU paths give different payloads). Tensors are a
  multiple of 64 long, so torch takes its vectorized kernels, whose
  signed-zero rule for ``minimum`` / ``maximum`` the generator follows.
* Unsupported ops and data-dependent control flow raise
  ``NotImplementedError`` naming the op; no fallback.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import api as japi
from repro.core import gas as jgas
from repro.graphs.rmat import rmat as jrmat

from repro_torch import api as tapi, convert
from repro_torch.core import gas as tgas
from repro_torch.kernels import _build, gas_kernel, udf_codegen
from repro_torch.kernels.little_pipeline import _blocked

INF = float(tgas.INF)


def _widest_init(aux):
    """Widths from the vertex of most out-edges: INF there, -INF (the
    max identity) elsewhere."""
    p = np.full(aux["num_v_pad"], -tgas.INF, np.float32)
    p[int(np.argmax(aux["outdeg"]))] = tgas.INF
    return p


def _half_init(aux):
    return np.full(aux["num_v_pad"], 0.5, np.float32)


def _apps(pkg):
    """The three custom apps of one package: (name, GASApp)."""
    if pkg == "jax":
        G, mn, mx, eq = (jgas.GASApp, jnp.minimum, jnp.maximum,
                         lambda a, b, it: bool(jnp.array_equal(a, b)))
        closeness = jgas.make_closeness()
    else:
        G, mn, mx, eq = (tgas.GASApp, torch.minimum, torch.maximum,
                         lambda a, b, it: bool(torch.equal(a, b)))
        closeness = tgas.make_closeness()
    return {
        "widest": G("widest", "max", lambda s, w: mn(s, w),
                    lambda acc, p, aux, it: mx(p, acc), _widest_init, eq,
                    needs_weights=True, max_iters=64),
        "scaled_sum": G("scaled_sum", "sum", lambda s, w: s * w * 0.5 + 0.25,
                        lambda acc, p, aux, it: acc / (1.0 + acc),
                        _half_init, lambda a, b, it: False,
                        needs_weights=True, max_iters=8),
        "low_bits": G("low_bits", "or", lambda s, w: s & 0xFFFF,
                      lambda acc, p, aux, it: p | acc, closeness.init, eq,
                      prop_dtype="int32", max_iters=32),
    }


@pytest.fixture(scope="module")
def stores(small_geom):
    out = {}
    geom_t = convert.geometry_from(small_geom)
    for weighted in (False, True):
        g = jrmat(10, 8, seed=3, weighted=weighted)
        gt = convert.graph_from_arrays(g.num_vertices, g.src, g.dst,
                                       g.weights)
        out[weighted] = (japi.GraphStore(g, geom=small_geom),
                         tapi.GraphStore(gt, geom=geom_t))
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("app", ["widest", "scaled_sum", "low_bits"])
def test_custom_app_matches_reference(app, weighted, stores):
    store_j, store_t = stores[weighted]
    japp, tapp = _apps("jax")[app], _apps("torch")[app]
    assert tapp.scatter_op is None
    want, meta_j = japi.compile(None, japp, store=store_j, n_lanes=4,
                                path="ref").run()
    got, meta_t = tapi.compile(None, tapp, store=store_t, n_lanes=4,
                               device="cpu").run()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert meta_t["iterations"] == meta_j["iterations"]
    if tapp.gather == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.array_equal(got, want)
    if app == "widest" and weighted:
        assert len(np.unique(got)) > 2      # the weights shaped the widths


# ---------------------------------------------------------------------------
# the generated C++ against torch, through the host compiler
# ---------------------------------------------------------------------------

UDFS = {
    "copy": (tgas.SCATTER_OPS["copy"], "float32"),
    "copy_int": (tgas.SCATTER_OPS["copy"], "int32"),
    "add_weight": (tgas.SCATTER_OPS["add_weight"], "float32"),
    "widest": (lambda s, w: torch.minimum(s, w), "float32"),
    "scaled_sum": (lambda s, w: s * w * 0.5 + 0.25, "float32"),
    "low_bits": (lambda s, w: s & 0xFFFF, "int32"),
    "max_sub_div": (lambda s, w: torch.maximum(s - w, w / 3.0), "float32"),
    "clamp_where": (lambda s, w: torch.where(
        s > w, torch.clamp(s, min=-1.5, max=INF), -w.abs()), "float32"),
    "neg_abs_clamp_min": (lambda s, w: abs(-s) * 0.1 - s.clamp_min(0.0),
                          "float32"),
    "int_mixed": (lambda s, w: (s * 3 - 7).float() / w + s, "int32"),
    "shifts": (lambda s, w: ((s << 3) ^ ~s) | (s >> 7) | (s << 40),
               "int32"),
    "int_minmax": (lambda s, w: torch.minimum(s, s >> 1) + torch.maximum(
        s, s * 5).clamp(min=-5, max=1 << 20), "int32"),
    "cast_cmp": (lambda s, w: (s >= w).float() * s + (s != s).int(),
                 "float32"),
}

F_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                    1e-39, -3e-39, 1.17549435e-38, 3e38, -3e38, 3.4028235e38,
                    1.0, -1.5, 0.1, 2.5, 65535.7, -7.0, 1e7],
                   np.float32)
I_EDGES = np.array([0, 1, -1, 7, -7, 65535, 65536, -65536, 2 ** 31 - 1,
                    -2 ** 31, 12345678, 0x7FFF0000, 1 << 20],
                   np.int64).astype(np.int32)

_PRELUDE = """
#include <stdint.h>
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
#include "%s"
"""


@pytest.fixture(scope="module")
def host_udfs(tmp_path_factory):
    """Every UDF's expression in one host library: ``udf_<name>(p, w,
    out, n)``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine: the emitted C++ cannot be "
                    "compiled on the host")
    src = [_PRELUDE % (_build.CSRC / "gas_udf.cuh")]
    for name, (fn, dt) in UDFS.items():
        ct = udf_codegen.PROP_CTYPES[dt]
        expr = udf_codegen.scatter_expr(fn, dt)
        src.append(f"""
static inline {ct} f_{name}({ct} p, float w) {{ return {expr}; }}
extern "C" void udf_{name}(const {ct}* p, const float* w, {ct}* out,
                           int n) {{
  for (int i = 0; i < n; ++i) out[i] = f_{name}(p[i], w[i]);
}}""")
    d = tmp_path_factory.mktemp("udf")
    (d / "udfs.cpp").write_text("\n".join(src))
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(d / "libudfs.so"), str(d / "udfs.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(d / "libudfs.so"))


def _edge_inputs(dt):
    """Every (p, w) pair of edge values, tiled to a multiple of 64."""
    ps = F_EDGES if dt == "float32" else I_EDGES
    p, w = (a.ravel() for a in np.meshgrid(ps, F_EDGES, indexing="ij"))
    reps = -(-p.size // 64) * 64
    idx = np.arange(reps) % p.size
    return np.ascontiguousarray(p[idx]), np.ascontiguousarray(w[idx])


def _canonical_bits(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.float32:
        x = np.where(np.isnan(x), np.float32(np.nan), x).astype(np.float32)
    return x.view(np.int32)


@pytest.mark.parametrize("name", list(UDFS))
def test_scatter_expr_matches_torch_bit_for_bit(name, host_udfs):
    fn, dt = UDFS[name]
    p, w = _edge_inputs(dt)
    with np.errstate(all="ignore"):
        want = fn(torch.from_numpy(p), torch.from_numpy(w)).to(
            getattr(torch, dt)).numpy()
    got = np.empty_like(p)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    getattr(host_udfs, f"udf_{name}")(ptr(p), ptr(w), ptr(got),
                                      ctypes.c_int(p.size))
    bad = _canonical_bits(got) != _canonical_bits(want)
    assert not bad.any(), (
        f"{int(bad.sum())} of {p.size} differ, first at p={p[bad][0]!r} "
        f"w={w[bad][0]!r}: C++ {got[bad][0]!r}, torch {want[bad][0]!r} "
        f"({udf_codegen.scatter_expr(fn, dt)})")


def test_float_constants_are_exact():
    expr = udf_codegen.scatter_expr(lambda s, w: s * 0.1 + 3e38, "float32")
    assert f"{float(np.float32(0.1)).hex()}f" in expr
    assert f"{float(np.float32(3e38)).hex()}f" in expr
    assert "__fmul_rn" in expr and "__fadd_rn" in expr


def test_numpy_and_closure_constants():
    k = np.float32(2.5)
    got = udf_codegen.scatter_expr(lambda s, w: s * k + tgas.INF, "float32")
    assert got == ("__fadd_rn(__fmul_rn(p, 0x1.4000000000000p+1f), "
                   f"{float(tgas.INF).hex()}f)")


def test_weight_use_is_recorded():
    assert not udf_codegen.compile_scatter(
        tgas.SCATTER_OPS["copy"], "float32").uses_weight
    assert udf_codegen.compile_scatter(
        lambda s, w: torch.minimum(s, w), "float32").uses_weight


def test_traced_once_per_function():
    fn = lambda s, w: s * w + 1.0                       # noqa: E731
    a = udf_codegen.compile_scatter(fn, "float32")
    assert udf_codegen.compile_scatter(fn, "float32") is a
    assert udf_codegen.compile_scatter(fn, "int32") is not a


@pytest.mark.parametrize("fn,op", [
    (lambda s, w: torch.sin(s), "torch.sin"),
    (lambda s, w: s.exp() + w, "Tensor.exp"),
    (lambda s, w: s ** 2, "pow"),
    (lambda s, w: s // w, "floordiv"),
    (lambda s, w: s if s > 0 else w, "control flow"),
])
def test_unsupported_udf_raises_naming_the_op(fn, op):
    with pytest.raises(NotImplementedError, match=op):
        udf_codegen.scatter_expr(fn, "float32")


def test_kernel_wrapper_traces_before_it_launches(small_geom):
    """``gas_tiles`` with ``scatter_op=None`` traces the UDF first (an
    untraceable one raises NotImplementedError on any device) and then,
    on CPU tensors, refuses to launch: the plain version is
    ``run_lane(..., path="ref")``."""
    g = jrmat(10, 8, seed=3)
    gt = convert.graph_from_arrays(g.num_vertices, g.src, g.dst, g.weights)
    store = tapi.GraphStore(gt, geom=convert.geometry_from(small_geom))
    p = [q for lane in store.plan(tapi.PlanConfig(n_lanes=2)).packed_lanes(
        "cpu") for q in lane if q["kind"] == "little"][0]
    vwin = torch.zeros(store.V_pad).view(-1, small_geom.W)
    with pytest.raises(NotImplementedError, match="torch.sin"):
        gas_kernel.gas_tiles(vwin, *_blocked(p), scatter_op=None,
                             mode="sum", t=small_geom.T,
                             scatter_fn=lambda s, w: torch.sin(s))
    with pytest.raises(ValueError, match="CUDA"):
        gas_kernel.gas_tiles(vwin, *_blocked(p), scatter_op=None,
                             mode="sum", t=small_geom.T,
                             scatter_fn=lambda s, w: s * w)
    with pytest.raises(ValueError, match="scatter_fn"):
        gas_kernel.gas_tiles(vwin, *_blocked(p), scatter_op=None,
                             mode="sum", t=small_geom.T)


def test_one_library_per_udf_and_mode():
    """Each (UDF, mode) gets its own prelude and library name; the named
    ops keep the library built without one."""
    f1 = lambda s, w: torch.minimum(s, w)               # noqa: E731
    f2 = lambda s, w: torch.maximum(s, w)               # noqa: E731
    pre = {(f, m): gas_kernel.udf_prelude(f, m)
           for f in (f1, f2) for m in ("min", "max")}
    assert "#define GAS_SCATTER_EXPR(p, w) (gas_minimum(p, w))" in \
        pre[(f1, "max")]
    assert f"#define GAS_SCATTER_MODE {gas_kernel.MODES['max']}" in \
        pre[(f1, "max")]
    paths = {_build.library_path("gas_kernel", v) for v in pre.values()}
    named = _build.library_path("gas_kernel")
    assert len(paths) == 4 and named not in paths
    assert _build.library_path("gas_kernel", pre[(f1, "min")]) in paths
