"""The port's LM substrate (configs, the dense / vlm / MoE transformer
families, the LM oracles) against the JAX package, on the CPU.

Inputs come from a numpy seed; the reference's parameters come from
``build_model(cfg).init(jax.random.key(0))`` and cross leaf for leaf
through ``convert.lm_params_from_numpy``. Pieces are held at rtol 1e-5 /
atol 1e-6 in fp32; whole models at rtol 1e-4 / atol 1e-4 in fp32 and
2e-2 in bf16; teacher-forced decode against the full forward at the
reference's own tolerances (tests/test_models.py). In bf16 the port
runs op by op and so is held to the reference run op by op."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ref as jref
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models import moe_schedule as jsched
from repro.models.api import build_model as jbuild
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_schedule as tsched
from repro_torch.models.api import build_model as tbuild

B, S = 2, 32
PIECE = dict(rtol=1e-5, atol=1e-6)
ARCHS = ["qwen2_1p5b", "internlm2_1p8b", "chatglm3_6b", "command_r_35b",
         "llava_next_mistral_7b", "granite_moe_3b_a800m", "kimi_k2_1t_a32b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def test_configs_match_reference():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert tcfg.base.VOCAB_ALIGN == jcfg.base.VOCAB_ALIGN
    assert tcfg.base.EXPERT_ALIGN == jcfg.base.EXPERT_ALIGN
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    for arch in jcfg.ARCH_IDS:
        j, t = jcfg.get_config(arch), tcfg.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(tcfg.reduced(t)) == \
            dataclasses.asdict(jcfg.reduced(j)), arch
        for prop in ("hd", "vocab_padded", "num_experts_padded", "din",
                     "sub_quadratic"):
            assert getattr(t, prop) == getattr(j, prop), (arch, prop)
        for shape in jcfg.SHAPES.values():
            assert tcfg.supports(t, shape) == jcfg.supports(j, shape)
    assert tcfg.get_config("qwen2-1p5b") == tcfg.get_config("qwen2_1p5b")


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), _dtype_name(tree.dtype))


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_specs_match_reference(arch):
    """cache_specs and input_specs: the reference's tree, shapes and
    dtypes, as meta tensors (kimi's f8 cache included)."""
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    for b, s in [(2, 64), (128, 32768)]:
        got = tcfg.cache_specs(t, b, s)
        assert all(x.device.type == "meta" for x in got.values())
        assert _spec_tree(got) == _spec_tree(jcfg.cache_specs(j, b, s))
    for shape in jcfg.SHAPES.values():
        assert _spec_tree(tcfg.input_specs(t, shape)) == \
            _spec_tree(jcfg.input_specs(j, shape))


# ---------------------------------------------------------------------------
# pieces, fp32
# ---------------------------------------------------------------------------

def test_norms_match_reference(rng):
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    g = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(_np(tc.rmsnorm(_t(x), _t(g), 1e-5)),
                               _np(jc.rmsnorm(x, g, 1e-5)), **PIECE)
    np.testing.assert_allclose(_np(tc.layernorm(_t(x), _t(g), _t(b), 1e-5)),
                               _np(jc.layernorm(x, g, b, 1e-5)), **PIECE)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rope_matches_reference(rotary_dim, rng):
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = rng.randint(0, 500, (2, 7)).astype(np.int32)
    inv_j = jc.rope_freqs(16, 10000.0, rotary_dim)
    inv_t = tc.rope_freqs(16, 10000.0, rotary_dim)
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    got = tc.apply_rope(_t(x), torch.from_numpy(pos), inv_t, rotary_dim)
    np.testing.assert_allclose(
        _np(got), _np(jc.apply_rope(x, pos, inv_j, rotary_dim)),
        rtol=1e-5, atol=1e-5)
    if rotary_dim:
        np.testing.assert_array_equal(_np(got)[..., rotary_dim:],
                                      x[..., rotary_dim:])


@pytest.mark.parametrize("window", [None, 20])
def test_blockwise_attention_matches_reference(window, rng):
    """S = 50 at 16-wide blocks, so the last q and kv blocks are padded;
    GQA (4 heads over 2 KV heads); with and without a window."""
    q = rng.randn(2, 50, 4, 16).astype(np.float32)
    k = rng.randn(2, 50, 2, 16).astype(np.float32)
    v = rng.randn(2, 50, 2, 16).astype(np.float32)
    kw = dict(causal=True, window=window, q_block=16, kv_block=16)
    got = tc.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    want = jc.blockwise_attention(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **PIECE)
    # and against the port's exact oracle, per batch over repeated heads
    kk = tc._repeat_kv(_t(k), 2)
    vv = tc._repeat_kv(_t(v), 2)
    for bi in range(2):
        o = tref.flash_attention_ref(_t(q)[bi].transpose(0, 1),
                                     kk[bi].transpose(0, 1),
                                     vv[bi].transpose(0, 1), True, window)
        np.testing.assert_allclose(_np(got[bi]), _np(o.transpose(0, 1)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 20])
def test_flash_attention_ref_matches_reference(window, rng):
    q, k, v = (rng.randn(4, 50, 16).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        _np(tref.flash_attention_ref(_t(q), _t(k), _t(v), True, window)),
        _np(jref.flash_attention_ref(q, k, v, True, window)), **PIECE)


@pytest.mark.parametrize("length,window", [
    (23, None), ("per_row", None), (23, 8), ("per_row", 8)])
def test_decode_attention_matches_reference(length, window, rng):
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    kc = rng.randn(3, 40, 2, 16).astype(np.float32)
    vc = rng.randn(3, 40, 2, 16).astype(np.float32)
    ln = np.array([5, 23, 40], np.int32) if length == "per_row" else length
    got = tc.decode_attention(_t(q), _t(kc), _t(vc),
                              torch.as_tensor(ln), window=window)
    want = jc.decode_attention(q, kc, vc, jnp.asarray(ln), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **PIECE)


def test_decode_attention_f8_cache_matches_reference(rng):
    """An f8 cache (kimi's): the softmax weights are rounded to the
    cache's dtype before the product, as the reference."""
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    kc = rng.randn(2, 24, 2, 16).astype(np.float32)
    vc = rng.randn(2, 24, 2, 16).astype(np.float32)
    kj = jnp.asarray(kc).astype(jnp.float8_e4m3fn)
    vj = jnp.asarray(vc).astype(jnp.float8_e4m3fn)
    kt = convert.lm_params_from_numpy(np.asarray(kj), "cpu")
    vt = convert.lm_params_from_numpy(np.asarray(vj), "cpu")
    assert kt.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_np(kt), _np(kj.astype(jnp.float32)))
    got = tc.decode_attention(_t(q), kt, vt, 17)
    want = jc.decode_attention(jnp.asarray(q), kj, vj, 17)
    np.testing.assert_allclose(_np(got), _np(want), **PIECE)


def test_mlps_match_reference(rng):
    x = rng.randn(2, 5, 16).astype(np.float32)
    wg, wu = (rng.randn(16, 24).astype(np.float32) for _ in range(2))
    wd = rng.randn(24, 16).astype(np.float32)
    bu, bd = rng.randn(24).astype(np.float32), rng.randn(16).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(tc.gated_mlp(_t(x), _t(wg), _t(wu), _t(wd))),
        _np(jc.gated_mlp(x, wg, wu, wd)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tc.gelu_mlp(_t(x), _t(wu), _t(bu), _t(wd), _t(bd))),
        _np(jc.gelu_mlp(x, wu, bu, wd, bd)), rtol=1e-5, atol=1e-5)


def test_cross_entropy_matches_reference(rng):
    logits = rng.randn(2, 4, 16).astype(np.float32)
    labels = np.array([[1, 2, -1, 3], [0, -1, -1, 11]], np.int32)
    for vocab_real in (None, 12):
        got = tc.cross_entropy(_t(logits), torch.from_numpy(labels),
                               vocab_real)
        want = jc.cross_entropy(logits, labels, vocab_real)
        np.testing.assert_allclose(float(got), float(want), **PIECE)
    none = np.full((2, 4), -1, np.int32)
    assert float(tc.cross_entropy(_t(logits), torch.from_numpy(none), 12)) \
        == float(jc.cross_entropy(logits, none, 12)) == 0.0


@pytest.mark.parametrize("num_experts", [8, 48, 384])
def test_biglittle_split_equals_reference(num_experts):
    for top_k in (2, 8):
        for tokens in (1, 16, 512, 65536):
            for cf in (1.0, 1.25, 50.0):
                for round_to in (1, 4):
                    args = (num_experts, top_k, tokens, cf)
                    assert tsched.biglittle_split(*args, round_to=round_to) \
                        == jsched.biglittle_split(*args, round_to=round_to)
            assert tsched.padded_flops_ratio(num_experts, top_k, tokens) == \
                jsched.padded_flops_ratio(num_experts, top_k, tokens)
    assert tsched.zipf_loads(num_experts) == jsched.zipf_loads(num_experts)


def _moe_layer(rng, E=16, D=32, Fd=24):
    """A router and distinct per-expert weights (fp32)."""
    return {"router": rng.randn(D, E).astype(np.float32),
            "we_gate": rng.randn(E, D, Fd).astype(np.float32) / np.sqrt(D),
            "we_up": rng.randn(E, D, Fd).astype(np.float32) / np.sqrt(D),
            "we_down": rng.randn(E, Fd, D).astype(np.float32) / np.sqrt(Fd)}


@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25), ("dense", 50.0),
                                         ("biglittle", 1.25),
                                         ("biglittle", 50.0)])
def test_moe_ffn_tokens_matches_reference(dispatch, cf, rng):
    """Both dispatch modes, with drops (cf 1.25) and without (cf 50);
    12 real experts padded to 16."""
    cfg = dataclasses.replace(
        jcfg.reduced(jcfg.get_config("granite_moe_3b_a800m")),
        num_experts=12, top_k=4, moe_dispatch=dispatch, d_model=32,
        dtype="float32")
    lp = _moe_layer(rng)
    x = rng.randn(48, 32).astype(np.float32)
    want, aux_j = jmoe._moe_ffn_tokens(
        cfg, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], x,
        jnp.int32(0), 16, 1, cf)
    tl = {k: _t(v) for k, v in lp.items()}
    got, aux_t = tmoe._moe_ffn_tokens(
        cfg, tl["router"], tl["we_gate"], tl["we_up"], tl["we_down"], _t(x),
        0, 16, 1, cf)
    np.testing.assert_allclose(_np(got), _np(want), **PIECE)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **PIECE)
    if cf == 50.0:           # nothing drops: the exact mixture
        logits = x @ lp["router"]
        logits[:, 12:] = -1e30
        exact = tref.moe_dispatch_ref(_t(x), _t(logits), tl["we_gate"],
                                      tl["we_up"], tl["we_down"], 4)
        np.testing.assert_allclose(_np(got), _np(exact), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(
            _np(exact), _np(jref.moe_dispatch_ref(
                x, logits, lp["we_gate"], lp["we_up"], lp["we_down"], 4)),
            **PIECE)


def test_moe_dispatch_pieces_match_reference(rng):
    """The router, the ranks within an expert and one uniform-capacity
    group dispatch (drops included: capacity 3)."""
    lp = _moe_layer(rng)
    x = rng.randn(40, 32).astype(np.float32)
    gw_j, gi_j, aux_j = jmoe._route(x, lp["router"], 4, 12)
    gw_t, gi_t, aux_t = tmoe._route(_t(x), _t(lp["router"]), 4, 12)
    np.testing.assert_array_equal(gi_t.numpy(), np.asarray(gi_j))
    np.testing.assert_allclose(_np(gw_t), _np(gw_j), **PIECE)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **PIECE)
    flat = np.asarray(gi_j).reshape(-1).astype(np.int32)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    np.testing.assert_array_equal(
        tmoe._ranks_in_expert(torch.from_numpy(sorted_e)).numpy(),
        np.asarray(jmoe._ranks_in_expert(jnp.asarray(sorted_e))))
    rank = np.asarray(jmoe._ranks_in_expert(jnp.asarray(sorted_e)))
    tok_id = (order // 4).astype(np.int32)
    gatew = np.asarray(gw_j).reshape(-1)[order]
    sl = slice(4, 10)
    want = jmoe._dispatch_group(x, tok_id, sorted_e, rank, gatew, 4, 10, 3,
                                lp["we_gate"][sl], lp["we_up"][sl],
                                lp["we_down"][sl])
    got = tmoe._dispatch_group(
        _t(x), torch.from_numpy(tok_id).long(), torch.from_numpy(sorted_e),
        torch.from_numpy(rank), _t(gatew), 4, 10, 3,
        _t(lp["we_gate"][sl]), _t(lp["we_up"][sl]), _t(lp["we_down"][sl]))
    np.testing.assert_allclose(_np(got), _np(want), **PIECE)


# ---------------------------------------------------------------------------
# whole models, per arch
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype):
    j = jcfg.reduced(jcfg.get_config(arch))
    if dtype:
        j = dataclasses.replace(j, dtype=dtype)
    return j, tcfg.base.ArchConfig(**dataclasses.asdict(j))


def _batch(cfg, seed, dt):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"labels": tok}
    if cfg.frontend == "vision":
        batch["embeds"] = rs.randn(B, S, cfg.d_model).astype(np.float32)
    else:
        batch["tokens"] = tok
    jb = {k: (jnp.asarray(v, dt) if k == "embeds" else jnp.asarray(v))
          for k, v in batch.items()}
    return jb, convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jb.items()}, "cpu")


_CACHE = {}


def _pair(arch, dtype):
    """(jax model, jax params, port model, port params, batches, jax
    logits), built once per (arch, dtype) in this process. In bf16 the
    reference runs op by op (``jax.disable_jit``): its compiled scan
    keeps fused bf16 chains in f32 and differs from its own op-by-op
    run by up to 0.05 in these logits, while the port runs op by op."""
    key = (arch, dtype)
    if key not in _CACHE:
        jc_, tc_ = _cfgs(arch, dtype)
        jm, tm = jbuild(jc_), tbuild(tc_)
        jp = jm.init(jax.random.key(0))
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu")
        jb, tb = _batch(jc_, 1, jnp.dtype(jc_.dtype))
        if dtype == "float32":
            want = (jm.forward(jp, jb), jm.loss(jp, jb))
        else:
            with jax.disable_jit():
                want = (jm.forward(jp, jb), jm.loss(jp, jb))
        _CACHE[key] = (jm, jp, tm, tp, jb, tb, want)
    return _CACHE[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), (None, 2e-2)])
def test_forward_and_loss_match_reference(arch, dtype, tol):
    """forward logits and the loss, port against JAX (fp32 at 1e-4, the
    config's bf16 at 2e-2), and the param tree leaf for leaf."""
    jm, jp, tm, tp, jb, tb, (want, want_loss) = _pair(arch, dtype)
    specs = tm.param_specs()
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(
        len(v) if isinstance(v, dict) else 1 for v in specs.values())
    for path, leaf in flat_j:
        names = [p.key for p in path]
        spec, got = specs, tp
        for n in names:
            spec, got = spec[n], got[n]
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(got.shape) == leaf.shape, names
        assert _dtype_name(spec.dtype) == _dtype_name(got.dtype) == \
            leaf.dtype.name, names
    with torch.inference_mode():
        logits = tm.forward(tp, tb)
        loss = tm.loss(tp, tb)
    assert logits.dtype == tcfg.torch_dtype(tm.cfg.dtype)
    assert logits.shape == (B, S, tm.cfg.vocab_padded)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_forward_and_reference(arch):
    """prefill's last logits equal forward's last position; its cache
    equals the reference's prefill cache (fp32; kimi's cache is f8)."""
    jm, jp, tm, tp, jb, tb, _ = _pair(arch, "float32")
    with torch.inference_mode():
        full = tm.forward(tp, tb)
        cache, last = tm.prefill(tp, tb)
    np.testing.assert_allclose(_np(last), _np(full[:, -1:]), rtol=1e-5,
                               atol=1e-5)
    jcache, jlast = jm.prefill(jp, jb)
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        assert cache[name].dtype == tcfg.torch_dtype(
            tm.cfg.kv_cache_dtype or tm.cfg.dtype)
        np.testing.assert_allclose(
            _np(cache[name]), _np(jnp.asarray(jcache[name], jnp.float32)),
            rtol=1e-4, atol=1e-4 if cache[name].element_size() > 1 else 0.1)


def _teacher_forced(model, params, tok, grow_to):
    """Prefill the first half, grow the cache to ``grow_to`` positions,
    then decode the rest one token at a time."""
    half = S // 2
    cache, last = model.prefill(params, {"tokens": tok[:, :half]})
    cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (grow_to - half,)
                                          + v.shape[3:])], dim=2)
             for k, v in cache.items()}
    steps = [last]
    for t in range(half, S - 1):
        logits, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        steps.append(logits)
    return steps


def _teacher_forced_ref(jm, jp, tok, jit=True):
    """The same through the reference's prefill and decode_step (jitted,
    or op by op under ``jax.disable_jit``)."""
    half = S // 2
    prefill, decode = ((jax.jit(jm.prefill), jax.jit(jm.decode_step)) if jit
                       else (jm.prefill, jm.decode_step))
    cache, last = prefill(jp, {"tokens": jnp.asarray(tok[:, :half])})
    cache = jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, S - half)] + [(0, 0)] * (x.ndim - 3)), cache)
    steps = [last]
    for t in range(half, S - 1):
        logits, cache = decode(jp, cache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
        steps.append(logits)
    return steps


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), (None, 2e-2)])
def test_decode_matches_forward_and_reference(arch, dtype, tol):
    """Teacher-forced decode_step, step by step, against the reference's
    own (fp32 at 1e-4; the config's bf16 at 2e-2, the reference run op
    by op), and in fp32 against the port's forward at the reference's
    tolerances (2e-2 for the prefill's last logits, 5e-2 per step).

    The bf16 run is held to the reference's decode, not to the forward:
    run op by op, the reference's own bf16 decode drifts from its
    forward past 5e-2 on some inputs (by up to 8.3e-3 beyond it for
    granite, 9e-4 for chatglm3, at 32 tokens from seeds 0 and 2), and
    the port equals it (chatglm3 bit for bit)."""
    jm, jp, tm, tp, _, _, _ = _pair(arch, dtype)
    tok = np.random.RandomState(2).randint(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    tt = torch.from_numpy(tok)
    with torch.inference_mode():
        got = _teacher_forced(tm, tp, tt, S)
        full = tm.forward(tp, {"tokens": tt})
    if dtype == "float32":
        want = _teacher_forced_ref(jm, jp, tok)
    else:
        with jax.disable_jit():
            want = _teacher_forced_ref(jm, jp, tok, jit=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
    if dtype != "float32" or tm.cfg.kv_cache_dtype:
        return    # bf16 and an f8 cache: held to the reference's decode
    half = S // 2
    np.testing.assert_allclose(_np(got[0][:, 0]), _np(full[:, half - 1]),
                               rtol=2e-2, atol=2e-2)
    for t, logits in zip(range(half, S - 1), got[1:]):
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   rtol=5e-2, atol=5e-2)


def test_init_is_seeded_and_lands_on_the_generator_device():
    m = tbuild(tcfg.reduced(tcfg.get_config("granite_moe_3b_a800m")))
    a = m.init(torch.Generator("cpu").manual_seed(3))
    b = m.init(torch.Generator("cpu").manual_seed(3))
    for k in ("embed", "lm_head"):
        assert torch.equal(a[k], b[k]) and a[k].device.type == "cpu"
    for k, v in a["layers"].items():
        assert torch.equal(v, b["layers"][k])
        assert v.shape[0] == m.cfg.num_layers
    # as the reference: every expert starts from the same matrices
    assert torch.equal(a["layers"]["we_up"][0, 0], a["layers"]["we_up"][0, 5])
