"""The port's recurrent and encoder-decoder families (mamba2, hymba,
whisper) against the JAX package, on the CPU.

Inputs come from a numpy seed; the reference's parameters come from
``build_model(cfg).init(jax.random.key(0))`` and cross leaf for leaf
through ``convert.lm_params_from_numpy``. Tolerances: the SSD scan alone
at rtol 1e-5 / atol 1e-5 (fp32); whole models at rtol 1e-4 / atol 1e-4
in fp32 and 2e-2 in bf16, where the reference runs op by op under
``jax.disable_jit()`` as the port does; teacher-forced decode against
the port's own forward at the reference's tolerances
(tests/test_models.py:63-98: 2e-2 for the prefill's last logits, 8e-2
per step for ssm / hybrid, 5e-2 otherwise), and against the reference's
decode at 1e-4 in fp32 and at those same per-family tolerances in bf16.

Why bf16 decode is held at the reference test's decode tolerance and
not at 2e-2: XLA's CPU dot and torch's sum a bf16 product's f32 terms
in different orders, so a few products round to the other side of a
bf16 tie (one ulp, in 1 of ~200 values of a (2, 16, 64) @ (64, 2048)
product); over whisper's prefill and decode those flips move small
logits by up to 0.024."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import mamba2 as jmamba
from repro.models.api import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve.engine import Request, ServeEngine

B, S = 2, 32
ARCHS = ["mamba2_2p7b", "hymba_1p5b", "whisper_tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, dtype):
    j = jcfg.reduced(jcfg.get_config(arch))
    if dtype:
        j = dataclasses.replace(j, dtype=dtype)
    return j, tcfg.base.ArchConfig(**dataclasses.asdict(j))


def _batch(cfg, seed, s=S):
    """(reference batch, port batch): tokens, labels and, for whisper,
    frame embeddings in the config's dtype."""
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    if cfg.frontend == "audio":
        jb["enc_embeds"] = jnp.asarray(
            rs.randn(B, cfg.encoder_seq, cfg.d_model), jnp.dtype(cfg.dtype))
    return jb, convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jb.items()}, "cpu")


_CACHE = {}


def _pair(arch, dtype):
    """(jax model, jax params, port model, port params), once per (arch,
    dtype) in this process."""
    key = (arch, dtype)
    if key not in _CACHE:
        jc_, tc_ = _cfgs(arch, dtype)
        jm, tm = jbuild(jc_), tbuild(tc_)
        jp = jm.init(jax.random.key(0))
        tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu")
        _CACHE[key] = (jm, jp, tm, tp)
    return _CACHE[key]


def _ref(fn, dtype, *args):
    """The reference, compiled in fp32 and op by op in bf16."""
    if dtype == "float32":
        return fn(*args)
    with jax.disable_jit():
        return fn(*args)


# ---------------------------------------------------------------------------
# the SSD scan alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 100, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(seq, with_h0):
    """S = 1 (one short chunk), 100 (one padded chunk), 300 (three
    chunks, the last padded), from a zero or a given state."""
    cfg, tcfg_ = _cfgs("mamba2_2p7b", "float32")
    rs = np.random.RandomState(seq)
    H, P, N = 4, 16, 8
    x = rs.randn(B, seq, H, P).astype(np.float32)
    Bm = rs.randn(B, seq, N).astype(np.float32)
    Cm = rs.randn(B, seq, N).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, seq, H))).astype(np.float32) * 0.1
    A = -np.exp(rs.randn(H)).astype(np.float32)
    D = rs.randn(H).astype(np.float32)
    h0 = rs.randn(B, H, P, N).astype(np.float32) if with_h0 else None
    want_y, want_h = jmamba.ssd_chunked(
        cfg, x, Bm, Cm, dt, A, D, None if h0 is None else jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A, D)]
    got_y, got_h = tmamba.ssd_chunked(
        tcfg_, *t, None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(got_h), _np(want_h), rtol=1e-5,
                               atol=1e-5)


def test_softplus_is_logaddexp():
    """Above F.softplus's threshold of 20 the reference still adds
    log1p(exp(-x))."""
    x = torch.tensor([-30.0, -1.0, 0.0, 3.0, 20.5, 40.0])
    np.testing.assert_array_equal(
        _np(tmamba.softplus(x)), _np(jax.nn.softplus(x.numpy())))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), (None, 2e-2)])
def test_forward_and_loss_match_reference(arch, dtype, tol):
    """forward logits and the loss, port against JAX (fp32 at 1e-4, the
    config's bf16 at 2e-2), and the param tree leaf for leaf."""
    jm, jp, tm, tp = _pair(arch, dtype)
    specs = tm.param_specs()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_spec = sum(len(v) if isinstance(v, dict) else 1
                 for v in specs.values())
    assert len(flat) == n_spec
    for path, leaf in flat:
        spec, got = specs, tp
        for p in path:
            spec, got = spec[p.key], got[p.key]
        assert tuple(spec.shape) == tuple(got.shape) == leaf.shape
        assert str(spec.dtype) == str(got.dtype) == "torch." + \
            leaf.dtype.name
    jb, tb = _batch(tm.cfg, 1)
    want, want_loss = _ref(lambda: (jm.forward(jp, jb), jm.loss(jp, jb)),
                           dtype)
    with torch.inference_mode():
        logits = tm.forward(tp, tb)
        loss = tm.loss(tp, tb)
    assert logits.dtype == tcfg.torch_dtype(tm.cfg.dtype)
    assert logits.shape == (B, S, tm.cfg.vocab_padded)
    np.testing.assert_allclose(_np(logits), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), (None, 2e-2)])
def test_prefill_matches_forward_and_reference(arch, dtype, tol):
    """prefill's last logits equal forward's last position; they and the
    decode state equal the reference's prefill leaf for leaf (fp32 at
    1e-4, bf16 at 2e-2)."""
    jm, jp, tm, tp = _pair(arch, dtype)
    jb, tb = _batch(tm.cfg, 3)
    with torch.inference_mode():
        full = tm.forward(tp, tb)
        cache, last = tm.prefill(tp, tb)
    np.testing.assert_allclose(_np(last), _np(full[:, -1:]), rtol=1e-5,
                               atol=1e-5)
    jcache, jlast = _ref(lambda: jm.prefill(jp, jb), dtype)
    np.testing.assert_allclose(_np(last), _np(jlast), rtol=tol, atol=tol)
    assert sorted(cache) == sorted(jcache)
    for name, want in jcache.items():
        assert tuple(cache[name].shape) == want.shape, name
        assert str(cache[name].dtype) == "torch." + want.dtype.name, name
        np.testing.assert_allclose(_np(cache[name]), _np(want), rtol=tol,
                                   atol=tol, err_msg=name)


def _grow(cfg, cache, to, half):
    """Grow attention caches (axis 2) from ``half`` to ``to`` positions;
    recurrent state and the cross-attention cache stay as they are."""
    if cfg.family in ("ssm", "hybrid"):
        return cache
    return {k: (torch.cat([v, v.new_zeros(v.shape[:2] + (to - half,)
                                          + v.shape[3:])], dim=2)
                if k in ("k", "v") else v)
            for k, v in cache.items()}


def _teacher_forced(model, params, tb, half, s):
    cache, last = model.prefill(params, {**tb, "tokens": tb["tokens"][:,
                                                                   :half]})
    cache = _grow(model.cfg, cache, s, half)
    steps = [last]
    for t in range(half, s - 1):
        logits, cache = model.decode_step(params, cache,
                                          tb["tokens"][:, t:t + 1], t)
        steps.append(logits)
    return steps


def _teacher_forced_ref(jm, jp, jb, half, s, jit):
    prefill, decode = ((jax.jit(jm.prefill), jax.jit(jm.decode_step)) if jit
                       else (jm.prefill, jm.decode_step))
    cache, last = prefill(jp, {**jb, "tokens": jb["tokens"][:, :half]})
    if jm.cfg.family not in ("ssm", "hybrid"):
        cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, s - half)]
                             + [(0, 0)] * (v.ndim - 3))
                     if k in ("k", "v") else v) for k, v in cache.items()}
    steps = [last]
    for t in range(half, s - 1):
        logits, cache = decode(jp, cache, jb["tokens"][:, t:t + 1],
                               jnp.int32(t))
        steps.append(logits)
    return steps


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", None])
def test_decode_matches_forward_and_reference(arch, dtype):
    """Teacher-forced decode_step, step by step, against the reference's
    own (fp32 at 1e-4; bf16, the reference op by op, at the reference
    test's decode tolerance), and in fp32 against the port's forward at
    the reference's tolerances."""
    jm, jp, tm, tp = _pair(arch, dtype)
    step_tol = 8e-2 if tm.cfg.family in ("ssm", "hybrid") else 5e-2
    tol = 1e-4 if dtype == "float32" else step_tol
    jb, tb = _batch(tm.cfg, 2)
    half = S // 2
    with torch.inference_mode():
        got = _teacher_forced(tm, tp, tb, half, S)
        full = tm.forward(tp, tb)
    if dtype == "float32":
        want = _teacher_forced_ref(jm, jp, jb, half, S, jit=True)
    else:
        with jax.disable_jit():
            want = _teacher_forced_ref(jm, jp, jb, half, S, jit=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
    if dtype != "float32":
        return
    np.testing.assert_allclose(_np(got[0][:, 0]), _np(full[:, half - 1]),
                               rtol=2e-2, atol=2e-2)
    for t, logits in zip(range(half, S - 1), got[1:]):
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   rtol=step_tol, atol=step_tol)


def test_hymba_prompt_longer_than_its_window():
    """A 40-token prompt against the reduced window of 32: the cache
    keeps the last 32 rotated keys (the S >= W branch; the other tests'
    16-token prompts take the left-padded one), equal to the
    reference's; decoding on past the window edge stays with the
    reference and with forward (fp32)."""
    jm, jp, tm, tp = _pair("hymba_1p5b", "float32")
    W = tm.cfg.sliding_window
    s, half = 48, 40
    assert half > W
    jb, tb = _batch(tm.cfg, 4, s)
    with torch.inference_mode():
        got = _teacher_forced(tm, tp, tb, half, s)
        full = tm.forward(tp, tb)
        cache, _ = tm.prefill(tp, {"tokens": tb["tokens"][:, :half]})
    jcache, _ = jm.prefill(jp, {"tokens": jb["tokens"][:, :half]})
    assert cache["k"].shape[2] == W
    for name in ("k", "v", "ssm_state"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   rtol=1e-4, atol=1e-4)
    want = _teacher_forced_ref(jm, jp, jb, half, s, jit=True)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(g[:, 0]), _np(full[:, half - 1 + t]),
                                   rtol=8e-2, atol=8e-2)


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "hymba_1p5b"])
def test_engine_on_recurrent_state(arch, rng):
    """ServeEngine on the recurrent families: the decode state is not
    grown (mamba2's 4-head axis 2 and hymba's window would match the
    grow rule), a max_batch=1 engine equals a manual prefill + decode
    loop, and a 5-request queue in two waves gives the reference
    engine's tokens (fp32, temperature 0)."""
    jm, jp, tm, tp = _pair(arch, "float32")
    cfg = tm.cfg
    prompt = rng.randint(0, cfg.vocab_size, 10).astype(np.int32)
    eng = ServeEngine(tm, tp, max_batch=1, max_seq=32, device="cpu")
    with torch.inference_mode():
        cache, logits = tm.prefill(tp, {"tokens": torch.from_numpy(
            prompt)[None]})
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        assert {k: tuple(v.shape) for k, v in
                eng._grow_cache(cache, 9).items()} == shapes
        out = [int(torch.argmax(logits[0, -1, :cfg.vocab_size]))]
        for t in range(4):
            logits, cache = tm.decode_step(
                tp, cache, torch.tensor([[out[-1]]], dtype=torch.int32),
                10 + t)
            out.append(int(torch.argmax(logits[0, 0, :cfg.vocab_size])))
    [req] = eng.run_wave([Request(tokens=prompt, max_new_tokens=5)])
    assert req.out.tolist() == out

    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(6, 13))
               .astype(np.int32) for _ in range(5)]
    want = [JRequest(tokens=p, max_new_tokens=6) for p in prompts]
    got = [Request(tokens=p, max_new_tokens=6) for p in prompts]
    JServeEngine(jm, jp, max_batch=3, max_seq=32).serve(want)
    ServeEngine(tm, tp, max_batch=3, max_seq=32, device="cpu").serve(got)
    for g, w in zip(got, want):
        assert g.out.tolist() == w.out.tolist()


def test_whisper_manual_greedy_loop_matches_reference():
    """Whisper is served by a manual prefill + greedy decode loop (the
    engine passes no frame embeddings): 8 greedy tokens after a
    12-token prompt, equal to the reference's loop (fp32)."""
    jm, jp, tm, tp = _pair("whisper_tiny", "float32")
    jb, tb = _batch(tm.cfg, 5)
    V, n_new, plen = tm.cfg.vocab_size, 8, 12

    def loop(prefill, decode, grow, argmax, tok, batch):
        cache, logits = prefill({**batch, "tokens": batch["tokens"][:, :plen]})
        cache = grow(cache)
        out = [argmax(logits[:, -1, :V])]
        for t in range(n_new - 1):
            logits, cache = decode(cache, tok(out[-1]), plen + t)
            out.append(argmax(logits[:, 0, :V]))
        return np.stack(out, 1)

    with torch.inference_mode():
        got = loop(lambda b: tm.prefill(tp, b),
                   lambda c, t, n: tm.decode_step(tp, c, t, n),
                   lambda c: _grow(tm.cfg, c, plen + n_new, plen),
                   lambda lg: torch.argmax(lg, -1).to(torch.int32).numpy(),
                   lambda o: torch.from_numpy(o)[:, None], tb)
    want = loop(jax.jit(lambda b: jm.prefill(jp, b)),
                jax.jit(lambda c, t, n: jm.decode_step(jp, c, t, n)),
                lambda c: {k: (jnp.pad(v, [(0, 0), (0, 0), (0, n_new)]
                                       + [(0, 0)] * 2)
                               if k in ("k", "v") else v)
                           for k, v in c.items()},
                lambda lg: np.asarray(jnp.argmax(lg, -1), np.int32),
                lambda o: jnp.asarray(o)[:, None], jb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_build_model_builds_every_arch(arch):
    """Every one of the ten archs builds (the reference's
    test_arch_smoke, on the port): reduced config, seeded init on the
    generator's device, finite logits of the padded vocab."""
    model = tbuild(tcfg.reduced(tcfg.get_config(arch)))
    params = model.init(torch.Generator("cpu").manual_seed(0))
    cfg = model.cfg
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S))
                           .astype(np.int32))
    batch = {"labels": tok, "tokens": tok}
    if cfg.frontend == "vision":
        batch = {"labels": tok, "embeds": torch.randn(B, S, cfg.d_model)}
    elif cfg.frontend == "audio":
        batch["enc_embeds"] = torch.randn(B, cfg.encoder_seq, cfg.d_model)
    with torch.inference_mode():
        logits = model.forward(params, batch)
        loss = model.loss(params, batch)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss))
