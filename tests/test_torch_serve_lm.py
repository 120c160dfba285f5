"""The port's LM serving path (``serve/``, ``launch/serve.py``) against
the JAX package, on the CPU: the same fp32 parameters served at
temperature 0 give the same tokens through both engines; the
reference's two serve tests, mirrored on the port; ``cache_bytes`` and
the decode caches against the reference's; the launcher with
``--device cpu``; and no serving without a card unless ``device="cpu"``.
Sampling above temperature 0 draws from a torch Generator, not JAX's
keys, so sampled tokens are not compared across the packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models.api import build_model as jbuild
from repro.serve import kvcache as jkv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tcfg
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the CPU among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(arch, seed=0):
    model = tbuild(tcfg.reduced(tcfg.get_config(arch)))
    return model, model.init(torch.Generator("cpu").manual_seed(seed))


def _prompts(rng, vocab, n, lo, hi):
    return [rng.randint(0, vocab, rng.randint(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "granite_moe_3b_a800m"])
def test_engine_tokens_equal_reference(arch, rng):
    """Both engines, the same fp32 parameters, temperature 0: the same
    tokens for a 5-request queue at max_batch=3 (two waves, ragged
    prompts left-padded)."""
    cfg = dataclasses.replace(jcfg.reduced(jcfg.get_config(arch)),
                              dtype="float32")
    jm, tm = jbuild(cfg), tbuild(tcfg.base.ArchConfig(
        **dataclasses.asdict(cfg)))
    jp = jm.init(jax.random.key(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _prompts(rng, cfg.vocab_size, 5, 6, 12)
    want = [JRequest(tokens=p, max_new_tokens=6) for p in prompts]
    got = [Request(tokens=p, max_new_tokens=6) for p in prompts]
    JServeEngine(jm, jp, max_batch=3, max_seq=32).serve(want)
    stats = ServeEngine(tm, tp, max_batch=3, max_seq=32,
                        device="cpu").serve(got)
    assert stats["requests"] == 5 and stats["generated_tokens"] == 30
    for g, w in zip(got, want):
        assert g.out.tolist() == w.out.tolist()


def test_serve_engine_waves(rng):
    """The reference's test_serve_engine_waves, on the port."""
    model, params = _port_model("qwen2_1p5b")
    eng = ServeEngine(model, params, max_batch=3, max_seq=48, device="cpu")
    reqs = [Request(tokens=rng.randint(0, model.cfg.vocab_size, 12)
                    .astype(np.int32), max_new_tokens=6) for _ in range(5)]
    stats = eng.serve(reqs)
    assert stats["requests"] == 5
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert stats["tokens_per_s"] > 0 and stats["mean_ttft_s"] > 0


def test_serve_greedy_matches_decode_path(rng):
    """The reference's test_serve_greedy_matches_decode_path, on the
    port: engine greedy output == a manual prefill + decode loop."""
    model, params = _port_model("internlm2_1p8b")
    cfg = model.cfg
    prompt = rng.randint(0, cfg.vocab_size, 10).astype(np.int32)
    eng = ServeEngine(model, params, max_batch=1, max_seq=32, device="cpu")
    [req] = eng.run_wave([Request(tokens=prompt, max_new_tokens=5)])
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.from_numpy(prompt)[None]})
        cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (8,)
                                              + v.shape[3:])], dim=2)
                 for k, v in cache.items()}
        out = [int(torch.argmax(logits[0, -1, :cfg.vocab_size]))]
        for t in range(4):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[out[-1]]], dtype=torch.int32),
                10 + t)
            out.append(int(torch.argmax(logits[0, 0, :cfg.vocab_size])))
    assert req.out.tolist() == out


def test_eos_ends_a_request_and_sampling_is_seeded(rng):
    """A request stops at its eos; sampling at temperature > 0 repeats
    under the same Generator seed."""
    model, params = _port_model("qwen2_1p5b")
    prompt = rng.randint(0, model.cfg.vocab_size, 8).astype(np.int32)
    eng = ServeEngine(model, params, max_batch=2, max_seq=32, device="cpu")
    [free] = eng.run_wave([Request(tokens=prompt, max_new_tokens=6)])
    eos = int(free.out[2])
    first = free.out.tolist().index(eos)
    a, b = eng.run_wave([Request(tokens=prompt, max_new_tokens=6,
                                 eos_id=eos),
                         Request(tokens=prompt, max_new_tokens=6)])
    assert a.out.tolist() == free.out[:first + 1].tolist()
    assert b.out.tolist() == free.out.tolist()
    hot = ServeEngine(model, params, max_batch=2, max_seq=32,
                      temperature=1.5, device="cpu")
    outs = [hot.run_wave([Request(tokens=prompt, max_new_tokens=6)],
                         rng=torch.Generator().manual_seed(s))[0].out
            for s in (7, 7)]
    assert outs[0].tolist() == outs[1].tolist()


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_cache_bytes_and_init_cache_match_reference(arch):
    """cache_bytes equals the reference's wherever every leaf has fewer
    than 2**31 elements; past that the reference's int32 ``jnp.prod``
    of the shape wraps (decode_32k: 128 x 32768), and the port's count
    is the exact one."""
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    for b, s in [(1, 16), (8, 544), (128, 32768)]:
        exact = sum(x.element_size() * int(np.prod(x.shape, dtype=object))
                    for x in tcfg.cache_specs(t, b, s).values())
        assert tkv.cache_bytes(t, b, s) == exact
        if max(x.numel() for x in tcfg.cache_specs(t, b, s).values()) \
                < 2 ** 31:
            assert exact == jkv.cache_bytes(j, b, s)
    jr, tr = jcfg.reduced(j), tcfg.reduced(t)
    want = jkv.init_cache(jr, 2, 16)
    got = tkv.init_cache(tr, 2, 16, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).replace("torch.", "") == want[k].dtype.name
        assert not v.float().any()
    k = got.get("k")
    if k is not None:
        np.testing.assert_array_equal(
            tkv.trim_left_pad(k.float(), 5).numpy(),
            np.asarray(jkv.trim_left_pad(jnp.asarray(k.float().numpy()), 5)))


def test_launcher_runs_on_cpu(capsys):
    stats = tlaunch.main(["--device", "cpu", "--requests", "3",
                          "--batch", "2", "--prompt-len", "8",
                          "--max-new", "4"])
    assert stats["requests"] == 3 and stats["generated_tokens"] == 12
    assert stats["device"] == "cpu"
    assert "tokens_per_s" in capsys.readouterr().out


def test_serving_raises_without_cuda(monkeypatch):
    """With CUDA hidden, the engine, the cache and the launcher raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = _port_model("qwen2_1p5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.init_cache(model.cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--requests", "1"])
    with pytest.raises(ValueError, match="params are on cpu"):
        ServeEngine(model, params, device="meta")
