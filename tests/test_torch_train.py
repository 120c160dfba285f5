"""The port's training path (``optim/``, ``checkpoint/``, ``data/``,
``train/``, ``launch/train.py`` and the flash-attention backward) against
the JAX package, on the CPU.

Tolerances: optimizer params and states after 3 steps at rtol 1e-5 /
atol 1e-7 (fp32); schedules at rtol 1e-6; codecs exactly; pipeline
batches and checkpoint round trips bit for bit; ``_Flash`` gradients
against ``jax.vjp`` of the reference's ``_flash`` at rtol 1e-4 / atol
1e-5 in fp32 and 2e-2 in bf16 (the reference run op by op, as the port
runs); loss and grads of one reduced arch per family against
``jax.value_and_grad`` at rtol 1e-4 / atol 1e-5 (fp32, remat on and
off); three Trainer steps in both packages (losses at rtol 1e-4 / atol
1e-5, params at 1e-4 / 1e-4); microbatch equivalence at the reference
test's rel 1e-5 (loss) and 1e-3 (grad norm); a checkpoint restart
bit-equal to the uninterrupted run (the reference's test holds 2e-2;
the port's CPU run repeats exactly)."""
import dataclasses
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jcfg
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import common as jc
from repro.models.api import build_model as jbuild
from repro.optim import adafactor as jada
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro.train import fault_tolerance as jft
from repro.train.loop import Trainer as JTrainer
from repro_torch import configs as tcfg
from repro_torch import convert, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tc
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw, global_norm, sgd_momentum
from repro_torch.optim.schedule import constant, warmup_cosine
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step, value_and_grad

ROOT = Path(__file__).resolve().parents[1]


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


def _t(tree_np):
    return convert.lm_params_from_numpy(tree_np, "cpu")


def _close_trees(got, want, **tol):
    flat_w, _ = jax.tree_util.tree_flatten(want)
    flat_g = tree.leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_sources_import_no_jax_ml_dtypes_or_reference():
    """Every source file of the port, and chip_smoke.py, by its text: no
    import of jax, ml_dtypes or the reference package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 60
    bad = []
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            words = line.strip().replace(",", " ").split()
            if not words or words[0] not in ("import", "from"):
                continue
            mod = words[1].split(".")[0]
            if mod in ("jax", "jaxlib", "ml_dtypes", "repro"):
                bad.append(f"{f.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, bad


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_case(seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    params = {"b": rs.randn(7).astype(np.float32),
              "w": rs.randn(4, 6).astype(np.float32),
              "layers": {"e": rs.randn(3, 5, 2).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (rs.randn(*p.shape) * scale)
                          .astype(np.float32), params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,make_j,make_t,scale", [
    ("adamw_clipped", lambda: jadamw.adamw(lr=0.01),
     lambda: adamw(lr=0.01), 3.0),
    ("adamw_schedule_unclipped",
     lambda: jadamw.adamw(lr=jsched.warmup_cosine(0.1, 2, 10),
                          grad_clip=None, weight_decay=0.05),
     lambda: adamw(lr=warmup_cosine(0.1, 2, 10), grad_clip=None,
                   weight_decay=0.05), 1.0),
    ("adafactor", lambda: jada.adafactor(lr=0.05, weight_decay=0.01),
     lambda: adafactor(lr=0.05, weight_decay=0.01), 1.0),
    ("sgd_momentum", lambda: jadamw.sgd_momentum(lr=0.05),
     lambda: sgd_momentum(lr=0.05), 1.0),
])
def test_optimizer_steps_match_reference(name, make_j, make_t, scale):
    """Three updates from the same params and grads: params and every
    state leaf (step included) against the reference (fp32)."""
    params, grads = _opt_case(scale=scale)
    jo, to = make_j(), make_t()
    jp, js = params, jo.init(params)
    tp = _t(params)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(_t(g), ts, tp)
    _close_trees(tp, jp, rtol=1e-5, atol=1e-7)
    _close_trees(ts, js, rtol=1e-5, atol=1e-7)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    if name == "adamw_clipped":
        assert float(global_norm(_t(grads[0]))) > 1.0    # the clip acts


def _quadratic(params):
    return sum(torch.sum(torch.square(p - 3.0)) for p in tree.leaves(params))


@pytest.mark.parametrize("make_opt", [
    lambda: adamw(lr=0.1, weight_decay=0.0),
    lambda: adafactor(lr=0.5),
    lambda: sgd_momentum(lr=0.05),
])
def test_optimizers_converge_quadratic(make_opt):
    """The reference's test_optimizers_converge_quadratic, on the port."""
    opt = make_opt()
    params = {"a": torch.zeros((4, 8)), "b": torch.zeros((3,))}
    state = opt.init(params)
    l0 = float(_quadratic(params))
    for _ in range(300):
        _, g = value_and_grad(lambda p, _: _quadratic(p), params, None)
        params, state = opt.update(g, state, params)
    assert float(_quadratic(params)) < 0.05 * l0


def test_optimizer_state_dtypes():
    """adamw's state_dtype (a name or a dtype); default moments f32 for
    bf16 params; adafactor's factored moments take r + c floats."""
    st = adamw(state_dtype="bfloat16").init(
        {"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert st["m"]["w"].dtype == torch.bfloat16
    st = adamw().init({"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    st = adafactor().init({"w": torch.zeros((128, 256))})
    assert sum(x.numel() for x in tree.leaves(st["s"])) == 128 + 256
    specs = adamw().state_specs({"w": torch.zeros((3, 2))})
    assert specs["m"]["w"].device.type == "meta"


def test_schedules_match_reference():
    f, jf = warmup_cosine(peak=1.0, warmup=10, total=100), \
        jsched.warmup_cosine(peak=1.0, warmup=10, total=100)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        want = float(jf(jnp.int32(s)))
        assert f(s) == pytest.approx(want, rel=1e-6, abs=1e-9)
        assert f(torch.tensor(s, dtype=torch.int32)) == f(s)
    assert f(0) == 0.0 and f(10) == pytest.approx(1.0, rel=1e-2)
    assert f(100) < 0.15
    assert constant(3e-4)(7) == float(jsched.constant(3e-4)(7))


def test_global_norm_matches_reference():
    params, _ = _opt_case(seed=3)
    assert float(global_norm(_t(params))) == pytest.approx(
        float(jadamw.global_norm(params)), rel=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_codec_matches_reference(seed):
    x = np.random.RandomState(seed).randn(64, 32).astype(np.float32)
    q, scale = gc.int8_encode(torch.from_numpy(x))
    jq, jscale = jgc.int8_encode(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    err = np.abs(gc.int8_decode(q, scale).numpy() - x).max()
    assert err <= float(scale) * 0.5 + 1e-7


def test_topk_codec_matches_reference_with_ties():
    """arange(100) - 50 has 49 tied magnitude pairs; the lower index goes
    first, as lax.top_k orders them."""
    x = np.arange(100, dtype=np.float32) - 50
    vals, idx = gc.topk_encode(torch.from_numpy(x), k_frac=0.1)
    jvals, jidx = jgc.topk_encode(jnp.asarray(x), k_frac=0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    back = gc.topk_decode(vals, idx, (100,))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jgc.topk_decode(jvals, jidx, (100,))))
    assert float(back.abs().max()) == 50.0 and int((back != 0).sum()) == 10


def test_error_feedback_accumulates():
    """The reference's test_error_feedback_accumulates, on the port."""
    rs = np.random.RandomState(0)
    g_true = [torch.from_numpy(rs.randn(32, 16).astype(np.float32)) * 0.01
              for _ in range(50)]
    resid = torch.zeros((32, 16))
    acc_ef = torch.zeros((32, 16))
    acc_raw = torch.zeros((32, 16))
    for g in g_true:
        gf = g + resid
        deq = gc.int8_decode(*gc.int8_encode(gf))
        resid = gf - deq
        acc_ef += deq
        acc_raw += gc.int8_decode(*gc.int8_encode(g))
    truth = torch.stack(g_true).sum(0)
    assert (acc_ef - truth).abs().max() < (acc_raw - truth).abs().max() * 2
    assert float(resid.abs().max()) < 0.01


@pytest.mark.parametrize("codec", ["int8", "topk", "none"])
def test_compressed_psum(codec, tmp_path):
    """Single process, no group: the reduction is the identity and the
    residual is what the codec dropped. On a one-rank gloo group the
    all_reduce gives the same."""
    rs = np.random.RandomState(5)
    grads = {"a": torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
             "b": torch.from_numpy(rs.randn(5).astype(np.float32))}
    resid = gc.zero_residual(grads)
    red, new_r = gc.compressed_psum(grads, resid, codec=codec, k_frac=0.25)
    for k, g in grads.items():
        torch.testing.assert_close(red[k] + new_r[k], g, rtol=0, atol=1e-6)
        if codec == "none":
            assert torch.equal(new_r[k], torch.zeros_like(g))
    assert gc.compression_ratio(codec, 0.05) == \
        jgc.compression_ratio(codec, 0.05)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        red2, new_r2 = gc.compressed_psum(grads, resid, codec=codec,
                                          k_frac=0.25)
    finally:
        dist.destroy_process_group()
    for k in grads:
        assert torch.equal(red2[k], red[k])
        assert torch.equal(new_r2[k], new_r[k])


# ---------------------------------------------------------------------------
# data, checkpoints, fault tolerance
# ---------------------------------------------------------------------------

def test_pipeline_batches_equal_reference(tmp_path):
    """Synthetic and token-file batches, whole and per host, array for
    array equal to the reference's."""
    tok_file = tmp_path / "tokens.bin"
    np.random.RandomState(0).randint(0, 100, 5000).astype(np.int32) \
        .tofile(tok_file)
    for kw in ({}, {"token_file": str(tok_file)}):
        cfg = dict(vocab_size=100, seq_len=64, global_batch=8, **kw)
        for host, n in ((0, 1), (0, 2), (1, 2)):
            got = TokenPipeline(DataConfig(**cfg), host, n)
            want = JTokenPipeline(JDataConfig(**cfg), host, n)
            for step in (0, 7):
                g, w = got.batch(step), want.batch(step)
                assert sorted(g) == sorted(w) == ["labels", "tokens"]
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])
                    assert g[k].dtype == w[k].dtype


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    """bf16, f32, int32, bool and 0-d leaves come back bit for bit, with
    their dtypes, in ``like``'s structure; meta.json names the dtypes."""
    rs = np.random.RandomState(0)
    tree_ = {"w": torch.from_numpy(rs.randn(3, 4).astype(np.float32))
             .to(torch.bfloat16),
             "layers": {"a": torch.from_numpy(rs.randn(2, 5)
                                              .astype(np.float32)),
                        "n": torch.arange(6, dtype=torch.int32)},
             "list": [torch.tensor(True), torch.tensor(7.5)],
             "step": torch.tensor(5, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree_, blocking=True)
    like = tree.tree_map(torch.zeros_like, tree_)
    step, back = mgr.restore(like=like)
    assert step == 3
    for g, w in zip(tree.leaves(back), tree.leaves(tree_)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(-1).view(torch.uint8)
                           if g.ndim else g, w.view(-1).view(torch.uint8)
                           if w.ndim else w)
    meta = json.loads((tmp_path / "step_00000003" / "meta.json")
                      .read_text())
    assert "bfloat16" in meta["dtypes"] and "int32" in meta["dtypes"]


def test_checkpoint_gc_async_and_partial(tmp_path):
    """The reference's three checkpoint tests, on the port: GC keeps
    max_to_keep, an async save lands after wait(), a .tmp directory
    from a crash is skipped."""
    mgr = CheckpointManager(tmp_path / "a", max_to_keep=2)
    tree_ = {"w": torch.arange(12.0).reshape(3, 4),
             "s": torch.tensor(5, dtype=torch.int32)}
    for s in (10, 20, 30):
        mgr.save(s, tree_, blocking=True)
    assert mgr.all_steps() == [20, 30]
    step, back = mgr.restore(like=tree_)
    assert step == 30 and torch.equal(back["w"], tree_["w"])
    mgr = CheckpointManager(tmp_path / "b")
    mgr.save(1, {"w": torch.ones((256, 256))}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    (tmp_path / "b" / "step_00000002.tmp").mkdir()
    assert mgr.latest_step() == 1
    assert mgr.restore(step=1, like={"w": torch.zeros(1)})[0] == 1
    assert CheckpointManager(tmp_path / "c").restore(like=tree_) == \
        (None, None)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """An async save writes the values at the call, even if the caller
    changes its tensors before the write ends."""
    w = torch.ones(1000)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": w})
    w.mul_(2)
    mgr.wait()
    assert torch.equal(mgr.restore(like={"w": w})[1]["w"],
                       torch.ones(1000))


def test_checkpoint_files_match_reference_layout(tmp_path):
    """The same tree saved by both packages: the same directory names,
    npz keys and raw bytes per leaf, and the same meta shapes."""
    rs = np.random.RandomState(1)
    t = {"a": rs.randn(3, 2).astype(np.float32),
         "b": np.arange(4, dtype=np.int32)}
    CheckpointManager(tmp_path / "port").save(4, _t(t), blocking=True)
    JCheckpointManager(tmp_path / "ref").save(
        4, jax.tree.map(jnp.asarray, t), blocking=True)
    for d in ("port", "ref"):
        assert [p.name for p in (tmp_path / d).iterdir()] == \
            ["step_00000004"]
    got = np.load(tmp_path / "port" / "step_00000004" / "shard_0.npz")
    want = np.load(tmp_path / "ref" / "step_00000004" / "shard_0.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    mg, mw = (json.loads((tmp_path / d / "step_00000004" / "meta.json")
                         .read_text()) for d in ("port", "ref"))
    assert mg["shapes"] == mw["shapes"] and mg["dtypes"] == mw["dtypes"]


def test_heartbeat_straggler_elastic_retry(tmp_path):
    """The reference's four fault-tolerance tests, on the port's copy,
    and the same verdicts as the reference's module."""
    for mod in (ft, jft):
        d = tmp_path / mod.__name__
        h0 = mod.HeartbeatMonitor(d, 0, timeout=0.2)
        h1 = mod.HeartbeatMonitor(d, 1, timeout=0.2)
        h0.beat(1)
        h1.beat(1)
        assert sorted(h0.alive_hosts()) == [0, 1]
        time.sleep(0.3)
        h0.beat(2)
        assert h0.dead_hosts([0, 1]) == [1]
        det = mod.StragglerDetector(alpha=1.0, threshold=1.5)
        for h in range(4):
            det.record(h, 1.0)
        det.record(3, 5.0)
        assert det.stragglers() == [3]
        plan = mod.ElasticPlan(global_batch=32)
        assert plan.plan(list(range(8)))["local_batch"] == 4
        p5 = plan.plan([0, 1, 2, 3, 7])
        assert p5["local_batch"] == 8 and len(p5["active_hosts"]) == 4
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return 42

        assert mod.retry_step(flaky, max_retries=3)() == 42


# ---------------------------------------------------------------------------
# the flash-attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", (1e-4, 1e-5)),
                                       ("bfloat16", (2e-2, 2e-2))])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_flash_grads_match_reference_vjp(dtype, tol, causal, window):
    """_Flash's forward and (dq, dk, dv) against ``jax.vjp`` of the
    reference's ``_flash`` at S = 50 over 16-wide blocks (the last q and
    kv blocks padded). In bf16 the reference runs op by op."""
    rs = np.random.RandomState(7)
    shapes = [(2, 50, 4, 16)] * 4
    q, k, v, dout = (jnp.asarray(rs.randn(*s), dtype) for s in shapes)
    with jax.disable_jit(dtype == "bfloat16"):
        out, vjp = jax.vjp(lambda a, b, c: jc._flash(
            a, b, c, causal, window, 16, 16), q, k, v)
        want = vjp(dout)
    tq, tk, tv, tdo = (_t(np.asarray(x)).requires_grad_(i < 3)
                       for i, x in enumerate((q, k, v, dout)))
    got_out = tc._Flash.apply(tq, tk, tv, causal, window, 16, 16)
    got = torch.autograd.grad(got_out, (tq, tk, tv), tdo)
    np.testing.assert_allclose(_np(got_out), _np(out), rtol=tol[0],
                               atol=tol[1])
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol[0], atol=tol[1],
                                   err_msg="d" + name)


def test_flash_grad_matches_dense_and_sums_gqa_groups():
    """The reference's test_flash_attention_grad_matches_dense, on the
    port: blockwise attention with 4 heads over 2 KV heads, grads of
    sum(out^2) against plain autograd of dense softmax attention."""
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(2, 50, 4, 16).astype(np.float32))
    k = torch.from_numpy(rs.randn(2, 50, 2, 16).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, 50, 2, 16).astype(np.float32))

    def dense(q, k, v):
        kk, vv = (x.repeat_interleave(2, dim=2) for x in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / 4.0
        mask = torch.ones(50, 50, dtype=torch.bool).tril()
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)

    g1 = torch.autograd.grad((tc.blockwise_attention(
        *(x.requires_grad_() for x in (q, k, v)), causal=True, q_block=16,
        kv_block=16) ** 2).sum(), (q, k, v))
    g2 = torch.autograd.grad((dense(q, k, v) ** 2).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# loss and grads per family, the train step and the loop
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen2_1p5b", "llava_next_mistral_7b", "granite_moe_3b_a800m",
                "mamba2_2p7b", "hymba_1p5b", "whisper_tiny"]
_GRADS = {}


def _family_case(arch):
    """(port cfg, port params, port batch, ref loss, ref grads), the
    reference's grads taken once per arch (fp32, remat off)."""
    if arch not in _GRADS:
        j = dataclasses.replace(jcfg.reduced(jcfg.get_config(arch)),
                                dtype="float32")
        jm = jbuild(j)
        jp = jm.init(jax.random.key(0))
        rs = np.random.RandomState(1)
        tok = rs.randint(0, j.vocab_size, (2, 32)).astype(np.int32)
        batch = {"labels": tok}
        if j.frontend == "vision":
            batch["embeds"] = rs.randn(2, 32, j.d_model).astype(np.float32)
        else:
            batch["tokens"] = tok
        if j.frontend == "audio":
            batch["enc_embeds"] = rs.randn(2, j.encoder_seq, j.d_model) \
                .astype(np.float32)
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
            jp, jax.tree.map(jnp.asarray, batch))
        _GRADS[arch] = (tcfg.base.ArchConfig(**dataclasses.asdict(j)),
                        _t(jax.tree.map(np.asarray, jp)), _t(batch),
                        float(loss), grads)
    return _GRADS[arch]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch, remat, monkeypatch):
    """One reduced arch per family (dense, vlm, moe, ssm, hybrid, audio):
    the port's loss and every gradient leaf against
    ``jax.value_and_grad`` (fp32). With remat on, each layer runs under
    torch.utils.checkpoint (counted)."""
    cfg, params, batch, want_loss, want = _family_case(arch)
    model = tbuild(dataclasses.replace(cfg, remat=remat))
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads = value_and_grad(model.loss, params, batch)
    n_layers = cfg.num_layers + (cfg.encoder_layers
                                 if cfg.is_encoder_decoder else 0)
    assert len(calls) == (n_layers if remat else 0)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5, abs=1e-6)
    _close_trees(grads, want, rtol=1e-4, atol=1e-5)


def test_train_step_and_trainer_match_reference(tmp_path):
    """Three steps of the Trainer (reduced qwen2, fp32, AdamW with its
    default clip) from the same params in both packages: the losses at
    rtol 1e-4 / atol 1e-5, the final params at rtol 1e-4 / atol 1e-4.
    Adam divides each gradient element by its own RMS, so an element
    whose gradient is near zero still moves by up to lr (3e-3) a step,
    and a last-bit difference in that gradient moves the param by a
    share of lr: 3e-4 of it is 1e-6, 1 % of it 3e-5."""
    j = dataclasses.replace(jcfg.reduced(jcfg.get_config("qwen2_1p5b")),
                            dtype="float32")
    jm, tm = jbuild(j), tbuild(tcfg.base.ArchConfig(**dataclasses.asdict(j)))
    data = dict(vocab_size=j.vocab_size, seq_len=32, global_batch=4)
    jtr = JTrainer(jm, jadamw.adamw(lr=3e-3), JDataConfig(**data),
                   tmp_path / "ref", checkpoint_every=0)
    jp0 = jm.init(jax.random.key(0))
    jp, _, jl = jtr.run(3, params=jp0, opt_state=jtr.optimizer.init(jp0),
                        log_every=0)
    tr = Trainer(tm, adamw(lr=3e-3), DataConfig(**data), tmp_path / "port",
                 checkpoint_every=0, device="cpu")
    tp0 = _t(jax.tree.map(np.asarray, jp0))
    tp, _, tl = tr.run(3, params=tp0, opt_state=tr.optimizer.init(tp0),
                       log_every=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    _close_trees(tp, jp, rtol=1e-4, atol=1e-4)


def test_microbatch_equivalence(rng):
    """The reference's test_microbatch_equivalence, on the port: grad
    accumulation over 4 microbatches == one big batch (fp32)."""
    cfg = dataclasses.replace(
        tcfg.reduced(tcfg.get_config("internlm2_1p8b")), dtype="float32")
    model = tbuild(cfg)
    opt = adamw(lr=0.0, weight_decay=0.0)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    st = opt.init(params)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (8, 16))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    _, _, m1 = make_train_step(model, opt, micro_batches=1)(params, st,
                                                            batch)
    _, _, m4 = make_train_step(model, opt, micro_batches=4)(params, st,
                                                            batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m4["grad_norm"]),
                                                   rel=1e-3)


def _setup(run_dir, steps_ckpt=5):
    cfg = tcfg.reduced(tcfg.get_config("qwen2_1p5b"))
    model = tbuild(cfg)
    opt = adamw(lr=3e-3, weight_decay=0.0)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tr = Trainer(model, opt, data, run_dir, checkpoint_every=steps_ckpt,
                 device="cpu")
    return model, opt, data, tr


def test_training_reduces_loss(tmp_path):
    """The reference's test_training_reduces_loss, on the port (bf16)."""
    _, _, _, tr = _setup(tmp_path)
    _, _, losses = tr.run(25, log_every=0)
    assert losses[-5:].mean() < losses[:5].mean()
    assert tr.ckpt.all_steps() == [15, 20, 24]
    assert (tmp_path / "heartbeats" / "host_0.json").exists()


def test_checkpoint_restart_exact(tmp_path):
    """The reference's test_checkpoint_restart_exact, on the port: a
    crash after the step-10 checkpoint and a restart give the
    uninterrupted run's params, here bit for bit (bf16 params, f32
    moments)."""
    _, _, _, tr = _setup(tmp_path / "a", steps_ckpt=10)
    p_full, o_full, _ = tr.run(16, log_every=0)
    model2, opt2, data2, tr2 = _setup(tmp_path / "b", steps_ckpt=10)
    tr2.run(11, log_every=0)
    tr3 = Trainer(model2, opt2, data2, tmp_path / "b", checkpoint_every=10,
                  device="cpu")
    p_res, o_res, losses = tr3.run(16, log_every=0)
    assert len(losses) == 5           # resumed at step 11
    for a, b in zip(tree.leaves({"p": p_full, "o": o_full}),
                    tree.leaves({"p": p_res, "o": o_res})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_trains_on_cpu_and_needs_a_card_otherwise(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """``launch.train --device cpu`` runs the reduced loop; with no CUDA
    device and no ``--device``, the launcher and the Trainer raise."""
    losses = tlaunch.main(["--arch", "mamba2_2p7b", "--steps", "3",
                           "--layers", "1", "--batch", "2", "--seq", "16",
                           "--run-dir", str(tmp_path / "run"),
                           "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "run" / "ckpt" / "step_00000002").is_dir()
    model, opt, data, _ = _setup(tmp_path / "y")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--steps", "1", "--run-dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, opt, data, tmp_path / "z")
