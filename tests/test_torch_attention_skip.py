"""Blockwise attention visits only the (query block, KV block) pairs its
mask leaves a key in (``common._visible_q_blocks``), and the zigzag
layout of the sequence split (``shards.position_spans``,
``specs.sequence_split``) gives every "model" rank as many such pairs.

* The port's ``blockwise_attention`` (causal, windowed, and a span of
  queries at an offset, in blocks of 8 over 64 positions, so that whole
  blocks are skipped) against the JAX package's on the same inputs: the
  output and ``jax.vjp``'s (dq, dk, dv) at ``tests/test_torch_train.py``'s
  f32 bounds (rtol 1e-4 / atol 1e-5; the output at
  ``tests/test_torch_models.py``'s 1e-5 / 1e-6).
* The forward bit-equal to the visit of every block (a skipped block
  leaves ``m``, ``l`` and ``o`` as they are) and to the rows of the whole
  attention; the backward within f32 reassociation of the visit of every
  block.
* ``FlopCounterMode``'s count, forward and backward, exactly the visible
  pairs' share of the visit of every block: 36 of 64 for 8 x 8 causal
  blocks, 21 of 64 with a 16-position window.
* The spans: zigzag for 2 and 16 ranks, the contiguous fallback where
  the positions divide by n but not by 2n, the refusal where they do not
  divide by n, and the rule's layout per family at the pod mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import common as jc
from repro_torch import configs as tcfg
from repro_torch.models import common, shards
from repro_torch.sharding import specs

S, BLK = 64, 8
# (causal, window, first query, queries): the whole sequence, windowed
# (causal or not), and spans of queries at an offset
CASES = [(True, None, 0, 64), (True, 20, 0, 64), (False, 12, 0, 64),
         (True, None, 24, 24), (True, 20, 40, 24)]


def _inputs(seed=7):
    rs = np.random.RandomState(seed)
    q = rs.randn(2, S, 4, 16).astype(np.float32)      # 4 heads over 2
    k, v = (rs.randn(2, S, 2, 16).astype(np.float32) for _ in range(2))
    return q, k, v, rs.randn(2, S, 4, 16).astype(np.float32)


def _port(q, k, v, dout, causal, window, lo, n):
    """The port's output and (dq, dk, dv) of queries lo..lo+n at their
    offset over every key."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                  for x in (q[:, lo:lo + n], k, v))
    out = common.blockwise_attention(tq, tk, tv, causal=causal,
                                     window=window, q_block=BLK,
                                     kv_block=BLK, q_offset=lo)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(dout[:, lo:lo + n]))
    return out.detach(), grads


def _pairs(causal, window, lo, n):
    got = common._visible_q_blocks(causal, window, lo, BLK, BLK, n, S)
    return sum(z - a for a, z in got), -(-n // BLK) * len(got)


def _every_block(monkeypatch):
    """Make the attention visit every (q block, KV block) pair."""
    monkeypatch.setattr(
        common, "_visible_q_blocks",
        lambda c, w, off, qb, kb, sq, skv: [(0, -(-sq // qb))]
        * -(-skv // kb))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_skipping_attention_matches_reference(case):
    """Whole blocks are skipped, and the output and its gradients equal
    the JAX package's ``blockwise_attention`` (its ``_flash`` VJP) on the
    whole sequence, at the span's rows (the reference's cotangent zero
    on the other rows, so its dk and dv are the span's)."""
    causal, window, lo, n = case
    visited, there = _pairs(causal, window, lo, n)
    assert visited < there
    q, k, v, dout = _inputs()
    cot = np.zeros_like(dout)
    cot[:, lo:lo + n] = dout[:, lo:lo + n]
    want, vjp = jax.vjp(lambda a, b, c: jc.blockwise_attention(
        a, b, c, causal=causal, window=window, q_block=BLK, kv_block=BLK),
        *(jnp.asarray(x) for x in (q, k, v)))
    dq, dk, dv = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    out, got = _port(q, k, v, dout, causal, window, lo, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(want)[:, lo:lo + n],
                               rtol=1e-5, atol=1e-6)
    for g, w, name in zip(got, (dq[:, lo:lo + n], dk, dv), "qkv"):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg="d" + name)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_skipping_forward_is_the_visit_of_every_block(case, monkeypatch):
    """The forward with blocks skipped equals, bit for bit, the visit of
    every block and the whole attention's rows; its gradients equal the
    visit of every block's within f32 reassociation."""
    causal, window, lo, n = case
    q, k, v, dout = _inputs()
    out, grads = _port(q, k, v, dout, causal, window, lo, n)
    whole, _ = _port(q, k, v, dout, causal, window, 0, S)
    assert torch.equal(out, whole[:, lo:lo + n])
    _every_block(monkeypatch)
    out_all, grads_all = _port(q, k, v, dout, causal, window, lo, n)
    assert torch.equal(out, out_all)
    for g, w in zip(grads, grads_all):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _flops(causal, window):
    q, k, v, dout = _inputs()
    with FlopCounterMode(display=False) as fc:
        _port(q, k, v, dout, causal, window, 0, S)
    return fc.get_total_flops()


@pytest.mark.parametrize("causal,window,visible", [(True, None, 36),
                                                   (True, 16, 21)])
def test_flops_are_the_visible_pairs(causal, window, visible, monkeypatch):
    """8 x 8 blocks: causal attention visits the 36 pairs on and below
    the diagonal, with a 16-position window the 21 within two blocks of
    it; ``FlopCounterMode``'s count of the forward and backward is
    exactly that share of the 64 pairs' count."""
    assert _pairs(causal, window, 0, S)[0] == visible
    skipped = _flops(causal, window)
    _every_block(monkeypatch)
    every = _flops(causal, window)
    assert skipped * 64 == every * visible


@pytest.mark.parametrize("n", [2, 16])
def test_zigzag_spans_cover_the_positions_and_balance_causal_pairs(n):
    """Rank r holds chunks r and 2n-1-r of 2n; the ranks' spans cover
    every position once; with 512-position blocks every rank's queries
    see as many causal (q block, KV block) pairs: at 16 ranks over
    32,768 positions 130 of the 2,080 visible pairs each, where a
    contiguous span gives rank 0 10 and the last rank 250."""
    length = 2048 * n
    chunk = length // (2 * n)
    spans = [shards.position_spans(length, n, r, zigzag=True)
             for r in range(n)]
    for r, sp in enumerate(spans):
        assert sp == [(r * chunk, chunk), ((2 * n - 1 - r) * chunk, chunk)]
    covered = sorted(p for sp in spans for lo, c in sp
                     for p in range(lo, lo + c))
    assert covered == list(range(length))

    def pairs(sp):
        return sum(z - a for lo, c in sp
                   for a, z in common._visible_q_blocks(
                       True, None, lo, 512, 512, c, length))

    nb = length // 512
    zig = [pairs(sp) for sp in spans]
    assert zig == [nb * (nb + 1) // 2 // n] * n
    contiguous = [pairs(shards.position_spans(length, n, r))
                  for r in range(n)]
    assert sum(contiguous) == sum(zig) and contiguous[0] < contiguous[-1]
    if n == 16:
        assert zig[0] == 130 and (contiguous[0], contiguous[-1]) == (10, 250)


def test_layout_falls_back_to_contiguous_and_refuses_what_does_not_divide():
    """Positions that divide by n but not by 2n keep one contiguous span
    (the rule does not raise for the layout); ``position_spans`` refuses
    a zigzag of them, and ``split_positions`` positions that do not
    divide by n, under either layout."""
    cfg = tcfg.get_config("qwen2_1p5b")
    assert specs.sequence_split(cfg, 4, 64).layout == "zigzag"
    assert specs.sequence_split(cfg, 4, 36).layout == "contiguous"
    with pytest.raises(ValueError, match="do not divide"):
        shards.position_spans(36, 4, 0, zigzag=True)

    class Rank:
        def get_local_rank(self, dim):
            return 1

    tok = torch.arange(60).reshape(2, 30)
    for zigzag in (False, True):
        with pytest.raises(ValueError, match="do not divide"):
            shards.split_positions({"tokens": tok}, Rank(), (),
                                   specs.ModelSplit(4, sequence=True,
                                                    zigzag=zigzag))
    b, dims = shards.split_positions(
        {"tokens": tok[:, :16]}, Rank(), ("data",),
        specs.ModelSplit(2, sequence=True, zigzag=True))
    assert dims == ("data", "model")
    assert torch.equal(b["tokens"], torch.cat([tok[:, 4:8], tok[:, 8:12]], 1))


@pytest.mark.parametrize("arch,layout", [
    ("qwen2_1p5b", "zigzag"), ("granite_moe_3b_a800m", "zigzag"),
    ("whisper_tiny", "zigzag"), ("mamba2_2p7b", "contiguous"),
    ("hymba_1p5b", "contiguous")])
def test_rule_layout_at_the_pod(arch, layout):
    """``prefill_32k`` at the pod mesh (16 x 16): every family takes
    "sequence"; the families whose positions mix only through attention
    take the zigzag, mamba2 and hymba (carried state) one span."""
    mesh = specs.MeshShape(("data", "model"), (16, 16))
    cfg, sh = tcfg.get_config(arch), tcfg.SHAPES["prefill_32k"]
    split = specs.model_split(cfg, sh.batch // 16, mesh, 1, sh.seq)
    assert split.name == "sequence" and split.layout == layout
