"""Architecture config schema, shape registry and input_specs().

Every assigned architecture is a frozen ArchConfig in its own module
(src/repro_torch/configs/<id>.py) registered here. input_specs() and
cache_specs() return meta-device tensors, stand-ins for every model input
of a given (arch, shape) cell: the reference's tree, shapes and dtypes,
with no allocation. Dtype names map to torch dtypes in one place,
:func:`torch_dtype`.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

VOCAB_ALIGN = 2048  # pad vocab so (model=16) x (lane=128) sharding divides
EXPERT_ALIGN = 16   # pad expert count so the model axis divides it


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    d_inner: int = 0               # 0 -> 2*d_model (mamba expansion)
    ssm_head_dim: int = 64
    attn_free: bool = False
    sliding_window: int = 0        # 0 = full attention
    # attention details
    qkv_bias: bool = False
    rotary_pct: float = 1.0        # chatglm3 2D RoPE = 0.5
    rope_base: float = 10000.0
    parallel_block: bool = False   # command-r style parallel attn+FFN
    mlp: str = "gated_silu"        # gated_silu | gelu
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    # modality frontend stub
    frontend: str = "none"         # none | vision | audio
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    optimizer: str = "adamw"       # adamw | adafactor
    remat: bool = True
    moe_dispatch: str = "dense"    # dense | biglittle (the paper's technique)
    capacity_factor: float = 1.25  # MoE dispatch headroom
    micro_batches: int = 1         # grad-accumulation microbatches (train)
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator
    kv_cache_dtype: str = ""       # "" -> activation dtype; f8 halves KV
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN

    @property
    def num_experts_padded(self) -> int:
        if not self.num_experts:
            return 0
        return -(-self.num_experts // EXPERT_ALIGN) * EXPERT_ALIGN

    @property
    def din(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.sliding_window > 0)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "kimi_k2_1t_a32b", "granite_moe_3b_a800m", "qwen2_1p5b", "internlm2_1p8b",
    "chatglm3_6b", "command_r_35b", "hymba_1p5b", "llava_next_mistral_7b",
    "mamba2_2p7b", "whisper_tiny",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def reduced(cfg: ArchConfig, layers: int = 2) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (small widths, few
    experts, tiny vocab)."""
    kw = dict(
        num_layers=layers, d_model=64, d_ff=128, vocab_size=128,
        head_dim=16, remat=False,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 2 if cfg.num_kv_heads < cfg.num_heads else 4
    else:
        kw["num_heads"] = 0
        kw["num_kv_heads"] = 0
    if cfg.family == "moe":
        kw.update(num_experts=8, top_k=2, moe_d_ff=64,
                  capacity_factor=100.0)  # drop-free at toy scale
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, d_inner=64, ssm_head_dim=16)
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=layers, encoder_seq=24)
    return dataclasses.replace(cfg, **kw)


def get_config(arch: str) -> ArchConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def supports(cfg: ArchConfig, shape: ShapeSpec) -> tuple:
    """(ok, reason) — which cells run. long_500k needs sub-quadratic
    attention (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 512k context — skipped "
                       "per assignment; see DESIGN.md §5")
    return True, ""


_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``,
    ``cfg.kv_cache_dtype``, ``cfg.grad_accum_dtype``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every input of the step function."""
    B, S = shape.batch, shape.seq
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    tok = _spec((B, S), i32)

    def embeds(seq):
        return _spec((B, seq, cfg.d_model), dt)

    if shape.kind == "train":
        batch = {"labels": _spec((B, S), i32)}
        if cfg.frontend == "vision":
            batch["embeds"] = embeds(S)      # anyres patch embeddings (stub)
        elif cfg.frontend == "audio":
            batch["enc_embeds"] = _spec((B, cfg.encoder_seq, cfg.d_model), dt)
            batch["tokens"] = tok
        else:
            batch["tokens"] = tok
        return {"batch": batch}

    if shape.kind == "prefill":
        if cfg.frontend == "vision":
            return {"batch": {"embeds": embeds(S)}}
        if cfg.frontend == "audio":
            return {"batch": {
                "enc_embeds": _spec((B, cfg.encoder_seq, cfg.d_model), dt),
                "tokens": tok}}
        return {"batch": {"tokens": tok}}

    # decode: one new token against a cache of length S
    return {
        "cache": cache_specs(cfg, B, S),
        "token": _spec((B, 1), i32),
        "length": _spec((), i32),
    }


def cache_specs(cfg: ArchConfig, B: int, S: int):
    """Decode-state meta tensors per family."""
    dt = torch_dtype(cfg.kv_cache_dtype or cfg.dtype)
    f32 = torch.float32
    L = cfg.num_layers
    kv = lambda: _spec((L, B, S, cfg.num_kv_heads, cfg.hd), dt)
    out = {}
    if cfg.family == "ssm":
        H = cfg.din // cfg.ssm_head_dim
        out["ssm_state"] = _spec((L, B, H, cfg.ssm_head_dim, cfg.ssm_state),
                                 f32)
        out["conv_state"] = _spec((L, B, 4, cfg.din + 2 * cfg.ssm_state), dt)
    elif cfg.family == "hybrid":
        W = min(cfg.sliding_window or S, S)
        out["k"] = _spec((L, B, W, cfg.num_kv_heads, cfg.hd), dt)
        out["v"] = _spec((L, B, W, cfg.num_kv_heads, cfg.hd), dt)
        H = cfg.din // cfg.ssm_head_dim
        out["ssm_state"] = _spec((L, B, H, cfg.ssm_head_dim, cfg.ssm_state),
                                 f32)
    elif cfg.is_encoder_decoder:
        out["k"] = kv()
        out["v"] = kv()
        out["cross_k"] = _spec((L, B, cfg.encoder_seq, cfg.num_kv_heads,
                                cfg.hd), dt)
        out["cross_v"] = _spec((L, B, cfg.encoder_seq, cfg.num_kv_heads,
                                cfg.hd), dt)
    else:
        out["k"] = kv()
        out["v"] = kv()
    return out
