"""Config dataclasses + registry for the Chicle-JAX framework.

Every assigned architecture registers a ``ModelConfig`` here (see the per-arch
files in this package).  Configs are plain frozen dataclasses so they hash and
can key jit caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned, fixed by the brief)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# The longest sequence a step attends over in full.  A shape past it
# (long_500k) needs sub-quadratic attention: the arch's sliding window as a
# ring cache, the long_context_window for full-attention archs, or no KV
# cache at all (`launch/steps.py`'s `decode_geometry`).
MAX_FULL_ATTENTION_SEQ = 32768


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    source: str  # citation from the public pool

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention extras
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full attention (arch-native)
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    moe_every: int = 1  # MoE FFN on every k-th layer (jamba: 2)
    moe_dense_residual: bool = False  # arctic: dense FFN residual alongside MoE
    dense_residual_ff: int = 0  # width of arctic's dense residual FFN
    moe_capacity_factor: float = 1.25  # dispatch buffer slack (perf knob)

    # hybrid (jamba): 1 attention layer per `attn_every` layers, rest Mamba
    attn_every: int = 0
    # ssm dims (mamba + rwkv)
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper): encoder layers + stub frame-embedding length
    encoder_layers: int = 0
    encoder_seq: int = 0

    # vlm: cross-attn every k-th layer, stub patch-embedding count
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"
    # decode-time sliding window applied ONLY past MAX_FULL_ATTENTION_SEQ
    # (long_500k) on full-attention archs ("swa-variant" in the roofline table); 0 disables the variant.
    long_context_window: int = 4096

    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_()
        nq, nkv = self.num_heads, self.kv_heads()
        n = v * d  # embedding (tied head)
        per_attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            per_attn += (nq + 2 * nkv) * hd
        per_mlp = 3 * d * f  # swiglu
        per_moe = self.num_experts * 3 * d * f + d * self.num_experts
        if self.moe_dense_residual:
            per_moe += 3 * d * (self.dense_residual_ff or f)
        d_inner = self.ssm_expand * d
        per_mamba = (
            d * 2 * d_inner  # in proj (x, z)
            + d_inner * self.ssm_conv_width  # conv
            + d_inner * (2 * self.ssm_state_dim + 1)  # B, C, dt proj (low-rank-ish)
            + d_inner * self.ssm_state_dim  # A
            + d_inner * d  # out proj
        )
        per_rwkv = 4 * d * d + d * d + 3 * d * f // 2  # r,k,v,g,o + ffn(k,v)

        L = self.num_layers
        if self.family == "ssm":
            n += L * (per_rwkv + 2 * d)
        elif self.family == "hybrid":
            n_attn = L // max(self.attn_every, 1)
            n_mamba = L - n_attn
            n_moe = L // max(self.moe_every, 1) if self.num_experts else 0
            n_mlp = L - n_moe
            n += n_attn * per_attn + n_mamba * per_mamba
            n += n_moe * per_moe + n_mlp * per_mlp + L * 2 * d
        elif self.family == "moe":
            n += L * (per_attn + per_moe + 2 * d)
        elif self.family == "vlm":
            n_cross = L // max(self.cross_attn_every, 1)
            n += L * (per_attn + per_mlp + 2 * d) + n_cross * per_attn
        elif self.family == "audio":
            n += (self.encoder_layers + L) * (per_attn + per_mlp + 2 * d)
            n += L * per_attn  # decoder cross-attn
        else:  # dense
            n += L * (per_attn + per_mlp + 2 * d)
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * f
        n_moe_layers = self.num_layers // max(self.moe_every, 1)
        return self.n_params() - n_moe_layers * inactive


@dataclass(frozen=True)
class TrainConfig:
    """Chicle-level training config (uni-task engine knobs)."""

    # paper hyper-params (lSGD defaults: L=8, H=16, momentum 0.9)
    local_batch: int = 8  # L: samples per local update
    local_steps: int = 1  # H: local updates per iteration (1 = mSGD)
    learning_rate: float = 1e-4
    momentum: float = 0.9
    scale_lr_sqrt_k: bool = True  # alpha' = alpha * sqrt(K)
    optimizer: str = "sgdm"  # sgdm | adamw
    weight_decay: float = 0.0
    remat: bool = True
    accum_steps: int = 1  # gradient-accumulation microbatches per step
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    hd = 32
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.kv_heads(), 2))
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=2 * d,
        vocab_size=min(cfg.vocab_size, 512) or 512,
        num_experts=min(cfg.num_experts, 4),
        dense_residual_ff=min(cfg.dense_residual_ff, 2 * d),
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        num_image_tokens=16 if cfg.num_image_tokens else 0,
        attn_every=min(cfg.attn_every, 2),
        cross_attn_every=min(cfg.cross_attn_every, 2),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe_every=min(cfg.moe_every, 2),
        dtype="float32",
    )
    return dataclasses.replace(cfg, **updates)


_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import (  # noqa: F401
        smollm_360m,
        h2o_danube_1_8b,
        grok_1_314b,
        jamba_1_5_large_398b,
        whisper_small,
        rwkv6_1_6b,
        llama_3_2_vision_90b,
        arctic_480b,
        qwen3_4b,
        qwen1_5_4b,
        chicle_paper,
    )
