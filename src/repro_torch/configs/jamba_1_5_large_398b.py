"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        source="arXiv:2403.19887",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,  # GQA on the attention layers
        d_ff=24576,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_every=2,  # MoE FFN on every other layer (jamba e/a pattern)
        attn_every=8,  # 1 attention layer per 8 (1:7 with Mamba)
        ssm_state_dim=16,
        ssm_conv_width=4,
        ssm_expand=2,
    )
)
