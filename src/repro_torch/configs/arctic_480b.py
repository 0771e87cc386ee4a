"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,  # GQA
        d_ff=4864,
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        moe_dense_residual=True,  # arctic dense-MoE hybrid residual
        dense_residual_ff=4864,
    )
)
