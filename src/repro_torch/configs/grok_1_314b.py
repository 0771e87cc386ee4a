"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        source="hf:xai-org/grok-1",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,  # GQA
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
    )
)
