"""qwen3-4b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-4b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,  # GQA
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
    )
)
