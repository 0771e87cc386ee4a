"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,  # MHA with QKV bias
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
    )
)
