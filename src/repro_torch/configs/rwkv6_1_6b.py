"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892",
        num_layers=24,
        d_model=2048,
        num_heads=0,  # attention-free
        num_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        rwkv_head_dim=64,
    )
)
