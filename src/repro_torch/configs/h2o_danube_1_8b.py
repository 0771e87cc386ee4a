"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention
[arXiv:2401.16818]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="arXiv:2401.16818",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,  # GQA
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,  # arch-native SWA -> long_500k is legal natively
    )
)
