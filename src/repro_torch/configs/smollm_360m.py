"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        source="hf:HuggingFaceTB/SmolLM-135M",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,  # GQA
        d_ff=2560,
        vocab_size=49152,
    )
)
