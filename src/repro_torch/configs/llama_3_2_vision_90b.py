"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector is a STUB per the brief: ``input_specs``
provides precomputed patch embeddings (B, 1600, d_model).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,  # GQA
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,  # cross-attention image layer every 5th
        num_image_tokens=1600,
    )
)
