"""whisper-small [audio] — encoder-decoder, conv frontend STUB [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub per the brief:
``input_specs`` provides precomputed frame embeddings (B, 1500, d_model).
"""
from .base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-small",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=12,  # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,  # MHA (kv == q)
        d_ff=3072,
        vocab_size=51865,
        encoder_layers=12,
        encoder_seq=1500,  # whisper 30s audio -> 1500 frames
    )
)
