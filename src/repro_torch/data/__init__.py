"""Training data for the paper's workloads and the LM trainer (numpy, made
from a seed), and the chunk-aware LM batch pipeline."""
from .pipeline import ChunkBatchPipeline
from .synthetic import (make_classification, make_images, make_lm_tokens,
                        make_svm_data)

__all__ = ["ChunkBatchPipeline", "make_classification", "make_images",
           "make_lm_tokens", "make_svm_data"]
