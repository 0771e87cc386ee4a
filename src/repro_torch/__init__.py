"""PyTorch + CUDA port of the Chicle serving stack (`repro_torch`).

A second package beside the JAX reference `repro`: the same configs,
scheduler and paged-KV serving engine on PyTorch, with each Pallas TPU
kernel on the ported path replaced by a CUDA kernel written for Hopper
(`csrc/`).  It imports nothing of `repro` and never imports jax.
"""
