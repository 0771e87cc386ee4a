"""The port's models (`repro_torch.models`): every family of the JAX
package (dense, moe, hybrid, vlm, audio, ssm), with its model API
re-exported from `model`.  The
sharding-only names of the JAX package's `models` (param_specs,
param_sds, cache_specs, cache_sds, count_params) have no counterpart on
one device yet."""
from . import model
from .model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_defs,
    prefill,
)

__all__ = [
    "model",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_defs",
    "prefill",
]
