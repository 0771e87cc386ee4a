"""The port's models (`repro_torch.models`): every family of the JAX
package (dense, moe, hybrid, vlm, audio, ssm), with its model API
re-exported from `model`; the sharding names (parameter and cache specs
and meta-tensor stand-ins, the parameter count) serve the planner
(`launch/dryrun.py`)."""
from . import model
from .model import (
    cache_sds,
    cache_specs,
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_defs,
    param_sds,
    param_specs,
    prefill,
)

__all__ = [
    "model",
    "cache_sds",
    "cache_specs",
    "count_params",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "param_defs",
    "param_sds",
    "param_specs",
    "prefill",
]
