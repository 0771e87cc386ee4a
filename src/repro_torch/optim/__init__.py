from .optimizers import (
    OptState,
    adamw,
    apply_updates,
    init_opt_state,
    opt_specs,
    opt_state_sds,
    sgdm,
    tree_leaves,
    tree_map,
)
from .schedule import constant_lr, cosine_lr, elastic_sqrt_k, warmup_cosine

__all__ = [
    "OptState",
    "adamw",
    "apply_updates",
    "init_opt_state",
    "opt_specs",
    "opt_state_sds",
    "sgdm",
    "tree_leaves",
    "tree_map",
    "constant_lr",
    "cosine_lr",
    "elastic_sqrt_k",
    "warmup_cosine",
]
