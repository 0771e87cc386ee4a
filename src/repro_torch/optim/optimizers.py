"""Optimizers over parameter trees (nested dicts of tensors; a flat dict
keyed by pytree path is one too).

Default is SGD+momentum, the paper's optimizer for lSGD/mSGD; AdamW for
the small archs.  Moments are fp32 whatever the parameter dtype, `step`
is an int32 tensor, and updates are ADDED to the parameters in fp32 and
cast back (`apply_updates`), as in the JAX package's `optim/optimizers.py`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # momentum / first moment (fp32)
    nu: Optional[Any]  # second moment (adamw only)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested dicts; `rest` are trees of the same
    keys (a None in their place passes None for every leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(None if r is None else r[k]
                                     for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(params, *, optimizer: str = "sgdm") -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = tree_map(zeros, params)
    nu = tree_map(zeros, params) if optimizer == "adamw" else None
    device = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device), mu,
                    nu)


def opt_state_sds(param_sds, *, optimizer: str = "sgdm") -> OptState:
    """`init_opt_state` as meta tensors (the dry run's stand-ins)."""
    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    mu = tree_map(zeros, param_sds)
    nu = tree_map(zeros, param_sds) if optimizer == "adamw" else None
    return OptState(torch.empty((), dtype=torch.int32, device="meta"), mu,
                    nu)


def opt_specs(param_specs, *, optimizer: str = "sgdm") -> OptState:
    """The optimizer state's specs: the moments inherit the parameters'
    (ZeRO-style under FSDP rules), the step is replicated."""
    nu = param_specs if optimizer == "adamw" else None
    return OptState((), param_specs, nu)


def sgdm(grads, state: OptState, *, lr, momentum: float = 0.9,
         weight_decay: float = 0.0, params=None) -> Tuple[Any, OptState]:
    """Returns (updates, new_state); updates are ADDED to params."""
    def upd(m, g, p):
        g32 = g.float()
        if weight_decay and p is not None:
            g32 = g32 + weight_decay * p.float()
        return momentum * m + g32

    mu = tree_map(upd, state.mu, grads, params)
    updates = tree_map(lambda m: -lr * m, mu)
    return updates, OptState(state.step + 1, mu, None)


def adamw(grads, state: OptState, *, lr, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0, params=None
          ) -> Tuple[Any, OptState]:
    """Bias correction at t = step + 1, in fp32."""
    step = state.step + 1
    t = step.float()
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                  grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(),
                  state.nu, grads)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(m, n, p):
        u = -lr * (m / c1) / ((n / c2).sqrt() + eps)
        if weight_decay and p is not None:
            u = u - lr * weight_decay * p.float()
        return u

    return tree_map(upd, mu, nu, params), OptState(step, mu, nu)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)
