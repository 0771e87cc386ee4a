"""Shared layers + declarative parameter system (PyTorch).

Parameters are declared as ``ParamDef(shape, logical_axes)`` trees, the same
declarations as the JAX package, so a parameter tree made by either package
has the same keys and the same stacked ``(n_blocks, ...)`` layout.  The same
declaration yields random tensors, spec trees and meta-tensor trees (the
dry run's shape stand-ins).  Random
initialisation draws from an explicit ``torch.Generator``; the numbers differ
from ``jax.random``'s, so parity tests carry one tree across through numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(cfg) -> torch.dtype:
    """The working dtype a ModelConfig names."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axes, same length as shape
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 1.0

    def stacked(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, (None,) + self.axes, self.init,
                        self.scale)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # all dims except the last are treated as fan-in (the stacked layer dim
    # included, exactly as the JAX package counts it)
    return max(1, int(np.prod(shape[:-1])))


def map_defs(fn, defs: Any) -> Any:
    """Apply `fn` to every ParamDef leaf of a nested dict, keeping the keys."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def spec_tree(defs: Any, rules) -> Any:
    """ParamDef tree -> spec tree (`sharding.AxisRules`; fsdp backs off on
    non-divisible dims)."""
    return map_defs(lambda d: rules.fsdp_spec(*d.axes, dim_sizes=d.shape),
                    defs)


def sds_tree(defs: Any, dtype: torch.dtype) -> Any:
    """ParamDef tree -> meta-tensor tree (the dry run's ShapeDtypeStructs:
    shapes and dtypes, no storage)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


DRAW_SLICE = 1 << 30  # elements: larger leaves are drawn slice by slice


def _draw(out: torch.Tensor, std: float, generator: torch.Generator
          ) -> None:
    """Fill `out` with N(0, std^2) drawn in float32, in slices along the
    leading dims while a slice holds more than DRAW_SLICE elements, so one
    leaf's float32 transients stay bounded (a stacked expert leaf of
    grok-1-314b is 6.4e9 elements a layer pair)."""
    if out.numel() > DRAW_SLICE and out.dim() > 1:
        for part in out:
            _draw(part, std, generator)
        return
    x = torch.randn(out.shape, generator=generator, dtype=torch.float32,
                    device=out.device)
    out.copy_(x * std)


def init_tree(defs: Any, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> Any:
    """Instantiate a ParamDef tree into tensors (leaves in sorted-key order,
    each drawn in float32 and cast, as the JAX package does; a leaf of
    more than DRAW_SLICE elements is drawn in slices, see `_draw`)."""
    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        std = d.scale / math.sqrt(_fan_in(d.shape))
        if d.init == "small":
            std = d.scale * 0.02
        out = torch.empty(d.shape, dtype=dtype, device=device)
        _draw(out, std, generator)
        return out

    def walk(node):
        if isinstance(node, ParamDef):
            return make(node)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(defs)


# ---------------------------------------------------------------------------
# Core math layers (functional)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """fp32 statistics, cast back to the input dtype, THEN scale by w."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding.  x: (B, S, ..., hd); positions: (B, S).
    Frequencies and angles are fp32; the result is cast to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    for _ in range(x.ndim - 3):  # broadcast over the head axes
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhe->bshe') as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def head_out(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bshe,hed->bsd') as one matmul."""
    h, e, d = w.shape
    return ctx.reshape(*ctx.shape[:-2], h * e) @ w.reshape(h * e, d)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "gate": ParamDef((d_model, d_ff), ("fsdp", "tensor")),
        "up": ParamDef((d_model, d_ff), ("fsdp", "tensor")),
        "down": ParamDef((d_ff, d_model), ("tensor", "fsdp")),
    }


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE in fp32: logsumexp minus the picked logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - picked
