"""Mixture-of-Experts FFN: top-k routing into per-expert capacity buffers
(the JAX package's `moe_ffn` with one token group, which is what it uses
without a mesh).

Every token's top-k assignments get slots in per-expert buffers of a fixed
capacity, in token-major order (a cumsum over the (token, k) assignments);
assignments past an expert's capacity are DROPPED.  Every expert then runs
over its whole (capacity, D) buffer, empty slots included, and the outputs
are scattered back and summed per token.  Drops make a row's output depend
on every other token of the same call: padding rows, inactive slots and the
rest of a chunk all take capacity, as they do in the JAX package.

Returns a Switch-style load-balance aux loss for the trainer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import ParamDef


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool.  `F.one_hot` checks the indices' range on the host
    on the CPU and takes other ops on each device; this is the same ops
    everywhere, the meta device's included."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    if e % 16 == 0:  # big-E archs shard the expert dim over the model axis
        axes3, axes3b = ("tensor", "fsdp", None), ("tensor", None, "fsdp")
    else:  # (E, D, F): F over the model axis
        axes3, axes3b = (None, "fsdp", "tensor"), (None, "tensor", "fsdp")
    defs = {
        "router": ParamDef((d, e), ("fsdp", None), init="small"),
        "gate": ParamDef((e, d, f), axes3),
        "up": ParamDef((e, d, f), axes3),
        "down": ParamDef((e, f, d), axes3b),
    }
    if cfg.moe_dense_residual:
        fr = cfg.dense_residual_ff or f
        defs["res_gate"] = ParamDef((d, fr), ("fsdp", "tensor"))
        defs["res_up"] = ParamDef((d, fr), ("fsdp", "tensor"))
        defs["res_down"] = ParamDef((fr, d), ("tensor", "fsdp"))
    return defs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a call over n_tokens tokens."""
    return max(int(cfg.moe_capacity_factor * cfg.experts_per_token
                   * n_tokens / cfg.num_experts), 4)


def route(cfg: ModelConfig, p, xt: torch.Tensor, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) -> (buf (E, cap) token per slot, -1 empty; wbuf (E, cap)
    fp32 combine weight per slot; aux scalar)."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    # logits in the input dtype, then fp32 (the JAX package's einsum+astype)
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first on ties; a stable sort does too
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    density = _one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * torch.sum(density * probs.mean(0))

    flat_e = top_e.reshape(-1)  # (T*K,), token-major
    onehot = _one_hot(flat_e, E).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = slot < cap
    tok_idx = torch.arange(T, device=xt.device).repeat_interleave(K)
    e_idx = torch.where(keep, flat_e, E)  # dummy row E for drops
    c_idx = torch.where(keep, slot, 0)
    buf = torch.full((E + 1, cap), -1, dtype=torch.long, device=xt.device)
    buf[e_idx, c_idx] = tok_idx  # kept slots are distinct; row E is dropped
    wbuf = torch.zeros((E + 1, cap), dtype=torch.float32, device=xt.device)
    wbuf.index_put_((e_idx, c_idx),
                    torch.where(keep, top_w.reshape(-1), 0.0),
                    accumulate=True)
    return buf[:E], wbuf[:E], aux


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    T = B * S
    E = cfg.num_experts
    cap = capacity(cfg, T)
    xt = x.reshape(T, D)
    buf, wbuf, aux = route(cfg, p, xt, cap)

    live = (buf >= 0)[..., None]
    gathered = torch.where(live, xt[buf.clamp_min(0)], 0)  # (E, cap, D)
    h = F.silu(torch.bmm(gathered, p["gate"])) * torch.bmm(gathered, p["up"])
    eo = torch.bmm(h, p["down"]) * wbuf[..., None].to(x.dtype)

    flat = eo.reshape(E * cap, D) * live.reshape(-1, 1)
    out = torch.zeros((T, D), dtype=eo.dtype, device=x.device)
    out = out.index_add(0, buf.clamp_min(0).reshape(-1), flat)

    if cfg.moe_dense_residual:
        h = F.silu(xt @ p["res_gate"]) * (xt @ p["res_up"])
        out = out + (h @ p["res_down"]).to(out.dtype)
    return out.reshape(B, S, D).to(x.dtype), aux
