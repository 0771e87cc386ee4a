"""Dense transformer blocks: full-sequence apply (prefill) and the paged-KV
step over new tokens (decode, Q=1, and one chunked-prefill chunk, Q>1).

A block is self-attention + SwiGLU with pre-norms, the JAX package's
'dense' block.  Other families are later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import ParamDef, mlp_defs, rms_norm, swiglu


def n_blocks(cfg: ModelConfig) -> int:
    return cfg.num_layers


def _ln(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


def block_defs(cfg: ModelConfig) -> Dict[str, object]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port has the dense block only; got {cfg.family!r} "
            f"(ROADMAP queue A: remaining model families)")
    d = cfg.d_model
    return {"ln1": _ln(d), "attn": attn.attn_defs(cfg),
            "ln2": _ln(d), "mlp": mlp_defs(d, cfg.d_ff)}


def _mlp(bp, x: torch.Tensor) -> torch.Tensor:
    m = bp["mlp"]
    return swiglu(rms_norm(x, bp["ln2"]), m["gate"], m["up"], m["down"])


def block_apply(cfg: ModelConfig, bp, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                q_block: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal dense block.  Returns (x, k, v); k/v
    (B, S, KV, hd) are the block's new cache rows."""
    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               positions)
    ctx = attn.blocked_attention(cfg, q, k, v, window=window,
                                 q_block=q_block)
    x = x + attn.attn_out(bp["attn"], ctx)
    return x + _mlp(bp, x), k, v


def block_decode_paged(cfg: ModelConfig, bp, x: torch.Tensor,
                       q_pos: torch.Tensor, table: torch.Tensor,
                       lengths: torch.Tensor, cache: Dict[str, torch.Tensor],
                       *, window: int = 0, impl: str = "gather",
                       cow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Paged-KV block step over new tokens x: (B, Q, D) at positions
    q_pos: (B, Q).  Q == 1 is decode; Q > 1 is one chunked-prefill chunk.

    cache: {"k": (N, ps, KV, hd), "v": ...} physical page pools of this
    layer, shared by every sequence, UPDATED IN PLACE (the JAX package
    returns new pools; here the copy-on-write copy and the new rows are
    written into the given tensors).  table: (B, P) int32 block table (-1
    absent); lengths: (B,) live tokens INCLUDING the new ones (0 = inactive
    row: its writes route to the null page and its output is garbage).

    cow: optional (src, dst) pair of (B,) page ids: the shared page's
    payload is copied src -> dst before the new rows land (rows without a
    break pass the null page for both).

    impl: "gather" gathers K/V through the table and runs plain attention
    (the JAX package's "xla"); "kernel" runs the paged-attention kernel
    (the JAX package's "pallas").  Returns the block's output x."""
    if cfg.family != "dense":
        raise NotImplementedError(f"paged decode supports dense; got "
                                  f"{cfg.family!r}")
    B, Q, _ = x.shape
    ck, cv = cache["k"], cache["v"]
    ps = ck.shape[1]
    P = table.shape[1]

    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               q_pos)
    if cow is not None:
        cow_src, cow_dst = (c.long() for c in cow)
        ck[cow_dst] = ck[cow_src]
        cv[cow_dst] = cv[cow_src]

    # scatter the Q new K/V rows into their pages; tokens past a row's live
    # length (padding / inactive rows) route to the reserved null page 0
    valid = q_pos < lengths[:, None]
    pidx = torch.gather(table, 1, torch.clamp(q_pos // ps, max=P - 1).long())
    pg = torch.where(valid, pidx.clamp_min(0), 0).reshape(-1).long()
    off = (q_pos % ps).reshape(-1).long()
    ck[pg, off] = k.reshape((B * Q,) + k.shape[2:])
    cv[pg, off] = v.reshape((B * Q,) + v.shape[2:])

    if impl == "kernel":
        kind, HP, g_pad = attn.head_layout(cfg)
        if kind != "grouped":
            raise NotImplementedError(
                "the paged-attention kernel needs the grouped head layout "
                "(ROADMAP queue A: flat layout)")
        from ..kernels.paged_attention import paged_attention
        KVh, hd = cfg.kv_heads(), cfg.head_dim_()
        # (B, Q, KV*g_pad, hd) -> (B, KV, Q*g_pad, hd): the kernel rides the
        # Q span along the row dim, position-major (row j*g_pad+g)
        qg = (q.reshape(B, Q, KVh, g_pad, hd).transpose(1, 2)
              .reshape(B, KVh, Q * g_pad, hd).contiguous())
        ctx = paged_attention(qg, ck, cv, table, lengths, window=window,
                              q_span=Q, q_start=q_pos[:, 0].contiguous())
        _, hmask = attn.head_maps(cfg, x.device)
        ctx = (ctx.reshape(B, KVh, Q, g_pad, hd).transpose(1, 2)
               .reshape(B, Q, HP, hd))
        ctx = ctx * hmask[None, None, :, None].to(ctx.dtype)
    elif impl == "gather":
        kseq = attn.gather_pages(ck, table)
        vseq = attn.gather_pages(cv, table)
        k_pos = attn.paged_k_pos(lengths, P * ps)
        ctx = attn.decode_attention(cfg, q, kseq, vseq, q_pos, k_pos,
                                    window=window)
    else:
        raise ValueError(f"paged impl must be 'kernel' or 'gather', "
                         f"got {impl!r}")
    x = x + attn.attn_out(bp["attn"], ctx)
    return x + _mlp(bp, x)
