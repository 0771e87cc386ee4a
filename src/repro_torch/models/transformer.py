"""Transformer blocks: full-sequence apply (prefill), the flat-cache
decode step (Q=1) and speculative verify span (Q>1) over a per-slot
(B, cache_len) KV cache, and the paged-KV step over new tokens (decode,
Q=1; verify span or one chunked-prefill chunk, Q>1).

A block is self-attention with pre-norms followed by the family's FFN, the
JAX package's two attention-only blocks: 'dense' (SwiGLU) and 'moe' (the
capacity-buffered expert FFN of `models.moe`, with arctic's dense residual
where the config has one).  The hybrid, vlm, audio and ssm families are
later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from .layers import ParamDef, mlp_defs, rms_norm, swiglu


def n_blocks(cfg: ModelConfig) -> int:
    return cfg.num_layers


def _ln(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


FAMILIES = ("dense", "moe")  # the block types the port has


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port has the {'/'.join(FAMILIES)} blocks; got "
            f"{cfg.family!r} (ROADMAP queue A: remaining model families)")


def block_defs(cfg: ModelConfig) -> Dict[str, object]:
    _check_family(cfg)
    d = cfg.d_model
    ffn = ({"moe": moe_mod.moe_defs(cfg)} if cfg.family == "moe"
           else {"mlp": mlp_defs(d, cfg.d_ff)})
    return {"ln1": _ln(d), "attn": attn.attn_defs(cfg), "ln2": _ln(d), **ffn}


def _ffn(cfg: ModelConfig, bp, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's pre-normed FFN -> (out, aux); aux is None for dense."""
    h = rms_norm(x, bp["ln2"])
    if cfg.family == "moe":
        return moe_mod.moe_ffn(cfg, bp["moe"], h)
    m = bp["mlp"]
    return swiglu(h, m["gate"], m["up"], m["down"]), None


def block_apply(cfg: ModelConfig, bp, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                q_block: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """Full-sequence causal block.  Returns (x, k, v, aux); k/v
    (B, S, KV, hd) are the block's new cache rows, aux the moe FFN's
    load-balance loss (None for dense)."""
    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               positions)
    ctx = attn.blocked_attention(cfg, q, k, v, window=window,
                                 q_block=q_block)
    x = x + attn.attn_out(bp["attn"], ctx)
    f, aux = _ffn(cfg, bp, x)
    return x + f, k, v, aux


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
    _check_family(cfg)
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
                "the paged-attention kernel needs the grouped head layout; "
                "a model with the flat head layout serves through "
                "impl='gather' or the flat KV layout")
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
    return x + _ffn(cfg, bp, x)[0]


# ---------------------------------------------------------------------------
# Flat (B, cache_len) per-slot KV cache: decode and speculative verify
# ---------------------------------------------------------------------------


def _write_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                 ring: bool) -> None:
    """Write one new entry per row, in place.  pos: a 0-d tensor (lockstep
    batch: every row at the same depth) or a (B,) vector (slot pools: each
    row at its own depth).  The ring cache writes at pos % W; otherwise
    the write clamps to the last row, as the JAX package's
    dynamic_update_slice does."""
    W = cache_k.shape[1]
    idx = pos % W if ring else torch.clamp(pos, max=W - 1)
    if pos.dim():
        rows = torch.arange(k.shape[0], device=k.device)
        cache_k[rows, idx.long()] = k[:, 0]
        cache_v[rows, idx.long()] = v[:, 0]
    else:
        cache_k[:, idx.long()] = k[:, 0]
        cache_v[:, idx.long()] = v[:, 0]


def span_scatter(dst: torch.Tensor, new: torch.Tensor, q_pos: torch.Tensor,
                 valid: torch.Tensor) -> None:
    """dst[b, q_pos[b, j]] = new[b, j] in place for every valid j whose
    position lies inside dst's W rows; nothing else changes (the JAX
    package's out-of-bounds scatter with mode="drop").  q_pos[b] must be
    consecutive (a span starting at q_pos[b, 0]).

    torch has no drop mode, and clamping dropped writes onto a row could
    collide with a real write there.  Each row instead rewrites a window
    of min(Q, W) DISTINCT in-range positions that covers every in-range
    position of its span: the span's value where one is written, the row's
    old value elsewhere.  No host sync."""
    B, Q = q_pos.shape
    W = dst.shape[1]
    L = min(Q, W)
    start = torch.clamp(q_pos[:, 0], 0, W - L)
    win = start[:, None] + torch.arange(L, device=dst.device)  # (B, L)
    j = win - q_pos[:, :1]  # the span index that lands on each position
    jc = j.clamp(0, Q - 1).long()
    ok = (j >= 0) & (j < Q) & torch.gather(valid, 1, jc)
    rows = torch.arange(B, device=dst.device)[:, None]
    src = new[rows, jc]
    old = dst[rows, win.long()]
    ok = ok.reshape(ok.shape + (1,) * (src.dim() - 2))
    dst[rows, win.long()] = torch.where(ok, src, old)


def block_decode(cfg: ModelConfig, bp, x: torch.Tensor, pos: torch.Tensor,
                 k_pos: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                 window: int = 0, ring: bool = False) -> torch.Tensor:
    """Flat-cache decode step of one token per row.  x: (B, 1, D); pos: a
    0-d tensor or (B,) per-row positions; k_pos: (B, W) key positions of
    the cache rows AFTER this step's write (-1 = empty).  cache: {"k", "v":
    (B, W, KV, hd)} of this layer, updated in place.  Returns the block's
    output x."""
    _check_family(cfg)
    B = x.shape[0]
    positions = (pos.reshape(B, 1) if pos.dim() else pos.expand(B, 1)
                 ).to(torch.int32)
    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               positions)
    _write_cache(cache["k"], cache["v"], k, v, pos, ring)
    ctx = attn.decode_attention(cfg, q, cache["k"], cache["v"], positions,
                                k_pos, window=window)
    x = x + attn.attn_out(bp["attn"], ctx)
    return x + _ffn(cfg, bp, x)[0]


def block_verify(cfg: ModelConfig, bp, x: torch.Tensor, q_pos: torch.Tensor,
                 valid: torch.Tensor, k_pos: torch.Tensor,
                 cache: Dict[str, torch.Tensor], *, window: int = 0
                 ) -> torch.Tensor:
    """Flat-cache step over a SPAN of new tokens x: (B, Q, D) at per-row
    positions q_pos: (B, Q), the speculative-verify twin of `block_decode`.

    valid: (B, Q) marks real tokens; invalid positions (draft padding,
    inactive rows) and positions past the cache write NOTHING
    (`span_scatter`), and their outputs are garbage the caller discards.
    Each valid query attends the row's earlier context plus the span's
    earlier tokens (causal by absolute position through k_pos, which the
    caller has already updated).  cache is updated in place."""
    _check_family(cfg)
    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               q_pos)
    span_scatter(cache["k"], k, q_pos, valid)
    span_scatter(cache["v"], v, q_pos, valid)
    ctx = attn.decode_attention(cfg, q, cache["k"], cache["v"], q_pos, k_pos,
                                window=window)
    x = x + attn.attn_out(bp["attn"], ctx)
    return x + _ffn(cfg, bp, x)[0]
