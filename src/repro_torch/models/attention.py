"""Attention: GQA projections, query-blocked exact attention (prefill),
attention of new tokens against a cache, and the paged-KV gather helpers.

The head layout is the JAX package's, so its parameter trees load one to
one: Q heads are padded to a multiple of TENSOR_PAD and the padded heads are
hard-masked after attention.  The 'grouped' layout reshapes q to
(.., KV, g_pad, hd) and contracts against the compact KV heads; the 'flat'
layout expands k/v to the padded Q-head count.

Masks add or select NEG_INF = -1e30, never -inf, so a row that sees no key
is a uniform average and never NaN.  Scores and softmax are fp32; the
probabilities are cast to v's dtype before the PV product, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import flash_attention as fa
from ..obs import NOOP_SPAN, PROGRAM_TRACER
from .layers import ParamDef, head_out, head_proj, rms_norm, rope

NEG_INF = -1e30
TENSOR_PAD = 16  # pad target of the Q heads (the JAX package's model axis)


def head_layout(cfg: ModelConfig) -> Tuple[str, int, int]:
    """-> (kind, H_pad, g_pad).

    'grouped': H_pad = KV * g_pad with (KV*g_pad) % 16 == 0, chosen when it
    costs no more padded heads than the flat layout.  'flat': H_pad =
    ceil16(H), k/v expanded by a gather."""
    h, kv = cfg.num_heads, cfg.kv_heads()
    flat_hp = ((h + TENSOR_PAD - 1) // TENSOR_PAD) * TENSOR_PAD
    g = max(h // kv, 1)
    g_pad = g
    while (kv * g_pad) % TENSOR_PAD:
        g_pad += 1
    if kv * g_pad <= flat_hp:
        return "grouped", kv * g_pad, g_pad
    return "flat", flat_hp, 0


def padded_heads(cfg: ModelConfig) -> int:
    return head_layout(cfg)[1]


def attn_defs(cfg: ModelConfig, d_model: Optional[int] = None
              ) -> Dict[str, ParamDef]:
    d = d_model or cfg.d_model
    kv, hd = cfg.kv_heads(), cfg.head_dim_()
    hp = padded_heads(cfg)
    defs = {
        "wq": ParamDef((d, hp, hd), ("fsdp", "tensor", None)),
        "wk": ParamDef((d, kv, hd), ("fsdp", None, None)),
        "wv": ParamDef((d, kv, hd), ("fsdp", None, None)),
        "wo": ParamDef((hp, hd, d), ("tensor", None, "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((hp, hd), ("tensor", None), init="zeros")
        defs["bk"] = ParamDef((kv, hd), (None, None), init="zeros")
        defs["bv"] = ParamDef((kv, hd), (None, None), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def head_maps(cfg: ModelConfig, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kv index per padded q head, padded-head validity mask)."""
    kv, h = cfg.kv_heads(), cfg.num_heads
    kind, hp, g_pad = head_layout(cfg)
    g = max(h // kv, 1)
    ar = torch.arange(hp, device=device)
    if kind == "grouped":
        # each kv group owns g_pad slots; the first g are real heads
        return ar // g_pad, (ar % g_pad) < g
    return torch.clamp(ar // g, max=kv - 1), ar < h


def expand_kv(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """(..., KV, hd) -> (..., H_pad, hd) via the group-index gather."""
    idx, _ = head_maps(cfg, k.device)
    return k.index_select(-2, idx)


def q_project(cfg: ModelConfig, p, x: torch.Tensor,
              positions: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B, S, D) -> q (B, S, H_pad, hd); positions None: no rope."""
    q = head_proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q if positions is None else rope(q, positions, cfg.rope_theta)


def kv_project(cfg: ModelConfig, p, x: torch.Tensor,
               positions: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> k, v (B, S, KV, hd) (compact); positions None: no
    rope."""
    k = head_proj(x, p["wk"])
    v = head_proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def qkv_project(cfg: ModelConfig, p, x: torch.Tensor,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H_pad,hd), k/v (B,S,KV,hd) (compact).
    positions None: no rotary embedding (cross-attention, the encoder)."""
    return (q_project(cfg, p, x, positions),
            *kv_project(cfg, p, x, positions))


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive fp32 causal (and sliding-window) bias."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, NEG_INF)


def flash_route(device_type: str, dtype: torch.dtype,
                layout: Tuple[str, int, int], S: int, Sk: int,
                hd: int) -> bool:
    """Whether `blocked_attention` runs on the flash kernels: CUDA, bf16,
    the grouped head layout (q head h uses kv head h // g_pad) with
    g_pad <= 64, self-attention (Sk == S), a tensor-core head dim and S a
    multiple of the backward's tile."""
    kind, _, g_pad = layout
    return (device_type == "cuda" and dtype == torch.bfloat16
            and kind == "grouped" and g_pad <= 64 and Sk == S
            and hd in fa.TC_HEAD_DIMS and S % fa.BWD_TILE == 0)


class _FlashAttention(torch.autograd.Function):
    """The flash forward (which also writes each row's log-sum-exp) and its
    backward kernel, on the kernels' layout: q (B*KV*G, S, hd), k and v
    (B*KV, S, hd).  Each pass is a ``train.attention`` device span of
    `obs.PROGRAM_TRACER` (arg ``phase``; it records only under a
    profiler), remat's recomputation a forward one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, group_size):
        with PROGRAM_TRACER.device_span("train.attention", device=q.device,
                                        phase="forward"):
            out, lse = fa.flash_attention(
                q, k, v, causal=causal, window=window,
                group_size=group_size, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, group_size=group_size)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with PROGRAM_TRACER.device_span("train.attention", device=q.device,
                                        phase="backward"):
            dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_grouped_attention(cfg: ModelConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """`blocked_attention`'s flash route (on the CPU: the kernels' plain
    versions), for the grouped layout.  q: (B, S, H_pad, hd); k, v:
    (B, S, KV, hd).  While autograd records, `_FlashAttention` (the
    backward kernel); otherwise the forward kernel alone.  Returns
    (B, S, H_pad, hd) with padded heads zeroed."""
    B, S, HP, hd = q.shape
    KV = k.shape[2]
    g = HP // KV
    qf = q.reshape(B, S, KV, g, hd).permute(0, 2, 3, 1, 4).reshape(
        B * KV * g, S, hd)
    kf, vf = (t.transpose(1, 2).reshape(B * KV, S, hd) for t in (k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        of = _FlashAttention.apply(qf, kf, vf, causal, window, g)
    else:
        of = fa.flash_attention(qf, kf, vf, causal=causal, window=window,
                                group_size=g)
    out = of.reshape(B, KV, g, S, hd).permute(0, 3, 1, 2, 4).reshape(
        B, S, HP, hd)
    _, hmask = head_maps(cfg, q.device)
    return out * hmask[None, None, :, None].to(out.dtype)


def blocked_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, causal: bool = True,
                      window: int = 0, q_block: int = 512) -> torch.Tensor:
    """Exact attention over query blocks (plain matmul + softmax, as the
    JAX package leaves it to XLA), causal unless `causal` is False (the
    bidirectional encoder).  While autograd records, each query
    block is recomputed in backward (the JAX package's `@jax.checkpoint
    one_block`), so no block's fp32 scores and probabilities outlive it.
    Inputs that `flash_route` admits take `flash_grouped_attention`
    instead: the same function up to rounding (P keeps ~16 bits before
    P.V, not bf16's 8), with no score block in device memory.

    While autograd records, a ``train.attention`` device span of
    `obs.PROGRAM_TRACER` (arg ``phase``) times attention: on the flash
    route its forward and its backward; here its forward only (and remat's
    recomputation), since autograd runs this path's backward outside it.

    q: (B, S, H_pad, hd); k, v: (B, Sk, KV, hd) compact.
    Returns (B, S, H_pad, hd) with padded heads zeroed."""
    B, S, HP, hd = q.shape
    if k.dtype == v.dtype == q.dtype and flash_route(
            q.device.type, q.dtype, head_layout(cfg), S, k.shape[1], hd):
        return flash_grouped_attention(cfg, q, k, v, causal=causal,
                                       window=window)
    span = (PROGRAM_TRACER.device_span("train.attention", device=q.device,
                                       phase="forward")
            if torch.is_grad_enabled() else NOOP_SPAN)
    with span:
        return _blocked_attention(cfg, q, k, v, causal=causal,
                                  window=window, q_block=q_block)


def _blocked_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, causal: bool, window: int,
                       q_block: int) -> torch.Tensor:
    """`blocked_attention`'s query-blocked path, whatever the inputs."""
    B, S, HP, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    _, hmask = head_maps(cfg, q.device)
    kf = expand_kv(cfg, k).permute(0, 2, 3, 1).float()  # (B, H, hd, Sk)
    vf = expand_kv(cfg, v).transpose(1, 2)  # (B, H, Sk, hd)
    k_pos = torch.arange(Sk, device=q.device)

    def one_block(q_blk: torch.Tensor, q0: int) -> torch.Tensor:
        qb = q_blk.shape[1]
        bias = _mask_bias(q0 + torch.arange(qb, device=q.device), k_pos,
                          causal=causal, window=window)
        qs = (q_blk * scale).transpose(1, 2)  # (B, H, qb, hd), q's dtype
        # fp32 scores from the working-dtype operands (JAX's
        # preferred_element_type=float32)
        scores = qs.float() @ kf
        probs = torch.softmax(scores + bias, dim=-1)
        return (probs.to(vf.dtype) @ vf).transpose(1, 2)  # (B, qb, H, hd)

    block = one_block
    if torch.is_grad_enabled():
        def block(q_blk, q0):
            return checkpoint(one_block, q_blk, q0, use_reentrant=False)

    q_block = min(q_block, S)
    n_blocks = max(S // q_block, 1)
    outs = [block(q[:, i * q_block:(i + 1) * q_block], i * q_block)
            for i in range(n_blocks)]
    if S - n_blocks * q_block:
        outs.append(block(q[:, n_blocks * q_block:], n_blocks * q_block))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out * hmask[None, None, :, None].to(out.dtype)


def decode_attention(cfg: ModelConfig, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     k_pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Attention of Q new tokens against a cache.

    q: (B, Q, H_pad, hd); k_cache/v_cache: (B, Sc, KV, hd);
    q_pos: (B, Q) absolute query positions;
    k_pos: (B, Sc) absolute key positions (-1 = empty)."""
    B, Q, HP, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    kind, _, g_pad = head_layout(cfg)
    _, hmask = head_maps(cfg, q.device)
    KV = cfg.kv_heads()
    d = q_pos[:, :, None] - k_pos[:, None, :]  # (B, Q, Sc)
    ok = (d >= 0) & (k_pos[:, None, :] >= 0)
    if window:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, NEG_INF)  # (B, Q, Sc)
    qs = q * scale
    if kind == "grouped":
        # contract against the COMPACT cache (no head-expansion gather)
        qg = qs.reshape(B, Q, KV, g_pad, hd).permute(0, 2, 3, 1, 4)
        kt = k_cache.permute(0, 2, 3, 1)[:, :, None]  # (B, KV, 1, hd, Sc)
        scores = qg.float() @ kt.float()  # (B, KV, g, Q, Sc)
        probs = torch.softmax(scores + bias[:, None, None], dim=-1)
        vt = v_cache.transpose(1, 2)[:, :, None]  # (B, KV, 1, Sc, hd)
        out = probs.to(v_cache.dtype) @ vt  # (B, KV, g, Q, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, Q, HP, hd)
    else:
        kf = expand_kv(cfg, k_cache).permute(0, 2, 3, 1)  # (B, H, hd, Sc)
        vf = expand_kv(cfg, v_cache).transpose(1, 2)  # (B, H, Sc, hd)
        scores = qs.transpose(1, 2).float() @ kf.float()  # (B, H, Q, Sc)
        probs = torch.softmax(scores + bias[:, None], dim=-1)
        out = (probs.to(vf.dtype) @ vf).transpose(1, 2)
    return out * hmask[None, None, :, None].to(out.dtype)


# ---------------------------------------------------------------------------
# Paged KV: gather-through-block-table helpers (the plain path; the kernel
# in kernels/paged_attention.py reads the pages in place)
# ---------------------------------------------------------------------------


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """(N, ps, KV, hd) pool + (B, P) table -> (B, P*ps, KV, hd) in logical
    token order.  Absent entries (-1) clamp to the null page; callers mask
    them by position (paged_k_pos)."""
    B, P = block_table.shape
    _, ps, KV, hd = pages.shape
    seq = pages[block_table.clamp_min(0).long()]
    return seq.reshape(B, P * ps, KV, hd)


def paged_k_pos(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B,) live lengths -> (B, seq_len) key positions, -1 beyond live."""
    pos = torch.arange(seq_len, dtype=torch.int32,
                       device=lengths.device)[None]
    return torch.where(pos < lengths[:, None], pos, -1)


def attn_out(p, ctx: torch.Tensor) -> torch.Tensor:
    """einsum('bshe,hed->bsd') as one matmul."""
    return head_out(ctx, p["wo"])
