"""Block-composed transformer backbones for every model family.

A model is embedding -> a loop over homogeneous BLOCKS -> final norm ->
tied logits.  A block bundles the family's repeating pattern (the JAX
package's `lax.scan` body):

  dense:   1 x (self-attn + swiglu)
  moe:     1 x (self-attn + moe-ffn [+ dense residual])
  hybrid:  `attn_every` sub-layers: 1 attn + (attn_every-1) mamba, ffn
           alternating dense/moe per `moe_every`
  vlm:     (cross_attn_every-1) x (self+mlp) + 1 x (cross-attn+mlp)
  xdec:    1 x (self-attn + cross-attn + mlp)     (whisper decoder)
  ssm:     1 x (rwkv6 time-mix + channel-mix)

Every block type has defs, a full-sequence apply (train and prefill) and
the flat-cache decode step (Q=1).  The paged-KV step (decode, or a verify
span or chunked-prefill chunk, Q>1) and the flat-cache speculative verify
span are the dense and moe blocks' only, as in the JAX package: a
recurrent state does not page.  Caches are dicts of tensors stacked over
blocks; the steps update them in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import ParamDef, map_defs, mlp_defs, rms_norm, swiglu, torch_dtype

FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm")
PAGED_FAMILIES = ("dense", "moe")  # paged KV and the verify span


def n_blocks(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers


def layers_per_block(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    return 1


def require_paged_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"{what} supports {'/'.join(PAGED_FAMILIES)}; got "
            f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# Param defs per block
# ---------------------------------------------------------------------------


def _ln(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones")


def _stacked(defs: Any, n: int) -> Any:
    return map_defs(lambda p: p.stacked(n), defs)


def _is_moe_sublayer(cfg: ModelConfig, i: int) -> bool:
    """Hybrid sub-layer i takes the moe FFN (jamba's every other layer)."""
    return bool(cfg.num_experts) and i % cfg.moe_every == 1


def block_defs(cfg: ModelConfig, block_type: Optional[str] = None
               ) -> Dict[str, Any]:
    d = cfg.d_model
    bt = block_type or cfg.family
    if bt == "dense":
        return {"ln1": _ln(d), "attn": attn.attn_defs(cfg),
                "ln2": _ln(d), "mlp": mlp_defs(d, cfg.d_ff)}
    if bt == "moe":
        return {"ln1": _ln(d), "attn": attn.attn_defs(cfg),
                "ln2": _ln(d), "moe": moe_mod.moe_defs(cfg)}
    if bt == "hybrid":
        k = cfg.attn_every
        n_moe = sum(1 for i in range(k) if _is_moe_sublayer(cfg, i))
        defs: Dict[str, Any] = {
            "ln_mix": _ln(d).stacked(k),
            "ln_ffn": _ln(d).stacked(k),
            "attn": attn.attn_defs(cfg),
            "mamba": _stacked(ssm.mamba_defs(cfg), k - 1),
            "mlp": _stacked(mlp_defs(d, cfg.d_ff), k - n_moe),
        }
        if n_moe:
            defs["moe"] = _stacked(moe_mod.moe_defs(cfg), n_moe)
        return defs
    if bt == "vlm":
        k = cfg.cross_attn_every
        return {
            "ln1": _ln(d).stacked(k), "ln2": _ln(d).stacked(k),
            "self": _stacked(attn.attn_defs(cfg), k - 1),
            "cross": attn.attn_defs(cfg),
            "cross_gate": ParamDef((1,), (None,), init="zeros"),
            "mlp": _stacked(mlp_defs(d, cfg.d_ff), k),
        }
    if bt == "xdec":  # whisper decoder layer
        return {"ln1": _ln(d), "self": attn.attn_defs(cfg),
                "ln_x": _ln(d), "cross": attn.attn_defs(cfg),
                "ln2": _ln(d), "mlp": mlp_defs(d, cfg.d_ff)}
    if bt == "ssm":
        return {"ln1": _ln(d), "att": ssm.rwkv_defs(cfg),
                "ln2": _ln(d), "ffn": ssm.rwkv_ffn_defs(cfg)}
    raise ValueError(f"unknown block type {bt}")


# ---------------------------------------------------------------------------
# Cache slices per block (shapes only; allocation in model.py)
# ---------------------------------------------------------------------------


def block_cache_shapes(cfg: ModelConfig, B: int, cache_len: int,
                       block_type: Optional[str] = None, cross_len: int = 0
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) for ONE block (without the leading block
    dim)."""
    bt = block_type or cfg.family
    kv, hd, d = cfg.kv_heads(), cfg.head_dim_(), cfg.d_model
    di = cfg.ssm_expand * d
    w = cfg.ssm_conv_width
    n = cfg.ssm_state_dim
    dt = torch_dtype(cfg)
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if bt in ("dense", "moe", "xdec", "hybrid"):
        out["k"] = ((B, cache_len, kv, hd), dt)
        out["v"] = ((B, cache_len, kv, hd), dt)
    if bt == "hybrid":
        out["conv"] = ((cfg.attn_every - 1, B, w - 1, di), dt)
        out["h"] = ((cfg.attn_every - 1, B, di, n), torch.float32)
    if bt == "vlm":
        k = cfg.cross_attn_every
        out["k"] = ((k - 1, B, cache_len, kv, hd), dt)
        out["v"] = ((k - 1, B, cache_len, kv, hd), dt)
    if bt in ("vlm", "xdec"):
        out["xk"] = ((B, cross_len, kv, hd), dt)
        out["xv"] = ((B, cross_len, kv, hd), dt)
    if bt == "ssm":
        out["shift_a"] = ((B, 1, d), dt)
        out["shift_f"] = ((B, 1, d), dt)
        out["wkv"] = ((B, d // cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                       cfg.rwkv_head_dim), torch.float32)
    return out


def cache_specs_for(cfg: ModelConfig, rules,
                    block_type: Optional[str] = None) -> Dict[str, Any]:
    """Specs (`sharding.AxisRules`) matching block_cache_shapes, WITH the
    leading block dim.  KV caches: compact KV heads, the SEQUENCE dim
    sharded over the model axis (flash-decode style)."""
    bt = block_type or cfg.family
    P = rules.spec
    out: Dict[str, Any] = {}
    if bt in ("dense", "moe", "xdec", "hybrid"):
        out["k"] = P(None, "cache_batch", "tensor", None, None)
        out["v"] = P(None, "cache_batch", "tensor", None, None)
    if bt == "hybrid":
        out["conv"] = P(None, None, "cache_batch", None, "tensor")
        out["h"] = P(None, None, "cache_batch", "tensor", None)
    if bt == "vlm":
        out["k"] = P(None, None, "cache_batch", "tensor", None, None)
        out["v"] = P(None, None, "cache_batch", "tensor", None, None)
        out["xk"] = P(None, "cache_batch", "tensor", None, None)
        out["xv"] = P(None, "cache_batch", "tensor", None, None)
    if bt == "xdec":
        out["xk"] = P(None, "cache_batch", "tensor", None, None)
        out["xv"] = P(None, "cache_batch", "tensor", None, None)
    if bt == "ssm":
        out["shift_a"] = P(None, "cache_batch", None, None)
        out["shift_f"] = P(None, "cache_batch", None, None)
        out["wkv"] = P(None, "cache_batch", "tensor", None, None)
    return out


# ---------------------------------------------------------------------------
# Sub-layer helpers
# ---------------------------------------------------------------------------


def _sub(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Sub-layer i of a block's stacked sub-tree, as nested dicts of
    views."""
    return {k: _sub(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _ffn(cfg: ModelConfig, bp, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A dense or moe block's pre-normed FFN -> (out, aux); aux is None
    for dense."""
    h = rms_norm(x, bp["ln2"])
    if "moe" in bp:
        return moe_mod.moe_ffn(cfg, bp["moe"], h)
    m = bp["mlp"]
    return swiglu(h, m["gate"], m["up"], m["down"]), None


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["gate"], p["up"], p["down"])


def _self_attn_full(cfg, p, x, positions, *, window, causal, q_block):
    q, k, v = attn.qkv_project(cfg, p, x, positions)
    ctx = attn.blocked_attention(cfg, q, k, v, causal=causal, window=window,
                                 q_block=q_block)
    return attn.attn_out(p, ctx), k, v


def _cross_attn(cfg, p, x, xk, xv):
    """Attention of x over the whole memory xk/xv: no rope, no mask (every
    query at position 2**30 sees every key at position 0, the JAX
    package's scalar q_pos and (Sc,) k_pos, broadcast here).  Only x's Q
    is projected: the reference's K/V of x are dead code that XLA drops."""
    q = attn.q_project(cfg, p, x, None)
    q_pos = torch.full((1, 1), 2 ** 30, dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((1, xk.shape[1]), dtype=torch.int32,
                        device=x.device)
    ctx = attn.decode_attention(cfg, q, xk, xv, q_pos, k_pos)
    return attn.attn_out(p, ctx)


def cross_kv(cfg, p, memory):
    """K/V projections of the cross-attended memory (encoder output or
    patches); the memory's Q is never projected (dead in the reference)."""
    return attn.kv_project(cfg, p, memory, None)


def _memory_kv(cfg, p, cache, memory):
    if cache is not None and "xk" in cache and memory is None:
        return cache["xk"], cache["xv"]
    return cross_kv(cfg, p, memory)


# ---------------------------------------------------------------------------
# Block apply: train and prefill (cache None -> train)
# ---------------------------------------------------------------------------


def block_apply(cfg: ModelConfig, bp, x: torch.Tensor,
                positions: Optional[torch.Tensor], *,
                block_type: Optional[str] = None, window: int = 0,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                q_block: int = 512
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                           Optional[torch.Tensor]]:
    """Full-sequence block.  x: (B, S, D); positions (B, S), or None for
    no rope (the encoder).

    cache None: training, no cache out.  A dict: the block's state before
    the sequence (the recurrent entries it lacks start at zero, so `{}`
    is a prefill from nothing; vlm/xdec take xk/xv from it only when no
    memory is given), and new_cache is the block's cache after it (k/v
    rows (B, S, KV, hd); the recurrent state; xk/xv).

    Returns (x, new_cache, aux); aux is the block's moe load-balance loss
    summed over its moe sub-layers, None when it has none."""
    bt = block_type or cfg.family
    attn_kw = dict(window=window, causal=causal, q_block=q_block)

    if bt in ("dense", "moe"):
        h, k, v = _self_attn_full(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                                  positions, **attn_kw)
        x = x + h
        f, aux = _ffn(cfg, bp, x)
        new_cache = None if cache is None else dict(cache, k=k, v=v)
        return x + f, new_cache, aux

    if bt == "hybrid":
        new_cache = None if cache is None else dict(cache)
        aux = None
        n_moe = n_dense = 0
        convs, hs = [], []
        for i in range(cfg.attn_every):
            h_in = rms_norm(x, bp["ln_mix"][i])
            if i == 0:
                h, kk, vv = _self_attn_full(cfg, bp["attn"], h_in, positions,
                                            **attn_kw)
                if new_cache is not None:
                    new_cache["k"], new_cache["v"] = kk, vv
            else:
                st = None
                if cache is not None and "conv" in cache:
                    st = (cache["conv"][i - 1], cache["h"][i - 1])
                h, (cs, hn) = ssm.mamba_forward(cfg, _sub(bp["mamba"], i - 1),
                                                h_in, st)
                convs.append(cs)
                hs.append(hn)
            x = x + h
            h2 = rms_norm(x, bp["ln_ffn"][i])
            if _is_moe_sublayer(cfg, i):
                f, a = moe_mod.moe_ffn(cfg, _sub(bp["moe"], n_moe), h2)
                aux = a if aux is None else aux + a
                n_moe += 1
            else:
                f = _mlp(_sub(bp["mlp"], n_dense), h2)
                n_dense += 1
            x = x + f
        if new_cache is not None:
            new_cache["conv"] = torch.stack(convs)
            new_cache["h"] = torch.stack(hs)
        return x, new_cache, aux

    if bt == "vlm":
        k_sub = cfg.cross_attn_every
        new_cache = None if cache is None else dict(cache)
        ks, vs = [], []
        for i in range(k_sub):
            h_in = rms_norm(x, bp["ln1"][i])
            if i < k_sub - 1:
                h, kk, vv = _self_attn_full(cfg, _sub(bp["self"], i), h_in,
                                            positions, **attn_kw)
                ks.append(kk)
                vs.append(vv)
            else:
                xk, xv = _memory_kv(cfg, bp["cross"], cache, memory)
                h = torch.tanh(bp["cross_gate"]) * _cross_attn(
                    cfg, bp["cross"], h_in, xk, xv)
                if new_cache is not None:
                    new_cache["xk"], new_cache["xv"] = xk, xv
            x = x + h
            x = x + _mlp(_sub(bp["mlp"], i), rms_norm(x, bp["ln2"][i]))
        if new_cache is not None:
            new_cache["k"] = torch.stack(ks)
            new_cache["v"] = torch.stack(vs)
        return x, new_cache, None

    if bt == "xdec":
        h, k, v = _self_attn_full(cfg, bp["self"], rms_norm(x, bp["ln1"]),
                                  positions, **attn_kw)
        x = x + h
        xk, xv = _memory_kv(cfg, bp["cross"], cache, memory)
        x = x + _cross_attn(cfg, bp["cross"], rms_norm(x, bp["ln_x"]), xk,
                            xv)
        x = x + _mlp(bp["mlp"], rms_norm(x, bp["ln2"]))
        new_cache = (None if cache is None
                     else dict(cache, k=k, v=v, xk=xk, xv=xv))
        return x, new_cache, None

    if bt == "ssm":
        B, _, D = x.shape
        st = cache or {}
        zero_shift = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
        wkv = st.get("wkv")
        if wkv is None:
            hd = cfg.rwkv_head_dim
            wkv = torch.zeros((B, D // hd, hd, hd), dtype=torch.float32,
                              device=x.device)
        h, shift_a, wkv = ssm.rwkv_time_mix(
            cfg, bp["att"], rms_norm(x, bp["ln1"]),
            st.get("shift_a", zero_shift), wkv)
        x = x + h
        h2, shift_f = ssm.rwkv_channel_mix(
            cfg, bp["ffn"], rms_norm(x, bp["ln2"]),
            st.get("shift_f", zero_shift))
        x = x + h2
        new_cache = None if cache is None else dict(
            cache, shift_a=shift_a, shift_f=shift_f, wkv=wkv)
        return x, new_cache, None

    raise ValueError(f"unknown block type {bt}")


# ---------------------------------------------------------------------------
# Paged-KV step: decode / verify span / chunked prefill (dense and moe)
# ---------------------------------------------------------------------------


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
    require_paged_family(cfg, "paged decode")
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
    else:  # a 1-element index: a 0-d one would be read on the host
        cache_k.index_copy_(1, idx.long().reshape(1), k)
        cache_v.index_copy_(1, idx.long().reshape(1), v)


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


def _self_attn_decode(cfg, p, x, pos, k_pos, cache_k, cache_v, *, window,
                      ring):
    """One token's self-attention against the flat cache, writing its K/V
    row in place first.  Returns the attention output."""
    B = x.shape[0]
    positions = (pos.reshape(B, 1) if pos.dim() else pos.expand(B, 1)
                 ).to(torch.int32)
    q, k, v = attn.qkv_project(cfg, p, x, positions)
    _write_cache(cache_k, cache_v, k, v, pos, ring)
    ctx = attn.decode_attention(cfg, q, cache_k, cache_v, positions, k_pos,
                                window=window)
    return attn.attn_out(p, ctx)


def block_decode(cfg: ModelConfig, bp, x: torch.Tensor, pos: torch.Tensor,
                 k_pos: Optional[torch.Tensor],
                 cache: Dict[str, torch.Tensor], *,
                 block_type: Optional[str] = None, window: int = 0,
                 ring: bool = False) -> torch.Tensor:
    """Flat-cache decode step of one token per row.  x: (B, 1, D); pos: a
    0-d tensor or (B,) per-row positions; k_pos: (B, W) key positions of
    the cache rows AFTER this step's write (-1 = empty; None for ssm).
    cache: this block's slice of the cache (`block_cache_shapes`), updated
    in place: K/V rows, the mamba conv/h and rwkv shift/wkv states.
    Returns the block's output x."""
    bt = block_type or cfg.family
    kw = dict(window=window, ring=ring)

    if bt in ("dense", "moe"):
        x = x + _self_attn_decode(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                                  pos, k_pos, cache["k"], cache["v"], **kw)
        return x + _ffn(cfg, bp, x)[0]

    if bt == "hybrid":
        n_moe = n_dense = 0
        for i in range(cfg.attn_every):
            h_in = rms_norm(x, bp["ln_mix"][i])
            if i == 0:
                h = _self_attn_decode(cfg, bp["attn"], h_in, pos, k_pos,
                                      cache["k"], cache["v"], **kw)
            else:
                h, (cs, hn) = ssm.mamba_decode(
                    cfg, _sub(bp["mamba"], i - 1), h_in,
                    (cache["conv"][i - 1], cache["h"][i - 1]))
                cache["conv"][i - 1].copy_(cs)
                cache["h"][i - 1].copy_(hn)
            x = x + h
            h2 = rms_norm(x, bp["ln_ffn"][i])
            if _is_moe_sublayer(cfg, i):
                f, _ = moe_mod.moe_ffn(cfg, _sub(bp["moe"], n_moe), h2)
                n_moe += 1
            else:
                f = _mlp(_sub(bp["mlp"], n_dense), h2)
                n_dense += 1
            x = x + f
        return x

    if bt == "vlm":
        k_sub = cfg.cross_attn_every
        for i in range(k_sub):
            h_in = rms_norm(x, bp["ln1"][i])
            if i < k_sub - 1:
                h = _self_attn_decode(cfg, _sub(bp["self"], i), h_in, pos,
                                      k_pos, cache["k"][i], cache["v"][i],
                                      **kw)
            else:
                h = torch.tanh(bp["cross_gate"]) * _cross_attn(
                    cfg, bp["cross"], h_in, cache["xk"], cache["xv"])
            x = x + h
            x = x + _mlp(_sub(bp["mlp"], i), rms_norm(x, bp["ln2"][i]))
        return x

    if bt == "xdec":
        x = x + _self_attn_decode(cfg, bp["self"], rms_norm(x, bp["ln1"]),
                                  pos, k_pos, cache["k"], cache["v"], **kw)
        x = x + _cross_attn(cfg, bp["cross"], rms_norm(x, bp["ln_x"]),
                            cache["xk"], cache["xv"])
        return x + _mlp(bp["mlp"], rms_norm(x, bp["ln2"]))

    if bt == "ssm":
        # the JAX package decodes the ssm block through block_apply over
        # one token (its positions are unused)
        x, new, _ = block_apply(cfg, bp, x, None, block_type="ssm",
                                cache=cache)
        for name in ("shift_a", "shift_f", "wkv"):
            cache[name].copy_(new[name])
        return x

    raise ValueError(f"unknown block type {bt}")


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
    require_paged_family(cfg, "verify")
    q, k, v = attn.qkv_project(cfg, bp["attn"], rms_norm(x, bp["ln1"]),
                               q_pos)
    span_scatter(cache["k"], k, q_pos, valid)
    span_scatter(cache["v"], v, q_pos, valid)
    ctx = attn.decode_attention(cfg, q, cache["k"], cache["v"], q_pos, k_pos,
                                window=window)
    x = x + attn.attn_out(bp["attn"], ctx)
    return x + _ffn(cfg, bp, x)[0]
