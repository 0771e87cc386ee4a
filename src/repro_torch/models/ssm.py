"""SSM blocks: Mamba (selective scan) and RWKV6 "Finch" (data-dependent
decay), the JAX package's chunked formulation step for step.

The sequence is cut into chunks of at most MAMBA_CHUNK / RWKV_CHUNK
tokens; the state is carried across chunks by a loop, and inside a chunk
the recurrence is evaluated in parallel through cumulative sums of
log-space decays.  Only one chunk's (B, c, d_inner, state) tensors are
alive at a time.  The fp32 cast points and the log-space clips at +-60
are the JAX package's: once a cumulative decay passes -60 the clipped
inverse no longer cancels the unclipped decay exactly, and that is kept.

Both paths are here: the full-sequence mixers (train and prefill) and the
one-token state update (decode, the same mixer over S = 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .layers import ParamDef, head_out, head_proj, rms_norm

MAMBA_CHUNK = 64
RWKV_CHUNK = 64


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    dtr = max(16, d // 16)
    return {
        "in_proj": ParamDef((d, 2 * di), ("fsdp", "tensor")),
        "conv_w": ParamDef((cfg.ssm_conv_width, di), (None, "tensor"),
                           init="small"),
        "conv_b": ParamDef((di,), ("tensor",), init="zeros"),
        "x_proj": ParamDef((di, dtr + 2 * n), ("tensor", None)),
        "dt_proj": ParamDef((dtr, di), (None, "tensor")),
        "dt_bias": ParamDef((di,), ("tensor",), init="zeros"),
        "a_log": ParamDef((di, n), ("tensor", None), init="small"),
        "d_skip": ParamDef((di,), ("tensor",), init="ones"),
        "out_proj": ParamDef((di, d), ("tensor", "fsdp")),
    }


def _mamba_chunk(p, a: torch.Tensor, dtr: int, n: int, h: torch.Tensor,
                 x_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the selective scan.  h: (B, di, n) fp32 state entering
    the chunk; x_c: (B, c, di).  Returns (h after the chunk, y_c (B, c, di)
    fp32).  Every (B, c, di, n) tensor lives only inside this call."""
    xdbl = x_c @ p["x_proj"]
    dt = F.softplus(xdbl[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    b_t = xdbl[..., dtr:dtr + n].float()  # (B, c, n)
    ct_c = xdbl[..., dtr + n:]  # (B, c, n)
    ld_c = dt.float()[..., None] * a  # (B, c, di, n) <= 0
    u_c = (dt * x_c).float()[..., None] * b_t[..., None, :]
    # h_t = exp(cum_t) * h + sum_{i<=t} exp(cum_t - cum_i) * u_i
    # (cum inclusive; exp(cum_t - cum_i) as exp(cum_t) * exp(-cum_i), the
    # inverse clipped in log space for stability)
    cum = torch.cumsum(ld_c, dim=1)
    inv = torch.exp(torch.clamp(-cum, -60.0, 60.0))
    acc = torch.cumsum(u_c * inv, dim=1)
    h_t = torch.exp(cum) * (h[:, None] + acc)
    y_c = (h_t @ ct_c.float()[..., None])[..., 0]  # 'bcdn,bcn->bcd'
    return h_t[:, -1], y_c


def mamba_scan_chunked(cfg: ModelConfig, p, x_conv: torch.Tensor,
                       h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan.  x_conv: (B, S, di); h0: (B, di, n).

    While autograd records, each chunk body is recomputed in backward
    (the JAX package's `@jax.checkpoint body`), so only the (B, c, di)
    input slice of a chunk is kept for it.  Returns (y (B, S, di) in
    x_conv's dtype, h_final (B, di, n) fp32)."""
    B, S, di = x_conv.shape
    n = cfg.ssm_state_dim
    dtr = p["dt_proj"].shape[0]
    c = min(MAMBA_CHUNK, S)
    assert S % c == 0, f"seq {S} not divisible by mamba chunk {c}"
    a = -torch.exp(p["a_log"].float())  # (di, n)

    h = h0.float()
    ys = []
    for x_c in x_conv.split(c, dim=1):
        if torch.is_grad_enabled():
            h, y_c = checkpoint(_mamba_chunk, p, a, dtr, n, h, x_c,
                                use_reentrant=False)
        else:
            h, y_c = _mamba_chunk(p, a, dtr, n, h, x_c)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + x_conv.float() * p["d_skip"]
    return y.to(x_conv.dtype), h


def mamba_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full mamba mixer.  x: (B, S, D); state: (conv_state (B, w-1, di),
    h (B, di, n) fp32), zeros when None.  Returns (out (B, S, D),
    new_state)."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    w = cfg.ssm_conv_width
    n = cfg.ssm_state_dim

    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]

    if state is None:
        conv_state = torch.zeros((B, w - 1, di), dtype=x.dtype,
                                 device=x.device)
        h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = state

    # causal depthwise conv over seq as w shifted adds: never materialises
    # the (B, S, di, w) window tensor
    xi_pad = torch.cat([conv_state, xi], dim=1)  # (B, S+w-1, di)
    x_conv = torch.zeros_like(xi)
    for i in range(w):
        x_conv = x_conv + xi_pad[:, i:i + S] * p["conv_w"][i]
    x_conv = F.silu(x_conv.float() + p["conv_b"]).to(x.dtype)

    y, h_fin = mamba_scan_chunked(cfg, p, x_conv, h0)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, (xi_pad[:, S:], h_fin)  # conv state: the last w-1 inputs


def mamba_decode(cfg: ModelConfig, p, x: torch.Tensor,
                 state: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token mamba step.  x: (B, 1, D)."""
    return mamba_forward(cfg, p, x, state)


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


def rwkv_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    lora = max(32, d // 32)
    return {
        "mix_r": ParamDef((d,), (None,), init="small"),
        "mix_k": ParamDef((d,), (None,), init="small"),
        "mix_v": ParamDef((d,), (None,), init="small"),
        "mix_w": ParamDef((d,), (None,), init="small"),
        "mix_g": ParamDef((d,), (None,), init="small"),
        "wr": ParamDef((d, h, hd), ("fsdp", "tensor", None)),
        "wk": ParamDef((d, h, hd), ("fsdp", "tensor", None)),
        "wv": ParamDef((d, h, hd), ("fsdp", "tensor", None)),
        "wg": ParamDef((d, h, hd), ("fsdp", "tensor", None)),
        "wo": ParamDef((h, hd, d), ("tensor", None, "fsdp")),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": ParamDef((h, hd), ("tensor", None), init="small"),
        "w_lora_a": ParamDef((d, lora), ("fsdp", None), init="small"),
        "w_lora_b": ParamDef((lora, h, hd), (None, "tensor", None),
                             init="small"),
        "bonus_u": ParamDef((h, hd), ("tensor", None), init="small"),
        "ln_x": ParamDef((d,), (None,), init="ones"),
    }


def rwkv_ffn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": ParamDef((d,), (None,), init="small"),
        "wk": ParamDef((d, f), ("fsdp", "tensor")),
        "wv": ParamDef((f, d), ("tensor", "fsdp")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); prev: (B, 1, D) last token of the previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_time_mix(cfg: ModelConfig, p, x: torch.Tensor, shift: torch.Tensor,
                  state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV6 time mix.  x: (B, S, D); shift: (B, 1, D); state: (B, H, hd,
    hd) fp32.  Returns (out, new_shift, new_state)."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd

    xs = _token_shift(x, shift)

    def mixed(mu):
        return x + (xs - x) * mu

    r = head_proj(mixed(p["mix_r"]), p["wr"])
    k = head_proj(mixed(p["mix_k"]), p["wk"])
    v = head_proj(mixed(p["mix_v"]), p["wv"])
    g = head_proj(mixed(p["mix_g"]), p["wg"])

    xw = mixed(p["mix_w"])
    dd = head_proj(torch.tanh(xw @ p["w_lora_a"]), p["w_lora_b"])
    log_w = -torch.exp(torch.clamp(p["w0"] + dd, -8.0, 8.0).float())  # <= 0

    out, new_state = rwkv_wkv_chunked(r, k, v, log_w, p["bonus_u"], state)
    out = rms_norm(out.reshape(B, S, D), p["ln_x"]).to(x.dtype)
    out = out * F.silu(g.reshape(B, S, D)).to(x.dtype)
    out = head_out(out.reshape(B, S, H, hd), p["wo"])
    return out.to(x.dtype), x[:, -1:], new_state


def _wkv_chunk(s: torch.Tensor, r_c: torch.Tensor, k_c: torch.Tensor,
               v_c: torch.Tensor, lw_c: torch.Tensor, u: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the WKV recurrence.  s: (B, H, hd_k, hd_v) fp32;
    r_c, k_c, v_c, lw_c: (B, c, H, hd) fp32.  Returns (s', out_c)."""
    cum = torch.cumsum(lw_c, dim=1)  # decay up to and including t
    # inter-chunk: out_t += (r_t * exp(cum_{t-1})) @ s  (decay BEFORE t)
    cum_excl = cum - lw_c
    r_dec = r_c * torch.exp(cum_excl)
    inter = torch.einsum("bchk,bhkv->bchv", r_dec, s)
    # intra-chunk: pair (t, i < t) decays by exp(cum_{t-1} - cum_i)
    k_dec = k_c * torch.exp(torch.clamp(-cum, -60.0, 60.0))
    att = torch.einsum("bchk,bihk->bchi", r_dec, k_dec)  # (B, c, H, c_i)
    att = att * mask[None, :, None, :]
    intra = torch.einsum("bchi,bihv->bchv", att, v_c)
    # bonus: the current token through u
    cur = torch.einsum("bchk,bchk->bch", r_c, k_c * u[None, None])
    out_c = inter + intra + cur[..., None] * v_c
    # state: s' = exp(cum_last) * s + sum_i exp(cum_last - cum_i) k_i v_i
    k_for_state = k_c * torch.exp(torch.clamp(cum[:, -1:] - cum, -60.0,
                                              60.0))
    s_new = torch.exp(cum[:, -1])[..., None] * s + torch.einsum(
        "bchk,bchv->bhkv", k_for_state, v_c)
    return s_new, out_c


def rwkv_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor,
                     state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV with per-(head, channel) data-dependent decay.

    r, k, v: (B, S, H, hd); log_w: (B, S, H, hd) (decay of the KEY
    channel); u: (H, hd) bonus for the current token; state: (B, H, hd,
    hd) fp32 maps key channel -> value channel.  Returns (out (B, S, H,
    hd) fp32, new_state)."""
    B, S, H, hd = r.shape
    c = min(RWKV_CHUNK, S)
    assert S % c == 0, f"seq {S} not divisible by rwkv chunk {c}"
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                 device=r.device), -1)  # strictly lower
    s = state.float()
    outs = []
    for r_c, k_c, v_c, lw_c in zip(r.float().split(c, dim=1),
                                   k.float().split(c, dim=1),
                                   v.float().split(c, dim=1),
                                   log_w.split(c, dim=1)):
        s, out_c = _wkv_chunk(s, r_c, k_c, v_c, lw_c, u, mask)
        outs.append(out_c)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, s


def rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                     shift: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel mix (squared-ReLU FFN over the token-shifted input).
    Returns (out, new_shift)."""
    xs = _token_shift(x, shift)
    xk = x + (xs - x) * p["mix_k"]
    h = torch.square(torch.relu(xk @ p["wk"]))
    return h @ p["wv"], x[:, -1:]
