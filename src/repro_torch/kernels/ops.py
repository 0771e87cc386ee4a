"""Model-layout wrappers around the kernels (the port of the JAX package's
`kernels/ops.py` entry points `flash_attention`, `scd_local_pass`,
`merge_updates` and `merge_pytree`).  Each runs the CUDA kernel for CUDA
tensors and its plain version for CPU tensors."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import chunk_reduce, scd
from . import flash_attention as fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Model-layout flash attention.

    q: (B, S, KV, G, hd); k, v: (B, S, KV, hd) -> (B, S, KV, G, hd)."""
    B, S, KV, G, hd = q.shape
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, hd)
    kf = k.transpose(1, 2).reshape(B * KV, S, hd)
    vf = v.transpose(1, 2).reshape(B * KV, S, hd)
    of = fa.flash_attention(qf, kf, vf, causal=causal, window=window,
                            block_q=min(block_q, S), block_k=min(block_k, S),
                            group_size=G)
    return of.reshape(B, KV, G, S, hd).permute(0, 3, 1, 2, 4)


def scd_local_pass(x, y, alpha, w, mask, lam_n: float, sigma
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CoCoA local SCD pass: x (K, M, F) -> (v_end (K, F), da (K, M))."""
    return scd.scd_pass(x, y, alpha, w, mask, lam_n, sigma)


def merge_updates(updates: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted uni-task merge: (K, N) x (K,) -> (N,)."""
    return chunk_reduce.weighted_merge(updates, weights)


def merge_pytree(deltas: Dict[str, torch.Tensor],
                 weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted merge of a dict of stacked (K, ...) worker deltas: ONE
    merge over the leaves flattened and concatenated to (K, N)."""
    names = sorted(deltas)
    K = deltas[names[0]].shape[0]
    flat = torch.cat([deltas[n].reshape(K, -1) for n in names], dim=1)
    merged = merge_updates(flat, weights)
    out, off = {}, 0
    for n in names:
        shape = deltas[n].shape[1:]
        size = deltas[n][0].numel()
        out[n] = merged[off:off + size].reshape(shape)
        off += size
    return out
