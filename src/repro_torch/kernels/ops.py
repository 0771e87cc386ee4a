"""Model-layout wrappers around the training kernels (the port of the JAX
package's `kernels/ops.py` entry points `scd_local_pass`, `merge_updates`
and `merge_pytree`).  Each runs the CUDA kernel for CUDA tensors and its
plain version for CPU tensors."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import chunk_reduce, scd


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
