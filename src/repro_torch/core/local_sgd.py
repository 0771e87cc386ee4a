"""Local SGD / mini-batch SGD solver (Lin et al. 2018) on uni-tasks
(PyTorch).

Each of the K workers runs H local SGD steps of L samples drawn from its own
chunk-local data, then the trainer merges parameter deltas weighted by each
worker's processed-sample fraction (Stich 2018).  H=1 degrades to mSGD.

All K workers step together: `torch.func.vmap` over `torch.func.grad_and_value`
of the functional loss, one Python loop over the H local steps (the JAX
package's `scan`).  The deltas' merge goes through the weighted-merge kernel
(`kernels.ops.merge_pytree`: CUDA on the card, its plain version on the
CPU), once per iteration over all the parameters flattened to (K, N).  The
sampling is the JAX package's numpy code, so one seed draws the same
minibatches in both.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..configs.base import TrainConfig
from ..kernels import ops
from .chunks import Assignment, ChunkStore
from .cocoa import _device


class LocalSGDSolver:
    """Chicle solver module for lSGD/mSGD (paper §5.1).

    init_params: dict of tensors (moved to `device`); apply_fn(params, x)
    -> logits; loss_per_sample(logits, labels, reduce=False) -> (B,)."""

    def __init__(self, init_params: Mapping[str, torch.Tensor],
                 apply_fn: Callable, loss_per_sample: Callable,
                 train_cfg: TrainConfig, *, eval_data=None, eval_labels=None,
                 seed: int = 0, device="cuda"):
        self.device = _device(device)
        self.params = {k: torch.as_tensor(v, dtype=torch.float32,
                                          device=self.device).clone()
                       for k, v in init_params.items()}
        self.momentum = {k: torch.zeros_like(v)
                         for k, v in self.params.items()}
        self.apply_fn = apply_fn
        self.loss_fn = loss_per_sample
        self.cfg = train_cfg
        self.rng = np.random.default_rng(seed)
        self.eval_data = (None if eval_data is None
                          else torch.as_tensor(eval_data, device=self.device))
        self.eval_labels = (None if eval_labels is None else
                            torch.as_tensor(eval_labels, device=self.device))

        def local_loss(p, xb, yb, mb):
            per = self.loss_fn(self.apply_fn(p, xb), yb, reduce=False)
            return (per * mb).sum() / torch.clamp(mb.sum(), min=1.0)

        self._grad_and_loss = vmap(grad_and_value(local_loss))

    # -- sampling --------------------------------------------------------
    def _draw_indices(self, store: ChunkStore, assignment: Assignment,
                      sample_shares: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-worker minibatch indices (K, H, Lmax) + mask + merge weights.

        sample_shares: relative per-iteration sample counts (load balancing:
        worker with 2x data processes 2x samples).  Defaults to chunk shares.
        """
        K = assignment.n_workers
        H, L = self.cfg.local_steps, self.cfg.local_batch
        counts = assignment.sample_counts(store).astype(np.float64)
        if sample_shares is None:
            sample_shares = counts / max(counts.sum(), 1.0)
        l_k = np.maximum(1, np.round(sample_shares * K * L).astype(int))
        Lmax = int(l_k.max())
        idx = np.zeros((K, H, Lmax), np.int32)
        mask = np.zeros((K, H, Lmax), np.float32)
        for w in range(K):
            pool = np.concatenate([store.chunk_sample_ids(c)
                                   for c in assignment.chunks_of(w)]) \
                if assignment.chunks_of(w) else np.array([0])
            draw = self.rng.choice(pool, size=(H, l_k[w]), replace=True)
            idx[w, :, :l_k[w]] = draw
            mask[w, :, :l_k[w]] = 1.0
        n_proc = (l_k * H).astype(np.float64)
        weights = n_proc / n_proc.sum()
        return idx, mask, weights.astype(np.float32)

    # -- Chicle solver API -------------------------------------------------
    def step(self, store: ChunkStore, assignment: Assignment,
             data, labels, sample_shares=None) -> Dict:
        """One uni-task iteration over `data` (N, ...) / `labels` (N,),
        tensors on the solver's device."""
        K = assignment.n_workers
        lr = self.cfg.learning_rate
        if self.cfg.scale_lr_sqrt_k:
            lr = lr * np.sqrt(K)
        lr = float(np.float32(lr))
        mom = float(np.float32(self.cfg.momentum))
        idx, mask, weights = self._draw_indices(store, assignment,
                                                sample_shares)
        dev = self.device
        data = torch.as_tensor(data, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        idx_d = torch.from_numpy(idx).to(dev).long()
        mask_d = torch.from_numpy(mask).to(dev)
        w_d = torch.from_numpy(weights).to(dev)

        p = {k: v.expand(K, *v.shape) for k, v in self.params.items()}
        losses = []
        for h in range(self.cfg.local_steps):
            i = idx_d[:, h]
            g, loss = self._grad_and_loss(p, data[i], labels[i],
                                          mask_d[:, h])
            p = {k: p[k] - lr * g[k] for k in p}
            losses.append(loss)
        deltas = {k: p[k] - self.params[k] for k in p}
        merged = ops.merge_pytree(deltas, w_d)
        self.momentum = {k: mom * self.momentum[k] + merged[k]
                         for k in merged}
        self.params = {k: self.params[k] + self.momentum[k]
                       for k in self.params}
        loss = (torch.stack(losses).mean(dim=0) * w_d).sum()
        samples = int(mask.sum())
        return {"loss": float(loss), "samples_processed": samples,
                "per_worker_samples": mask.sum(axis=(1, 2))}

    def metric(self) -> float:
        """Test accuracy (paper's convergence metric for lSGD)."""
        with torch.no_grad():
            logits = self.apply_fn(self.params, self.eval_data)
        return float((logits.argmax(-1) == self.eval_labels).float().mean())
