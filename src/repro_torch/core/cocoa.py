"""CoCoA with a local stochastic coordinate descent (SCD) solver
(Jaggi et al. 2014; Smith et al. 2018) for SVM training — the paper's GLM
workload (§5.1), with the duality gap as convergence metric (PyTorch).

Dual SVM (hinge loss, labels y in {-1,+1}):
    a_i = alpha_i * y_i in [0, 1],    w(alpha) = (1 / (lambda n)) X^T (a * y)
    P(w) = lambda/2 ||w||^2 + (1/n) sum_i hinge(1 - y_i x_i w)
    D(a) = (1/n) sum_i a_i - lambda/2 ||w(a)||^2
    gap  = P - D  >= 0, -> 0 at optimum.

Each CoCoA iteration: every worker k runs one SCD pass over its local samples
(H = |local|, L = 1 in the paper's Fig. 2 parametrization), updating its local
dual variables a_i and a local copy v of w; updates are merged ADDITIVELY with
the safe per-worker scaling sigma'_k = n / n_k (== K for equal partitions).

THE KEY CHICLE PROPERTY: the dual state alpha is *per-sample state stored in
the chunks* (ChunkStore.state["alpha"], numpy on the host), so
rebalancing/elasticity moves it together with the data — no state resets.
It is not kept on the device between iterations.

The host side (worker pools, shuffles, the sample-share cut, the padded
index/mask, the alpha scatter) is the JAX package's line for line, so one
seed gives one index stream in both.  The device side gathers the workers'
rows into the kernel's (K, M, F) layout, runs the SCD kernel
(`kernels.ops.scd_local_pass`, CUDA on the card, its plain version on the
CPU) and forms each worker's additive update as dw_k = (v_end_k - w) /
sigma_k, which equals the JAX `_scd_pass`'s dw in exact arithmetic.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import PROGRAM_TRACER
from .chunks import Assignment, ChunkStore


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the kernels' plain versions on the CPU")
    return dev


def duality_gap(X: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor,
                w: torch.Tensor, lam: float) -> torch.Tensor:
    margins = 1.0 - y * (X @ w)
    ww = torch.dot(w, w)
    primal = 0.5 * lam * ww + torch.clamp(margins, min=0.0).mean()
    dual = alpha.mean() - 0.5 * lam * ww
    return primal - dual


class CoCoASolver:
    """Chicle solver module for CoCoA/SCD (paper §5.1).

    X and y go to `device` once; `w` stays there.  `w0` (numpy, optional)
    is the starting model; a starting alpha is whatever
    `store.state["alpha"]` holds (zeros if absent).

    `obs.PROGRAM_TRACER` (which records only under a profiler) gets a
    span for each phase of `step`, in order: ``cocoa.pools``
    (chunk ids, shuffles, share cut, idx and mask), ``cocoa.to_device``
    (idx, alpha, sigma, mask; arg ``bytes``), ``cocoa.gather``,
    ``cocoa.scd_pass`` (the launch; args ``K``, ``M``),
    ``cocoa.merge``, ``cocoa.da_to_host`` (``cat="device"``: the host waits
    for the pass; ``bytes``) and ``cocoa.alpha_scatter``; and `metric` is
    ``cocoa.gap`` over ``cocoa.to_device`` (alpha) and
    ``cocoa.gap_to_host`` (``cat="device"``: the gap's launches and the
    blocking ``float()``)."""

    def __init__(self, store: ChunkStore, lam: float = 1e-2, seed: int = 0,
                 *, w0: Optional[np.ndarray] = None, device="cuda"):
        self.device = _device(device)
        self.store = store
        self.X = torch.from_numpy(
            np.ascontiguousarray(store.data["x"], np.float32)).to(self.device)
        self.y = torch.from_numpy(
            np.ascontiguousarray(store.data["y"], np.float32)).to(self.device)
        if "alpha" not in store.state:
            store.state["alpha"] = np.zeros(store.n_samples, np.float32)
        self.lam = lam
        self.rng = np.random.default_rng(seed)
        F = self.X.shape[1]
        self.w = (torch.zeros(F, dtype=torch.float32, device=self.device)
                  if w0 is None else
                  torch.as_tensor(np.asarray(w0, np.float32),
                                  device=self.device).clone())

    def step(self, store: ChunkStore, assignment: Assignment,
             sample_shares: Optional[np.ndarray] = None) -> Dict:
        """One CoCoA iteration: local SCD pass per worker + additive merge.

        sample_shares: fraction of its local data each worker processes this
        iteration (load balancing: slow workers process less); None = all.
        """
        trc = PROGRAM_TRACER
        K = assignment.n_workers
        with trc.span("cocoa.pools"):
            pools = []
            for wk in range(K):
                ids = np.concatenate([store.chunk_sample_ids(c)
                                      for c in assignment.chunks_of(wk)]) \
                    if assignment.chunks_of(wk) else np.zeros(0, np.int64)
                self.rng.shuffle(ids)
                if sample_shares is not None and len(ids):
                    ids = ids[: max(1, int(len(ids) * sample_shares[wk]))]
                pools.append(ids)
            M = max(max(len(p) for p in pools), 1)
            idx = np.zeros((K, M), np.int32)
            mask = np.zeros((K, M), np.float32)
            for wk, p in enumerate(pools):
                idx[wk, : len(p)] = p
                mask[wk, : len(p)] = 1.0

        n = store.n_samples
        # float32 throughout, as the JAX solver: lam * n and n / n_k
        lam_n = float(np.float32(self.lam) * np.float32(n))
        sigma = (np.float32(n) / np.maximum(mask.sum(axis=1), np.float32(1))
                 ).astype(np.float32)
        dev = self.device
        a_host = store.state["alpha"]
        with trc.span("cocoa.to_device", bytes=idx.nbytes + a_host.nbytes
                      + sigma.nbytes + mask.nbytes):
            idx_d = torch.from_numpy(idx).to(dev).long()
            alpha = torch.from_numpy(a_host).to(dev)
            sigma_d = torch.from_numpy(sigma).to(dev)
            mask_d = torch.from_numpy(mask).to(dev)
        with trc.span("cocoa.gather"):
            xs, ys, alphas = self.X[idx_d], self.y[idx_d], alpha[idx_d]
        with trc.span("cocoa.scd_pass", K=K, M=M):
            v_end, da = ops.scd_local_pass(xs, ys, alphas, self.w, mask_d,
                                           lam_n, sigma_d)
        with trc.span("cocoa.merge"):
            # additive merge: (v_end_k - w) / sigma_k is worker k's
            # (1/(lam n)) sum_j d_j y_j x_j
            dw = (v_end - self.w) / sigma_d[:, None]
            self.w = self.w + dw.sum(dim=0)
        with trc.span("cocoa.da_to_host", cat="device",
                      bytes=da.numel() * da.element_size()):
            da_np = da.cpu().numpy()
        with trc.span("cocoa.alpha_scatter"):
            a_np = a_host.copy()
            for wk in range(K):
                m = mask[wk] > 0
                np.add.at(a_np, idx[wk][m], da_np[wk][m])
            store.state["alpha"] = np.clip(a_np, 0.0, 1.0)
        samples = int(mask.sum())
        return {"samples_processed": samples,
                "per_worker_samples": mask.sum(axis=1)}

    def metric(self) -> float:
        """Duality gap (paper's convergence metric for CoCoA)."""
        trc = PROGRAM_TRACER
        a_host = self.store.state["alpha"]
        with trc.span("cocoa.gap"):
            with trc.span("cocoa.to_device", bytes=a_host.nbytes):
                alpha = torch.from_numpy(a_host).to(self.device)
            with trc.span("cocoa.gap_to_host", cat="device"):
                return float(duality_gap(self.X, self.y, alpha, self.w,
                                         float(np.float32(self.lam))))
