"""Plain reference of CoCoA's local SCD pass and of the hinge-loss SVM's
duality gap (Chicle §5.1; Jaggi et al. 2014), in float64: NumPy for the
sequential steps, PyTorch for the products.  It imports nothing of the
program.

Each of K workers makes one sequential pass over its rows, starting from
v = w; at row i, with a_i = alpha_i:

    a_new = clip(a_i + (1 - y_i <x_i, v>) / max(|x_i|^2 sigma/lam_n, 1e-12),
                 0, 1)
    d_i   = (a_new - a_i) mask_i
    v    += (sigma / lam_n) d_i y_i x_i

The pass goes through the rows in blocks: the dots of a block's rows with v
at its start and the block's Gram matrix are formed on the device, then
the steps run in order on the host, each step's update added to the later
rows' dots through the Gram column, and v moves at the block's end.  That
is the same sum as the row-by-row loop, in another order.

`round_x="bfloat16"` with dtype float32 is the control: the rows rounded to
bfloat16, the precision below the configuration's float32.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def scd_pass(torch, rows: Callable[[int, int], "torch.Tensor"], y: np.ndarray,
             alpha: np.ndarray, w: "torch.Tensor", mask: np.ndarray,
             lam_n: float, sigma: np.ndarray, *, block: int = 256,
             dtype=None, round_x: str = "") -> Tuple["torch.Tensor",
                                                    np.ndarray]:
    """rows(i0, i1): the K workers' rows i0..i1 as a (K, i1 - i0, F)
    tensor; y, alpha, mask: (K, M); w: (F,); sigma: (K,).  Returns v_end
    (K, F) on w's device and da (K, M), in `dtype` (float64 default)."""
    dtype = dtype or torch.float64
    npdt = np.float64 if dtype == torch.float64 else np.float32
    K, M = mask.shape
    dev = w.device
    v = w.to(dtype).expand(K, w.shape[0]).clone()
    da = np.zeros((K, M), npdt)
    y, alpha, mask = (np.asarray(a, npdt) for a in (y, alpha, mask))
    sig = np.asarray(sigma, npdt)
    step = sig / npdt(lam_n)
    for i0 in range(0, M, block):
        i1 = min(i0 + block, M)
        xb = rows(i0, i1)
        if round_x:
            xb = xb.to(getattr(torch, round_x))
        xb = xb.to(dtype)
        gram = (xb @ xb.transpose(1, 2)).cpu().numpy()
        q = (xb @ v[:, :, None])[:, :, 0].cpu().numpy()
        yb, ab, mb = y[:, i0:i1], alpha[:, i0:i1], mask[:, i0:i1]
        den = np.maximum(np.diagonal(gram, axis1=1, axis2=2)
                         * (sig / npdt(lam_n))[:, None], npdt(1e-12))
        s = np.zeros((K, i1 - i0), npdt)
        for j in range(i1 - i0):
            grad = 1.0 - yb[:, j] * q[:, j]
            t = np.clip(ab[:, j] + grad / den[:, j], 0.0, 1.0) - ab[:, j]
            d = t * mb[:, j]
            da[:, i0 + j] = d
            s[:, j] = step * d * yb[:, j]
            q[:, j + 1:] += s[:, j, None] * gram[:, j + 1:, j]
        v += torch.einsum("kb,kbf->kf", torch.from_numpy(s).to(dev, dtype),
                          xb)
    return v, da


def duality_gap(torch, X: "torch.Tensor", y: "torch.Tensor",
                alpha: "torch.Tensor", w: "torch.Tensor", lam: float,
                block: int = 50_000) -> Tuple[float, float]:
    """(P(w) - D(alpha), P(w)) in float64, X read in blocks of rows:
    P = lam/2 |w|^2 + mean(max(0, 1 - y X w)), D = mean(alpha) -
    lam/2 |w|^2."""
    w = w.double()
    hinge = 0.0
    for b0 in range(0, X.shape[0], block):
        m = 1.0 - y[b0:b0 + block].double() * (X[b0:b0 + block].double()
                                                 @ w)
        hinge += float(m.clamp_min(0.0).sum())
    ww = float(w @ w)
    n = X.shape[0]
    primal = 0.5 * lam * ww + hinge / n
    return primal - (float(alpha.double().mean()) - 0.5 * lam * ww), primal


def primal_from_dual(torch, X, y, alpha, lam: float,
                     block: int = 50_000) -> "torch.Tensor":
    """w(alpha) = X^T (alpha * y) / (lam n) in float64."""
    n, F = X.shape
    w = torch.zeros(F, dtype=torch.float64, device=X.device)
    for b0 in range(0, n, block):
        w += X[b0:b0 + block].double().t() @ (
            alpha[b0:b0 + block].double() * y[b0:b0 + block].double())
    return w / (lam * n)
