"""SCD pass: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch version.

Replaces the Pallas TPU kernel `src/repro/kernels/scd.py::_scd_kernel`
(wrapper `scd_pass`): CoCoA's local solver inner loop, the paper's
per-sample hot spot.  Each of K workers runs one sequential hinge-dual
coordinate pass over its M samples, starting from v = w:

    a_new = clip(alpha_i + (1 - y_i <x_i, v>) / max(|x_i|^2 sigma/lam_n,
                 1e-12), 0, 1)
    d_i   = (a_new - alpha_i) * mask_i
    v    += (sigma / lam_n) * d_i * y_i * x_i

and returns v_end (K, F) and the dual deltas da (K, M); masked samples
give da exactly 0.  CoCoA's additive update is (v_end_k - w) / sigma_k.

The kernels (`csrc/scd.cu`) are bound by the dependency chain, not by
bytes: each step needs the v the step before wrote.  Rows of F <= 64, F
a multiple of 4, in an x whose base is 16-byte aligned (`takes_blocked`),
take the blocked kernel: rows in blocks of `BLOCK`, each
step's dot formed as a base dot at the block's start plus Gram terms
(`scd_pass_blocked_plain` repeats its arithmetic), so the chain per step
is one shuffle, one FMA and the scalar update; these launches are also
counted in `scd_pass.launches_blocked`.  Other rows (up to F = 1024) take
the one-warp kernel, which reduces each dot with warp shuffles.  Both are
built from source with nvcc at first use (`kernels.build`) and loaded
with ctypes.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

MAX_F = 1024
BLOCK = 32  # rows per block of the blocked kernel, one lane each


def takes_blocked(F: int, aligned: bool = True) -> bool:
    """The C launcher's rule, for the tests: rows of width F go to the
    blocked kernel when F <= 64, F is a multiple of 4 and x's base is
    16-byte `aligned` (as a fresh allocation is; an offset view takes the
    one-warp kernel)."""
    return aligned and F % 4 == 0 and F <= 64


def scd_pass_plain(x: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor,
                   w: torch.Tensor, mask: torch.Tensor, lam_n: float,
                   sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential loop over i, vectorized over the K workers (the twin of
    the JAX package's `kernels/ref.py::scd_pass_ref`)."""
    K, M, F = x.shape
    sq = (x * x).sum(-1)  # (K, M)
    v = w.expand(K, F).clone()
    da = torch.zeros(K, M, dtype=torch.float32, device=x.device)
    step = sigma / lam_n
    for i in range(M):
        x_i = x[:, i]
        q = (x_i * v).sum(-1)
        grad = 1.0 - y[:, i] * q
        denom = torch.clamp(sq[:, i] * sigma / lam_n, min=1e-12)
        a_new = torch.clamp(alpha[:, i] + grad / denom, 0.0, 1.0)
        d = (a_new - alpha[:, i]) * mask[:, i]
        v = v + (step * d * y[:, i])[:, None] * x_i
        da[:, i] = d
    return v, da


def scd_pass_blocked_plain(x: torch.Tensor, y: torch.Tensor,
                           alpha: torch.Tensor, w: torch.Tensor,
                           mask: torch.Tensor, lam_n: float,
                           sigma: torch.Tensor, block: int = BLOCK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked kernel's arithmetic, vectorized over the K workers: per
    block of `block` rows (the last padded with zero rows of mask 0), base
    dots x_r . v at the block's start, the strictly lower Gram matrix
    G[r][j] = x_r . x_j, then per step j the lane-j update
    s_j = ((sigma/lam_n) y_j mask_j) (a_new - alpha_j) added as s_j G[r][j]
    to every later q_r and as s_j x_j to v.  The kernel's reciprocal-and-correction quotient is
    the correctly rounded grad / denom, as here.  Used by the tests only."""
    K, M, F = x.shape
    n_pad = -M % block
    pad = lambda t: torch.nn.functional.pad(t, (0, n_pad))  # noqa: E731
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad))
    yp, ap, mp = pad(y), pad(alpha), pad(mask)
    v = w.expand(K, F).clone()
    da = torch.zeros(K, M + n_pad, dtype=torch.float32, device=x.device)
    step = (sigma / lam_n)[:, None]
    for i0 in range(0, M + n_pad, block):
        xb = xp[:, i0:i0 + block]
        yb, ab, mb = (t[:, i0:i0 + block] for t in (yp, ap, mp))
        gram = xb @ xb.transpose(1, 2)
        den = torch.clamp(torch.diagonal(gram, dim1=1, dim2=2)
                          * sigma[:, None] / lam_n, min=1e-12)
        lower = torch.tril(gram, diagonal=-1)
        cm = step * yb * mb
        q = (xb * v[:, None]).sum(-1)
        for j in range(block):
            grad = 1.0 - yb[:, j] * q[:, j]
            t = torch.clamp(ab[:, j] + grad / den[:, j], 0.0, 1.0) - ab[:, j]
            d = t * mb[:, j]
            s = cm[:, j] * t
            q = q + s[:, None] * lower[:, :, j]
            v = v + s[:, None] * xb[:, j]
            da[:, i0 + j] = d
    return v, da[:, :M]


def _check(x, y, alpha, w, mask, sigma):
    if x.dim() != 3:
        raise ValueError(f"x must be (K, M, F); got {tuple(x.shape)}")
    K, M, F = x.shape
    for name, t, shape in (("y", y, (K, M)), ("alpha", alpha, (K, M)),
                           ("mask", mask, (K, M)), ("w", w, (F,)),
                           ("sigma", sigma, (K,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    tensors = (x, y, alpha, w, mask, sigma)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("scd_pass inputs must be float32")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all scd_pass inputs must be on one device")


def _launch(x, y, alpha, w, mask, lam_n, sigma):
    from .build import build
    fn = build("scd")["scd"].scd_pass_launch
    if fn.argtypes is None:  # ctypes caches the function object
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
    K, M, F = x.shape
    if F > MAX_F:
        raise ValueError(f"the CUDA SCD kernel holds v in registers and "
                         f"takes F <= {MAX_F}; got F={F}")
    x, y, alpha, w, mask, sigma = (t.contiguous() for t in
                                   (x, y, alpha, w, mask, sigma))
    v_end = torch.empty(K, F, dtype=torch.float32, device=x.device)
    da = torch.empty(K, M, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
             mask.data_ptr(), sigma.data_ptr(), float(lam_n),
             v_end.data_ptr(), da.data_ptr(), K, M, F, stream,
             ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"scd_pass launch failed: cudaError {err} "
                           f"(K={K} M={M} F={F})")
    scd_pass.launches += 1
    scd_pass.launches_blocked += variant.value
    return v_end, da


def scd_pass(x: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor,
             w: torch.Tensor, mask: torch.Tensor, lam_n: float,
             sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (K, M, F); y, alpha, mask: (K, M); w: (F,); lam_n: float
    (lambda * n); sigma: (K,) per-worker safe scaling; all float32.

    Returns (v_end (K, F), da (K, M)).  CUDA tensors launch a kernel (and
    count the launch in `scd_pass.launches`, and in
    `scd_pass.launches_blocked` too when it took the blocked kernel); CPU
    tensors run `scd_pass_plain`."""
    _check(x, y, alpha, w, mask, sigma)
    if x.device.type == "cpu":
        return scd_pass_plain(x, y, alpha, w, mask, lam_n, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"scd_pass runs on cuda or cpu tensors; got "
                         f"{x.device}")
    return _launch(x, y, alpha, w, mask, lam_n, sigma)


scd_pass.launches = 0
scd_pass.launches_blocked = 0
