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

The kernel (`csrc/scd.cu`) is bound by its dependency chain, not by bytes:
each step needs the v the step before wrote.  One warp per worker holds v
in registers, reduces the dot with warp shuffles and loads the next rows
ahead of the chain.  It takes F <= 1024.  It is built from source with
nvcc at first use (`kernels.build`) and loaded with ctypes.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

MAX_F = 1024


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
                       + [ctypes.c_void_p])
    K, M, F = x.shape
    if F > MAX_F:
        raise ValueError(f"the CUDA SCD kernel holds v in registers and "
                         f"takes F <= {MAX_F}; got F={F}")
    x, y, alpha, w, mask, sigma = (t.contiguous() for t in
                                   (x, y, alpha, w, mask, sigma))
    v_end = torch.empty(K, F, dtype=torch.float32, device=x.device)
    da = torch.empty(K, M, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
             mask.data_ptr(), sigma.data_ptr(), float(lam_n),
             v_end.data_ptr(), da.data_ptr(), K, M, F, stream)
    if err != 0:
        raise RuntimeError(f"scd_pass launch failed: cudaError {err} "
                           f"(K={K} M={M} F={F})")
    scd_pass.launches += 1
    return v_end, da


def scd_pass(x: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor,
             w: torch.Tensor, mask: torch.Tensor, lam_n: float,
             sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (K, M, F); y, alpha, mask: (K, M); w: (F,); lam_n: float
    (lambda * n); sigma: (K,) per-worker safe scaling; all float32.

    Returns (v_end (K, F), da (K, M)).  CUDA tensors launch the kernel (and
    count the launch in `scd_pass.launches`); CPU tensors run
    `scd_pass_plain`."""
    _check(x, y, alpha, w, mask, sigma)
    if x.device.type == "cpu":
        return scd_pass_plain(x, y, alpha, w, mask, lam_n, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"scd_pass runs on cuda or cpu tensors; got "
                         f"{x.device}")
    return _launch(x, y, alpha, w, mask, lam_n, sigma)


scd_pass.launches = 0
