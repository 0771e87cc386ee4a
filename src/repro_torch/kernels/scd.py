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
bytes: each step needs the v the step before wrote.  They take F a
multiple of 4 in a 16-byte aligned x; the wrapper copies other rows into
an aligned buffer with zero columns up to the next multiple of 4 (zero
columns add exactly 0 to every dot and to |x|^2; v_end is sliced back).
Rows of (padded) F <= 64 (`takes_blocked`) take the blocked kernel: rows
in blocks of `BLOCK`, each step's dot formed as a base dot at the block's
start plus Gram terms (`scd_pass_blocked_plain` repeats its arithmetic),
so the chain per step is one shuffle, one FMA and the scalar update;
these launches are also counted in `scd_pass.launches_blocked`.  Rows up
to F = `WIDE_MAX_F` (`takes_wide`) take the wide kernel: the same chain,
with the Gram matrices, the block-end v update and the base dots on nine
producer warps and v in shared memory, in blocks of `wide_rows(F)` rows
(`scd_pass_wide_plain` repeats its arithmetic); counted in
`scd_pass.launches_wide`.  Wider rows (`takes_row`) take the row kernel,
which runs `scd_pass_plain`'s loop one step at a time: a 512-thread block
per worker reads each row once, sums x_i . v and |x_i|^2 in a block-wide
reduction, takes the clipped step and updates v (in shared memory while
it fits, else in the worker's v_out row); counted in
`scd_pass.launches_row`.  All are built from source with nvcc at first
use (`kernels.build`) and loaded with ctypes.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

BLOCK = 32  # rows per block of the blocked kernel, one lane each
WIDE_BF = 16384  # the wide kernel's B F: three slots of B rows fit
WIDE_MAX_F = WIDE_BF // 4  # the wide kernel's widest rows: blocks of 4


def _padded(F: int) -> int:
    return -(-F // 4) * 4


def takes_blocked(F: int) -> bool:
    """The C launcher's rule, for the tests: rows of width F (padded to a
    multiple of 4) go to the blocked kernel when F <= 64."""
    return _padded(F) <= 64


def takes_wide(F: int) -> bool:
    """The C launcher's rule, for the tests: rows of width 64 < F <=
    WIDE_MAX_F (padded to a multiple of 4) go to the wide kernel."""
    return 64 < _padded(F) <= WIDE_MAX_F


def takes_row(F: int) -> bool:
    """The C launcher's rule, for the tests: rows wider than WIDE_MAX_F
    (padded to a multiple of 4) go to the row kernel."""
    return _padded(F) > WIDE_MAX_F


def wide_rows(F: int) -> int:
    """Rows a block of the wide kernel at width F (padded to a multiple of
    4): 32, halved while B F > WIDE_BF, at least 4 (the C rule)."""
    F, b = _padded(F), BLOCK
    while b > 4 and b * F > WIDE_BF:
        b //= 2
    return b


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


def scd_pass_wide_plain(x: torch.Tensor, y: torch.Tensor,
                        alpha: torch.Tensor, w: torch.Tensor,
                        mask: torch.Tensor, lam_n: float,
                        sigma: torch.Tensor, block: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide kernel's arithmetic, vectorized over the K workers: per
    block of `block` rows (default `wide_rows(F)`; the last block padded
    with zero rows of mask 0), the base dots x_r . v at the block's start,
    the lower Gram matrix with |x_r|^2 on its diagonal, then per step j the
    lane-j update s_j = ((sigma/lam_n) y_j mask_j) (a_new - alpha_j) added
    as s_j G[r][j] to every later q_r; v moves only at the block's end,
    by sum_j s_j x_j in four partial sums over j mod 4.  The kernel never
    tiles F: it halves the block instead (`wide_rows`), so a block's rows
    always fit its shared memory.  Used by the tests only."""
    K, M, F = x.shape
    block = block or wide_rows(F)
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
        q = (xb * v[:, None]).sum(-1)
        gram = xb @ xb.transpose(1, 2)
        den = torch.clamp(torch.diagonal(gram, dim1=1, dim2=2)
                          * sigma[:, None] / lam_n, min=1e-12)
        lower = torch.tril(gram, diagonal=-1)
        cm = step * yb * mb
        s = torch.zeros_like(yb)
        for j in range(block):
            grad = 1.0 - yb[:, j] * q[:, j]
            t = torch.clamp(ab[:, j] + grad / den[:, j], 0.0, 1.0) - ab[:, j]
            s[:, j] = cm[:, j] * t
            q = q + s[:, j, None] * lower[:, :, j]
            da[:, i0 + j] = t * mb[:, j]
        part = [torch.zeros_like(v) for _ in range(4)]
        for j in range(block):
            part[j % 4] = part[j % 4] + s[:, j, None] * xb[:, j]
        v = v + ((part[0] + part[1]) + (part[2] + part[3]))
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
    x, y, alpha, w, mask, sigma = (t.contiguous() for t in
                                   (x, y, alpha, w, mask, sigma))
    Fp = _padded(F)
    if Fp != F or x.data_ptr() % 16:
        # the kernels read 16-byte aligned rows of 16-byte multiples: an
        # aligned copy, with zero columns that add exactly 0 to every dot
        x = torch.nn.functional.pad(x, (0, Fp - F))
        w = torch.nn.functional.pad(w, (0, Fp - F))
    v_end = torch.empty(K, Fp, dtype=torch.float32, device=x.device)
    da = torch.empty(K, M, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
             mask.data_ptr(), sigma.data_ptr(), float(lam_n),
             v_end.data_ptr(), da.data_ptr(), K, M, Fp, stream,
             ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"scd_pass launch failed: cudaError {err} "
                           f"(K={K} M={M} F={F})")
    scd_pass.launches += 1
    scd_pass.launches_blocked += variant.value == 1
    scd_pass.launches_wide += variant.value == 2
    scd_pass.launches_row += variant.value == 3
    return (v_end if Fp == F else v_end[:, :F].contiguous()), da


def scd_pass(x: torch.Tensor, y: torch.Tensor, alpha: torch.Tensor,
             w: torch.Tensor, mask: torch.Tensor, lam_n: float,
             sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (K, M, F); y, alpha, mask: (K, M); w: (F,); lam_n: float
    (lambda * n); sigma: (K,) per-worker safe scaling; all float32.

    Returns (v_end (K, F), da (K, M)).  CUDA tensors launch a kernel (and
    count the launch in `scd_pass.launches`, and in
    `scd_pass.launches_blocked`, `scd_pass.launches_wide` or
    `scd_pass.launches_row` too, by the kernel it took); CPU tensors run
    `scd_pass_plain`."""
    _check(x, y, alpha, w, mask, sigma)
    if x.device.type == "cpu":
        return scd_pass_plain(x, y, alpha, w, mask, lam_n, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"scd_pass runs on cuda or cpu tensors; got "
                         f"{x.device}")
    return _launch(x, y, alpha, w, mask, lam_n, sigma)


scd_pass.launches = 0
scd_pass.launches_blocked = 0
scd_pass.launches_wide = 0
scd_pass.launches_row = 0
