"""Weighted merge: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch version.

Replaces the Pallas TPU kernel `src/repro/kernels/chunk_reduce.py::
_merge_kernel` (wrapper `weighted_merge`): the trainer's update merge
(paper Eq. 2 with Stich weights), out[n] = sum_k w[k] * u[k, n], summed in
fp32 and returned in u's dtype.

The kernel (`csrc/chunk_reduce.cu`) is bound by bytes: it reads the (K, N)
updates once.  A 1-D grid over N; each thread owns 16 bytes of contiguous
outputs and walks the K rows in chunks of up to 16 whose loads are all
issued before their FMAs, with the weights in shared memory.  The loads are
as wide as the rows' common alignment allows (16, 8, 4 or 2 bytes; the
launcher picks the kernel instantiated for it); the tail is bound-checked,
nothing is padded.  It takes float32 or bfloat16 updates and K <= 1024.  It is built from source
with nvcc at first use (`kernels.build`) and loaded with ctypes.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

MAX_K = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def weighted_merge_plain(updates: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """fp32 einsum (the twin of the JAX package's
    `kernels/ref.py::weighted_merge_ref`)."""
    return torch.einsum("k,kn->n", weights.float(),
                        updates.float()).to(updates.dtype)


def _check(updates, weights):
    if updates.dim() != 2:
        raise ValueError(f"updates must be (K, N); got "
                         f"{tuple(updates.shape)}")
    if tuple(weights.shape) != (updates.shape[0],):
        raise ValueError(f"weights must be ({updates.shape[0]},); got "
                         f"{tuple(weights.shape)}")
    if updates.dtype not in _DTYPES:
        raise TypeError(f"updates must be float32 or bfloat16; got "
                        f"{updates.dtype}")
    if weights.device != updates.device:
        raise ValueError("updates and weights must be on one device")


def _launch(updates, weights):
    from .build import build
    fn = build("chunk_reduce")["chunk_reduce"].weighted_merge_launch
    if fn.argtypes is None:  # ctypes caches the function object
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
    K, N = updates.shape
    if K > MAX_K:
        raise ValueError(f"the CUDA merge kernel keeps the weights in "
                         f"shared memory and takes K <= {MAX_K}; got K={K}")
    updates = updates.contiguous()
    weights = weights.to(torch.float32).contiguous()
    out = torch.empty(N, dtype=updates.dtype, device=updates.device)
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    err = fn(updates.data_ptr(), weights.data_ptr(), out.data_ptr(), K, N,
             _DTYPES[updates.dtype], stream)
    if err != 0:
        raise RuntimeError(f"weighted_merge launch failed: cudaError {err} "
                           f"(K={K} N={N})")
    weighted_merge.launches += 1
    return out


def weighted_merge(updates: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """updates: (K, N) float32 or bfloat16; weights: (K,).

    Returns (N,) = sum_k weights[k] * updates[k] in updates' dtype.  CUDA
    tensors launch the kernel (and count the launch in
    `weighted_merge.launches`); CPU tensors run `weighted_merge_plain`."""
    _check(updates, weights)
    if updates.device.type == "cpu":
        return weighted_merge_plain(updates, weights)
    if updates.device.type != "cuda":
        raise ValueError(f"weighted_merge runs on cuda or cpu tensors; got "
                         f"{updates.device}")
    return _launch(updates, weights)


weighted_merge.launches = 0
