"""Flash attention: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch version.

Replaces the Pallas TPU kernel
`src/repro/kernels/flash_attention.py::_flash_kernel` (wrapper
`flash_attention`): causal and/or sliding-window attention with a blocked
online softmax.  q is (B*KV*G, S, hd) and k/v (B*KV, S, hd); q row b uses
kv row b // G.  q, k and v are read as fp32, scores scaled by 1/sqrt(hd),
masks are -1e30, P.V is fp32, and the output has q's dtype.  S must divide
by the block sizes, as the TPU kernel asserts; the CUDA kernel picks its
own tiling, which changes nothing but rounding.

The kernels (`csrc/flash_attention.cu`) are bound by their operations
(4*hd flops per visible (query, key) pair, each K/V row read once per tile
of query rows).  One block per (kv head, tile of query rows that holds the
tile's positions of all G heads of the group) loops over the key steps its
rows can see (skipping those wholly outside the causal and window band).
The C launcher picks one of two kernels and reports which:
- bf16 with head_dim 32, 64, 80 or 128 runs on the tensor cores
  (`csrc/attention_mma.cuh`): 128 rows per block, bf16 QK^T with fp32
  accumulation, and P.V as two bf16 products of P's high and low halves,
  so P keeps ~16 bits; counted in `flash_attention.launches_tc`;
- every other call (fp32, other head_dim) runs the fp32 CUDA-core kernel:
  64 rows per block, K/V staged as fp32, m and l in shared memory.
Both need head_dim up to 128 with 16-byte rows (a multiple of 4 in fp32,
of 8 in bf16) and G <= 64.  They are built from source with nvcc at first
use (`kernels.build`) and loaded with ctypes.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

`flash_attention(..., return_lse=True)` also returns each row's fp32
log-sum-exp of its scaled scores, written by the tensor-core kernel.
`flash_attention_bwd` is its gradient, a hand-written Hopper kernel that
replaces no TPU kernel (the Pallas kernel has no VJP; the JAX package
differentiates its plain `blocked_attention`): bf16 with head_dim in
TC_HEAD_DIMS and S a multiple of BWD_TILE, bound by its operations (8*hd
flops per visible pair), deterministic (no atomics).  Its design, in
`csrc/flash_attention.cu`: P recomputed from the log-sum-exp, a dQ pass
and a dK/dV pass that keeps each kv group's sum in registers, dS entering
both products as a hi/lo pair of bf16 operands.  Its plain twin is
`flash_attention_bwd_plain`; launches count in
`flash_attention_bwd.launches`.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_HEAD_DIMS = (32, 64, 80, 128)  # the tensor-core kernels' head dims
BWD_TILE = 128  # the backward's keys per block: S must be a multiple


def _scores(q, k, causal, window, group_size):
    """fp32 scaled scores (BHq, S, S) with -1e30 where masked, against k
    repeated by the group size."""
    S, hd = q.shape[1:]
    k = k.repeat_interleave(group_size, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    d = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= d >= 0
    if window:
        ok &= d < window
    return torch.where(ok[None], s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          group_size: int = 1, return_lse: bool = False):
    """k/v repeated by the group size, one full fp32 softmax with -1e30
    masks (the twin of the JAX package's `kernels/ref.py::
    flash_attention_ref`).  With `return_lse`, also each row's fp32
    log-sum-exp of its scaled scores, (BHq, S)."""
    s = _scores(q, k, causal, window, group_size)
    p = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(group_size, dim=0)
    out = torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, group_size=1):
    """The backward's arithmetic in fp32: P = exp(s - lse), dP = dO V^T,
    D = rowsum(dO o O), dS = P (dP - D); dQ = dS K / sqrt(hd), and dK =
    dS^T Q / sqrt(hd) and dV = P^T dO summed over each kv head's group.
    -> (dq, dk, dv) in q's, k's and v's dtypes."""
    BH, S, hd = q.shape
    G = group_size
    p = torch.exp(_scores(q, k, causal, window, G) - lse.float()[..., None])
    do = dout.float()
    dp = torch.einsum("bqh,bkh->bqk", do,
                      v.repeat_interleave(G, dim=0).float())
    ds = p * (dp - (do * out.float()).sum(-1, keepdim=True))
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bqk,bkh->bqh", ds,
                      k.repeat_interleave(G, dim=0).float()) * scale
    dk = torch.einsum("bqk,bqh->bkh", ds, q.float()) * scale
    dv = torch.einsum("bqk,bqh->bkh", p, do)
    return (dq.to(q.dtype), dk.view(-1, G, S, hd).sum(1).to(k.dtype),
            dv.view(-1, G, S, hd).sum(1).to(v.dtype))


def _check(q, k, v, group_size, block_q, block_k):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (BHq, S, hd) and k, v (BHkv, S, hd) of "
                         f"one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, hd = q.shape
    if k.shape[0] * group_size != BH or k.shape[1:] != (S, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} with group_size {group_size}")
    if S % block_q or S % block_k:
        raise ValueError(f"S={S} must divide by block_q={block_q} and "
                         f"block_k={block_k}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all flash_attention inputs must be on one device")


def _launch(q, k, v, causal, window, group_size, return_lse=False):
    from .build import build
    fn = build("flash_attention")["flash_attention"].flash_attention_launch
    if fn.argtypes is None:  # ctypes caches the function object
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
    BHkv, S, hd = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (hd * q.element_size()) % 16 or hd > 128 or group_size > 64 \
            or (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"the CUDA kernel needs head_dim up to 128 with "
                         f"16-byte rows, group_size <= 64 and 16-byte "
                         f"aligned k/v; got hd={hd} ({q.dtype}), "
                         f"group_size={group_size}")
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), BHkv, S, hd,
             group_size, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
             _DTYPES[q.dtype], stream, ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} "
                           f"(BHkv={BHkv} S={S} hd={hd} G={group_size}"
                           f"{', with lse' if return_lse else ''})")
    flash_attention.launches += 1
    flash_attention.launches_tc += variant.value
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    group_size: int = 1, return_lse: bool = False):
    """q: (BHq, S, hd); k, v: (BHkv, S, hd) with BHq = BHkv * group_size;
    q head h uses kv head h // group_size.  Returns (BHq, S, hd) in q's
    dtype; with `return_lse` also each row's fp32 log-sum-exp of its scaled
    scores, (BHq, S), which only the tensor-core kernel writes (bf16, hd
    in TC_HEAD_DIMS).  CUDA tensors launch a kernel (and count the launch
    in `flash_attention.launches`, and in `flash_attention.launches_tc`
    too when it ran on the tensor cores); CPU tensors run
    `flash_attention_plain`."""
    S = q.shape[1] if q.dim() == 3 else 0
    block_q, block_k = min(block_q, S), min(block_k, S)
    _check(q, k, v, group_size, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     group_size=group_size,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors; got "
                         f"{q.device}")
    if return_lse and (q.dtype != torch.bfloat16
                       or q.shape[2] not in TC_HEAD_DIMS):
        raise ValueError(f"the log-sum-exp comes from the tensor-core kernel "
                         f"only: bf16 with head_dim in {TC_HEAD_DIMS}; got "
                         f"{q.dtype}, hd={q.shape[2]}")
    return _launch(q, k, v, causal, window, group_size, return_lse)


flash_attention.launches = 0
flash_attention.launches_tc = 0


def _launch_bwd(q, k, v, out, lse, dout, causal, window, group_size):
    from .build import build
    fn = build("flash_attention")["flash_attention"] \
        .flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    BHkv, S, hd = k.shape
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk,
                                   dv)]
    if any(p % 16 for p in ptrs):
        raise ValueError("flash_attention_bwd needs 16-byte aligned tensors")
    err = fn(*ptrs, BHkv, S, hd, group_size, int(bool(causal)), int(window),
             1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{err} (BHkv={BHkv} S={S} hd={hd} "
                           f"G={group_size})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, group_size: int = 1):
    """The gradients of `flash_attention` at q, k, v, from its output `out`
    and log-sum-exp `lse` (`return_lse=True`) and the output's gradient
    `dout` (shaped as q) -> (dq, dk, dv), shaped and typed as q, k, v.
    CUDA tensors launch the tensor-core backward (bf16, head_dim in
    TC_HEAD_DIMS, S a multiple of BWD_TILE; counted in
    `flash_attention_bwd.launches`) or raise; CPU tensors run
    `flash_attention_bwd_plain`."""
    S = q.shape[1] if q.dim() == 3 else 0
    _check(q, k, v, group_size, min(BWD_TILE, S), min(BWD_TILE, S))
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != q.shape[:2]:
        raise ValueError(f"out and dout must be shaped as q "
                         f"{tuple(q.shape)} and lse as {tuple(q.shape[:2])};"
                         f" got {tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    kw = dict(causal=causal, window=window, group_size=group_size)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors; "
                         f"got {q.device}")
    if (q.dtype != torch.bfloat16 or q.shape[2] not in TC_HEAD_DIMS
            or out.dtype != q.dtype or dout.dtype != q.dtype
            or lse.dtype != torch.float32 or group_size > 64
            or S % BWD_TILE):
        raise ValueError(f"the CUDA backward needs bf16 q, k, v, out and "
                         f"dout, fp32 lse, head_dim in {TC_HEAD_DIMS}, "
                         f"group_size <= 64 and S a multiple of {BWD_TILE};"
                         f" got {q.dtype}, hd={q.shape[2]}, G={group_size},"
                         f" S={S}")
    return _launch_bwd(q, k, v, out, lse, dout, causal, window, group_size)


flash_attention_bwd.launches = 0
