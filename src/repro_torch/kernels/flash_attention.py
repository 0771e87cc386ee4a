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
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          group_size: int = 1) -> torch.Tensor:
    """k/v repeated by the group size, one full fp32 softmax with -1e30
    masks (the twin of the JAX package's `kernels/ref.py::
    flash_attention_ref`)."""
    BH, S, hd = q.shape
    if group_size > 1:
        k = k.repeat_interleave(group_size, dim=0)
        v = v.repeat_interleave(group_size, dim=0)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    d = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= d >= 0
    if window:
        ok &= d < window
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


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


def _launch(q, k, v, causal, window, group_size) -> torch.Tensor:
    from .build import build
    fn = build("flash_attention")["flash_attention"].flash_attention_launch
    if fn.argtypes is None:  # ctypes caches the function object
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BHkv,
             S, hd, group_size, int(bool(causal)), int(window),
             1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream,
             ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} "
                           f"(BHkv={BHkv} S={S} hd={hd} G={group_size})")
    flash_attention.launches += 1
    flash_attention.launches_tc += variant.value
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    group_size: int = 1) -> torch.Tensor:
    """q: (BHq, S, hd); k, v: (BHkv, S, hd) with BHq = BHkv * group_size;
    q head h uses kv head h // group_size.  Returns (BHq, S, hd) in q's
    dtype.  CUDA tensors launch a kernel (and count the launch in
    `flash_attention.launches`, and in `flash_attention.launches_tc` too
    when it ran on the tensor cores); CPU tensors run
    `flash_attention_plain`."""
    S = q.shape[1] if q.dim() == 3 else 0
    block_q, block_k = min(block_q, S), min(block_k, S)
    _check(q, k, v, group_size, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     group_size=group_size)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors; got "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, group_size)


flash_attention.launches = 0
flash_attention.launches_tc = 0
