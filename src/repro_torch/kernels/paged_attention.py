"""Paged attention: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch version.

Replaces the Pallas TPU kernel
`src/repro/kernels/paged_attention.py::_paged_kernel` (wrapper
`paged_attention`).  One QUERY SPAN per sequence (Q=1 decode; Q=chunk for
chunked prefill) attends a KV cache scattered across fixed-size physical
pages, chased through a block table; only the live pages ceil(len / ps) are
read.  Each row r of q (position-major: query position r // G) has its own
causal, live-tail and sliding-window mask; rows with length 0 give zeros.

Decode is bound by the bytes of the live K/V pages it reads (~4*G*hd
flops per K/V row of 2*hd elements, far below the H100's ops:byte ridge);
a long prefill chunk reuses each key for many rows and is bound by its
operations.  The C launcher (`csrc/paged_attention.cu`) picks one of three
kernels and reports which:
- bf16 spans of at least 16 rows (chunked prefill, spec verify) with
  head_dim 64, 80 or 128 run on the tensor cores
  (`csrc/attention_mma.cuh`): 128 rows per block, keys gathered through
  the block table into a 3-slot bf16 ring, bf16 QK^T with fp32
  accumulation, and P.V as two bf16 products of P's high and low halves,
  so P keeps ~16 bits; counted in `paged_attention.launches_tc`;
- every other span of at most 16 rows (decode, in bf16 and fp32) runs the
  split-KV kernel: the keys are cut into runs of `SPLIT_KEYS` (the grid is
  (KV, B, runs), from the table's width, so the host never reads the
  lengths), each block gathers its run's K and V in their own dtype with
  16-byte cp.async copies, four warps each take a quarter of the keys
  with an fp32 softmax in registers, and each run's (m, l, acc) partial
  goes to an fp32 workspace that the last run of each (sequence, kv head)
  to finish merges in run order, inside the same launch, so two calls
  give bitwise-equal outputs (`paged_attention_split_plain` repeats this
  arithmetic, for the tests); counted in `paged_attention.launches_split`;
- the rest (fp32 spans of more than 16 rows, bf16 spans at other
  head_dim) runs the fp32 CUDA-core kernel: one block per (sequence, kv
  head, up to 64 rows) loops over the live pages, 64 keys of whole pages
  staged as fp32 per step, m and l in shared memory.
All need head_dim a multiple of 8 up to 128 and page_size <= 64.  They are
built from source with nvcc at first use (`kernels.build`) and loaded
with ctypes.  The split route's counters (one int per (sequence, kv head),
zero between launches) live in a buffer kept per device, so a call
launches no memset; launches that share it run on one stream.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_KEYS = 64  # keys per run of the split route (csrc: SPLIT_KEYS)
SPLIT_ROWS = 16  # the most rows the split route takes
_counters: Dict[torch.device, torch.Tensor] = {}  # split counters by device


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          q_span: int = 1,
                          q_start: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather-then-softmax version (the twin of the JAX package's
    `kernels/ref.py::paged_attention_ref`): every page the table names is
    gathered (-1 clamped to the null page), scores and softmax run in fp32
    with -1e30 masks, and rows with length 0 are zeroed."""
    B, KV, QG, hd = q.shape
    G = QG // q_span
    _, ps, _, _ = k_pages.shape
    P = block_table.shape[1]
    lengths = lengths.to(torch.int32)
    if q_start is None:
        q_start = lengths - q_span
    tbl = block_table.clamp_min(0).long()
    k = k_pages[tbl].reshape(B, P * ps, KV, hd).float()
    v = v_pages[tbl].reshape(B, P * ps, KV, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * scale
    pos = torch.arange(P * ps, device=q.device)[None]  # (1, S)
    rows = torch.arange(QG, device=q.device)[None] // G
    q_abs = q_start.to(torch.int32)[:, None] + rows  # (B, QG)
    ok = ((pos < lengths[:, None])[:, None, :]
          & (pos[:, None, :] <= q_abs[..., None]))  # (B, QG, S)
    if window:
        ok &= (q_abs[..., None] - pos[:, None, :]) < window
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_table: torch.Tensor,
                                lengths: torch.Tensor, *, window: int = 0,
                                q_span: int = 1,
                                q_start: Optional[torch.Tensor] = None,
                                split_keys: int = SPLIT_KEYS
                                ) -> torch.Tensor:
    """The split route's arithmetic, for the tests: the keys are cut into
    runs of `split_keys`; each run gives per row its max score m, its
    l = sum exp(s - m) and acc = sum exp(s - m) v (fp32, -1e30 masks); the
    runs no row of the span can see are skipped, and the rest are merged
    in run order: out = sum_s acc_s e_s / sum_s l_s e_s, e_s =
    exp(m_s - max_s m_s).  Rows with length 0 (or that see no key) are
    zeros."""
    B, KV, QG, hd = q.shape
    G = QG // q_span
    _, ps, _, _ = k_pages.shape
    P = block_table.shape[1]
    n_split = -(-P * ps // split_keys)
    S = n_split * split_keys
    lengths = lengths.to(torch.int32)
    if q_start is None:
        q_start = lengths - q_span
    tbl = block_table.clamp_min(0).long()
    k = k_pages[tbl].reshape(B, P * ps, KV, hd).float()
    v = v_pages[tbl].reshape(B, P * ps, KV, hd).float()
    pad = (0, 0, 0, 0, 0, S - P * ps)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * scale
    pos = torch.arange(S, device=q.device)
    q_abs = (q_start.to(torch.int32)[:, None]
             + torch.arange(QG, device=q.device)[None] // G)  # (B, QG)
    k_end = lengths.clamp(max=P * ps)
    lo = (q_abs - window + 1).clamp_min(0) if window else \
        torch.zeros_like(q_abs)
    hi = torch.minimum(k_end[:, None], q_abs + 1)
    ok = (pos >= lo[..., None]) & (pos < hi[..., None])  # (B, QG, S)
    s = torch.where(ok[:, None], s, NEG_INF)
    s = s.reshape(B, KV, QG, n_split, split_keys)
    m = s.amax(-1)  # (B, KV, QG, n_split)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgnj,bnjkh->bkgnh", p,
                       v.reshape(B, n_split, split_keys, KV, hd))
    # the runs some row sees: [k_lo, k_hi) over the span's rows
    k_lo, k_hi = lo[:, 0], hi[:, -1]
    run = torch.arange(n_split, device=q.device)
    live = ((run >= (k_lo // split_keys)[:, None])
            & (run <= ((k_hi - 1) // split_keys)[:, None])
            & (k_hi > k_lo)[:, None] & (lengths > 0)[:, None])  # (B, n)
    m_top = torch.where(live[:, None, None], m, -math.inf).amax(-1)
    out = torch.zeros(B, KV, QG, hd, device=q.device)
    den = torch.zeros(B, KV, QG, device=q.device)
    for i in range(n_split):  # in run order
        e = torch.where(live[:, i, None, None],
                        torch.exp(m[..., i] - m_top), 0.0)
        den = den + l[..., i] * e
        out = out + acc[..., i, :] * e[..., None]
    seen = live.any(1)
    out = torch.where(seen[:, None, None, None],
                      out / torch.where(seen[:, None, None], den, 1.0)[
                          ..., None], 0.0)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, block_table, lengths, q_start, q_span):
    B, KV, QG, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must be (N, ps, KV, hd) of one shape; "
                         f"got {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    if (k_pages.shape[2], k_pages.shape[3]) != (KV, hd):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)} in (KV, hd)")
    if q_span < 1 or QG % q_span:
        raise ValueError(f"q rows {QG} not a multiple of q_span {q_span}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be (B={B}, P); got "
                         f"{tuple(block_table.shape)}")
    for name, t in (("lengths", lengths), ("q_start", q_start)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be ({B},); got {tuple(t.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    for name, t in (("block_table", block_table), ("lengths", lengths),
                    ("q_start", q_start)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32; got {t.dtype}")
    tensors = (q, k_pages, v_pages, block_table, lengths, q_start)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all paged_attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention inputs must be contiguous")


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The split route's per-(sequence, kv head) counters on `device`: a
    zeroed buffer kept across calls (the kernel leaves it zero), grown
    when a call needs more."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 64)
        buf = _counters[device] = torch.zeros(size, dtype=torch.int32,
                                              device=device)
    return buf


def _launch(q, k_pages, v_pages, block_table, lengths, q_start, window,
            q_span) -> torch.Tensor:
    from .build import build
    lib = build("paged_attention")["paged_attention"]
    fn = lib.paged_attention_launch
    if fn.argtypes is None:  # ctypes caches the function object
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
        lib.paged_attention_split_keys.restype = ctypes.c_int
        fn.split_keys = lib.paged_attention_split_keys()
    B, KV, QG, hd = q.shape
    ps, P = k_pages.shape[1], block_table.shape[1]
    if hd % 8 or hd > 128 or ps > 64 \
            or (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError(f"the CUDA kernel needs head_dim a multiple of 8 "
                         f"up to 128, page_size <= 64 and 16-byte aligned "
                         f"pools; got hd={hd}, page_size={ps}")
    out = torch.empty_like(q)
    part = counters = None
    if QG <= SPLIT_ROWS:  # the split route's candidates
        n_split = -(-P * ps // fn.split_keys)
        part = torch.empty(B * KV * n_split * QG * (hd + 2),
                           dtype=torch.float32, device=q.device)
        counters = _split_counters(q.device, B * KV)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), q_start.data_ptr(),
             out.data_ptr(), part.data_ptr() if part is not None else None,
             counters.data_ptr() if counters is not None else None,
             B, KV, QG, hd, ps, P, QG // q_span, int(window),
             1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream,
             ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err} "
                           f"(B={B} KV={KV} QG={QG} hd={hd} ps={ps})")
    paged_attention.launches += 1
    paged_attention.launches_tc += variant.value == 1
    paged_attention.launches_split += variant.value == 2
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, window: int = 0,
                    q_span: int = 1,
                    q_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, KV, q_span*G, hd), position-major rows; k_pages/v_pages:
    (N, page_size, KV, hd); block_table: (B, P) int32 (-1 = absent);
    lengths: (B,) int32 live tokens INCLUDING the span's writes; q_start:
    (B,) int32 absolute position of each span's first query (default
    lengths - q_span); window: sliding window (0 = full causal context).

    Returns (B, KV, q_span*G, hd).  CUDA tensors launch a kernel (and
    count the launch in `paged_attention.launches`, and in
    `paged_attention.launches_tc` or `paged_attention.launches_split` too
    when it took the tensor-core or the split route); CPU tensors run
    `paged_attention_plain`."""
    if q_start is None:
        q_start = (lengths - q_span).to(torch.int32)
    _check(q, k_pages, v_pages, block_table, lengths, q_start, q_span)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     lengths, window=window, q_span=q_span,
                                     q_start=q_start)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors; got "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_table, lengths, q_start,
                   window, q_span)


paged_attention.launches = 0
paged_attention.launches_tc = 0
paged_attention.launches_split = 0
