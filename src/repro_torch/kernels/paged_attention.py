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
operations.  The C launcher (`csrc/paged_attention.cu`) picks one of four
kernels and reports which (`route` states its rule):
- bf16 spans of G < QG <= 32 rows (a speculative verify span of two or
  more positions, or a short last prefill chunk) with head_dim 64, 80 or
  128 run the verify kernel, split-KV on the tensor cores: the keys are
  cut into runs of `VERIFY_KEYS` (grid (KV, B, runs)), each block gathers
  its run's K and V through a two-slot ring of 128-key stages with
  16-byte cp.async copies, and four warps for each 16-row m-tile of q
  (one or two) each take a quarter of every stage on mma.sync (bf16
  QK^T with fp32 accumulation, P.V as two bf16 products of P's high and
  low halves); the runs' partials merge as the split kernel's do;
  counted in `paged_attention.launches_verify`;
- other bf16 spans of at least 16 rows (chunked prefill) with head_dim
  64, 80 or 128 run on the tensor cores (`csrc/attention_mma.cuh`): 128
  rows per block, keys gathered through the block table into a 3-slot
  bf16 ring, bf16 QK^T with fp32 accumulation, and P.V as two bf16
  products of P's high and low halves, so P keeps ~16 bits; counted in
  `paged_attention.launches_tc`;
- every other span of at most 16 rows (decode, in bf16 and fp32) runs the
  split-KV kernel: the keys are cut into runs of `SPLIT_KEYS` (the grid is
  (KV, B, runs), from the table's width, so the host never reads the
  lengths), each block gathers its run's K and V in their own dtype with
  16-byte cp.async copies, four warps each take a quarter of the keys
  with an fp32 softmax in registers, and each run's (m, l, acc) partial
  goes to an fp32 workspace that the last run of each (sequence, kv head)
  to finish merges in run order, inside the same launch, so two calls
  give bitwise-equal outputs (`paged_attention_split_plain` repeats this
  arithmetic, for the tests, at either route's run length); counted in
  `paged_attention.launches_split`;
- the rest (fp32 spans of more than 16 rows, bf16 spans at other
  head_dim) runs the fp32 CUDA-core kernel: one block per (sequence, kv
  head, up to 64 rows) loops over the live pages, 64 keys of whole pages
  staged as fp32 per step, m and l in shared memory.
All need head_dim a multiple of 8 up to 128 and page_size <= 64.  They are
built from source with nvcc at first use (`kernels.build`) and loaded
with ctypes.  The split and verify routes' counters (one int per
(sequence, kv head), zero between launches) live in a buffer kept per
device, so a call launches no memset; launches that share it run on one
stream.

`python -m repro_torch.kernels.paged_attention --selftest` runs the JAX
package's self-test cases through the kernel (`--device cpu`: through
the plain versions).

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
VERIFY_KEYS = 512  # keys per run of the verify route (csrc: VERIFY_KEYS)
VERIFY_ROWS = 32  # the most rows the verify route takes
TC_DIMS = (64, 80, 128)  # head dims of the tensor-core kernels
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


def route(dtype: torch.dtype, QG: int, G: int, hd: int) -> str:
    """The C launcher's rule for 16-byte aligned tensors whose routes'
    workspace fits (every shape the port serves): "verify" for bf16 spans
    of G < QG <= VERIFY_ROWS rows at a head dim in TC_DIMS, "tc" for other
    bf16 spans of at least 16 rows at such a head dim, "split" for every
    other span of at most SPLIT_ROWS rows, "cuda_core" for the rest."""
    tc = dtype == torch.bfloat16 and hd in TC_DIMS
    if tc and G < QG <= VERIFY_ROWS:
        return "verify"
    if tc and QG >= 16:
        return "tc"
    return "split" if QG <= SPLIT_ROWS else "cuda_core"


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
    """The split and verify routes' per-(sequence, kv head) counters on
    `device`: a
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
        lib.paged_attention_verify_keys.restype = ctypes.c_int
        fn.split_keys = lib.paged_attention_split_keys()
        fn.verify_keys = lib.paged_attention_verify_keys()
    B, KV, QG, hd = q.shape
    ps, P = k_pages.shape[1], block_table.shape[1]
    if hd % 8 or hd > 128 or ps > 64 \
            or (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError(f"the CUDA kernel needs head_dim a multiple of 8 "
                         f"up to 128, page_size <= 64 and 16-byte aligned "
                         f"pools; got hd={hd}, page_size={ps}")
    out = torch.empty_like(q)
    part = counters = None
    G = QG // q_span
    # the workspace of the launcher's route (where the verify kernel
    # refuses a shape for its size, the split kernel refuses it too)
    r = route(q.dtype, QG, G, hd)
    if q.data_ptr() % 16 and r in ("verify", "tc"):  # both need it aligned
        r = "split" if QG <= SPLIT_ROWS else "cuda_core"
    if r in ("split", "verify"):
        keys = fn.split_keys if r == "split" else fn.verify_keys
        n_split = -(-P * ps // keys)
        part = torch.empty(B * KV * n_split * QG * (hd + 2),
                           dtype=torch.float32, device=q.device)
        counters = _split_counters(q.device, B * KV)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = ctypes.c_int(0)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), q_start.data_ptr(),
             out.data_ptr(), part.data_ptr() if part is not None else None,
             counters.data_ptr() if counters is not None else None,
             B, KV, QG, hd, ps, P, G, int(window),
             1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream,
             ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err} "
                           f"(B={B} KV={KV} QG={QG} hd={hd} ps={ps})")
    paged_attention.launches += 1
    paged_attention.launches_tc += variant.value == 1
    paged_attention.launches_split += variant.value == 2
    paged_attention.launches_verify += variant.value == 3
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
    `paged_attention.launches_verify`, `paged_attention.launches_tc` or
    `paged_attention.launches_split` too when it took the verify, the
    tensor-core or the split route; the CUDA-core kernel has no counter of
    its own); CPU tensors run `paged_attention_plain`."""
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
paged_attention.launches_verify = 0


# the JAX package's self-test cases, (B, KV, G, hd, page_size, P, window,
# q_span): decode, q_span 3 and 4, windows 0 and 16
SELFTEST_CASES = [(3, 2, 4, 32, 8, 4, 0, 1), (2, 1, 8, 64, 16, 3, 0, 1),
                  (4, 2, 2, 32, 8, 8, 16, 1), (3, 2, 4, 32, 8, 4, 0, 3),
                  (2, 2, 2, 32, 8, 6, 16, 4)]


def _counts():
    f = paged_attention
    return (f.launches, f.launches_verify, f.launches_tc, f.launches_split)


def _selftest(device: str) -> None:
    """The JAX package's self-test (`repro.kernels.paged_attention`), its
    numpy draws in its order: shuffled block tables, an inactive row in
    decode.  On a card each case runs through the kernel against the plain
    version, at 2e-5 in fp32 and again at 2e-2 in bf16, on the route
    `route` names; on the CPU the wrapper (the plain version) and each
    route's arithmetic (`paged_attention_split_plain` at SPLIT_KEYS and at
    VERIFY_KEYS) run against `paged_attention_plain` at 2e-5.
    Raises on the first miss."""
    import numpy as np
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("paged_attention selftest: no CUDA device; pass "
                         "--device cpu for the plain versions")
    rng = np.random.default_rng(0)
    for (B, KV, G, hd, ps, P, win, Q) in SELFTEST_CASES:
        N = B * P + 1
        q, kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((B, KV, Q * G, hd), (N, ps, KV, hd),
                                       (N, ps, KV, hd)))
        lengths = rng.integers(Q, P * ps + 1, size=B)
        if Q == 1:
            lengths[rng.integers(B)] = 0  # an inactive row
        perm = rng.permutation(np.arange(1, N))  # pages shuffled
        table = np.full((B, P), -1, np.int32)
        used = 0
        for b in range(B):
            n = -(-int(lengths[b]) // ps)
            table[b, :n] = perm[used: used + n]
            used += n
        tbl = torch.from_numpy(table).to(dev)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        kw = dict(window=win, q_span=Q)
        runs = []
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            if dev.type == "cpu" and dtype == torch.bfloat16:
                continue
            args = [t.to(dev, dtype) for t in (q, kp, vp)] + [tbl, lens]
            want = paged_attention_plain(*args, **kw).float()
            if dev.type == "cpu":
                got = {"wrapper": paged_attention(*args, **kw)}
                for name, keys in (("split", SPLIT_KEYS),
                                   ("verify", VERIFY_KEYS)):
                    got[name] = paged_attention_split_plain(
                        *args, split_keys=keys, **kw)
            else:
                before = _counts()
                out = paged_attention(*args, **kw)
                torch.cuda.synchronize()
                d = [a - b for a, b in zip(_counts(), before)]
                took = {(1, 1, 0, 0): "verify", (1, 0, 1, 0): "tc",
                        (1, 0, 0, 1): "split",
                        (1, 0, 0, 0): "cuda_core"}.get(tuple(d), str(d))
                want_route = route(dtype, Q * G, G, hd)
                if took != want_route:
                    raise AssertionError(
                        f"paged_attention case {(B, KV, G, hd, ps, P, win, Q)}"
                        f" {dtype}: took {took}, the rule names {want_route}")
                got = {took: out}
            for name, out in got.items():
                err = float((out.float() - want).abs().max())
                if not err <= tol:
                    raise AssertionError(
                        f"paged_attention case {(B, KV, G, hd, ps, P, win, Q)}"
                        f" {dtype} ({name}): max abs err {err} > {tol}")
                runs.append(f"{str(dtype)[6:]} {name} {err:.2e}")
        print(f"paged_attention parity OK ({dev.type}): B={B} KV={KV} G={G} "
              f"hd={hd} ps={ps} P={P} window={win} q_span={Q} "
              f"lengths={lengths.tolist()}: {', '.join(runs)}", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    if a.selftest:
        _selftest(a.device)
