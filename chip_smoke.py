"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build    — compile every CUDA kernel of the port from the sources in
              this checkout (one nvcc per source, all at once):
              paged_attention, scd, chunk_reduce and flash_attention; count
              each library's tensor-core instructions (HGMMA, HMMA) in its
              SASS (`cuobjdump -sass`): the two attention libraries must
              have some.
2. kernels  — each kernel against its plain PyTorch version on the card.
              paged_attention: the JAX kernel's self-test cases plus the
              full-width h2o-danube-1.8b shapes (decode, a 256-token
              prefill chunk and the speculative verify span of spec_k 4:
              q_span 5, 20 rows), two more spans of >= 16 rows (the
              tensor-core kernel) and the split route's edge cases
              (length 0, shorter than one run of keys, exactly P * ps, a
              window starting inside a run, q_span 3 and 4) and the
              full-width verify span at the ladder's spec_shrink (spec_k
              2: q_span 3, 12 rows), fp32 at 2e-5
              (TF32 off) and bf16 at 2e-2; every launch must take the
              route the launcher's rule names; the split route gives
              bitwise-equal outputs on two calls.
              scd: the JAX kernel test's shapes (K <= 4, M in {16, 64},
              F in {8, 32}, masked tails), the CoCoA path's shapes at
              K=16, F in {28, 256} with M cut to 4,096, a long chain
              (K=2, M=32,768, F=28), and the one-warp kernel at narrow
              rows (F=30; F=28 with x 4 bytes off alignment), fp32 at
              rtol/atol 1e-5; every launch the launcher's rule sends to
              the blocked kernel (F <= 64, F % 4 == 0, x 16-byte aligned)
              must take it, no other.  weighted_merge: K in 1..16, N in {7, 5001, 5002,
              5003, 4,100, 276,266, 276,267} (every row-alignment class),
              f32 at 1e-5 and bf16 at 3e-2.  flash_attention: the JAX
              kernel test's cases, its model-layout wrapper case and
              h2o-danube-1.8b's head geometry (KV=8, G=4, hd=80) at
              windows 0, 1024 and 4096 up to S=4096, plus a bidirectional
              case, fp32 at 2e-5 and bf16 at 2e-2.
3. engine   — the port's ServeEngine at full h2o-danube-1.8b width, bf16,
              random weights from a seed, through the kernel: 8 burst
              requests of 32-1536 prompt tokens (chunked prefill for the
              long ones), 32 new tokens each, scale events k 1 -> 2 -> 1.
              Launch counts are zeroed just before and read just after;
              every launch of >= 16 rows (the prefill chunks) must have
              taken the tensor-core kernel and every decode launch (G
              rows) the split route.
   profile  — the same run again under torch.profiler: device busy time,
              idle share, the largest kernels and the time of each
              paged-attention kernel (tensor-core chunk, split decode).
4. spec     — speculative decoding (spec="ngram", spec_k 4) on the
              paged layout through the kernel at full h2o-danube-1.8b width,
              bf16: 8 requests of motif-tiled (repetitive) prompts of
              32-1536 tokens, 32 new tokens each; every verify launch (20
              rows) must take the tensor-core kernel, verify launches
              must equal layers x verify dispatches, all launches layers
              x dispatches, and every request must finish.
              Acceptance rate, tokens per dispatch, tokens/s, TTFT, TPOT,
              beside the same workload with speculation off (the bf16
              streams' first divergence and its top-2 margin, reported,
              not gated); then the spec run again under torch.profiler.
   faults   — crash recovery and overload control at the same width
              (paged, kernel, two workers).  (a) fp32 (TF32 off): the
              engine burst with a crash while long prompts are mid-
              chunked-prefill, a straggler set and cleared, and a crash
              mid-decode; every stream must equal the fault-free fp32
              kernel stream, 2 crashes, 2 recoveries, nothing shed.  (b)
              fp32 on the tick clock (one tick one second): 24
              motif-tiled requests, 4 a tick from 3 tenants, spec ngram
              k 4, the auto brownout ladder, a circuit breaker, SLO
              targets, a bounded queue, a token bucket and a 3-crash
              storm, through the kernel and through the gather path:
              equal streams, states and event lists; finished streams
              equal spec-off's; the ladder reaches spec_off and returns
              to 0; verify launches of q_span 5 and 3 (20 and 12 rows)
              equal layers x the verify dispatches at levels 0 and 1.
              (c) the same in bf16 on the real clock: tokens/s, goodput,
              TTFT, TPOT, rejected, shed, recovery ticks, the highest
              brownout level (reported), every launch on its route; then
              its first 32 ticks again under torch.profiler.
   streams  — the engine workload in fp32 through the kernel and through
              the gather path must give equal token streams, and so must
              speculative decoding through the kernel (the verify spans on
              the CUDA-core kernel) and the flat KV layout; the spec
              phase's repetitive burst in fp32 through the kernel, spec on
              and off, must too, with some drafts rejected (rollback and
              re-verify over rows that rejected drafts wrote); and a smoke
              size engine on the card must match the same engine on the
              CPU.
   flat     — the flat KV layout at full width, bf16: h2o-danube-1.8b and
              smollm-360m (15 heads over 5 KV heads, the flat head layout)
              on the engine workload, every request finishing (each
              after a warm-up run, then again under torch.profiler,
              device activity only); then
              spec="draft" on the flat layout with a 4-layer
              h2o-danube-1.8b drafting for itself (draft params = the
              target's).
5. cocoa    — the paper's GLM at HIGGS's shape: CoCoA/SCD on the uni-task
              engine over 11,000,000 x 28 synthetic samples in 1,100
              chunks, lambda 1e-3, scaling in 16 -> 2 over 12 iterations
              through the SCD kernel, every launch on the blocked kernel;
              then 6 iterations with RebalancePolicy, 4 of 16 workers at
              twice the per-sample time.  Gap, K, wall and kernel time per
              iteration.
6. lsgd     — the paper's CNN at CIFAR-10's shape: local SGD (L=8, H=16,
              momentum 0.9, lr 1e-4 sqrt(K)) over 50,000 synthetic 32x32x3
              images in chunks of 50, K 16 -> 8 -> 16, 24 iterations
              through the weighted-merge kernel; loss, accuracy (every 8)
              and wall time per iteration.
7. flash    — the flash kernel's path, its entry point
              ops.flash_attention at h2o-danube-1.8b's full attention
              shape (B=4, S=4096, KV=8, G=4, hd=80, bf16, causal, window
              4096), held to the port's blocked_attention on the same
              q/k/v at 2e-2 (1 + |b|), to the plain version at 2e-2, and
              within one bf16 ulp of the plain version on the fp32-cast
              inputs (|a - b| <= 2^-7 |b| + 1e-5); its one launch must
              be a tensor-core one; the kernel at the same shape in fp32
              against the plain version at 2e-5; then its time, its plain
              version's, its bound and scaled_dot_product_attention's, in
              bf16 and in fp32.
8. lm_train — the LM trainer `launch.train.train` on h2o-danube-1.8b at
              the 100m preset: 20 steps, workers 4 -> 2 at step 4,
              rebalancing, 2 of 4 workers at twice the per-sample time.
9. lm_elastic — ElasticTrainer on h2o-danube-1.8b at full width and depth
              (bf16, sgdm, remat) on batches of 8 x 4096 tokens from
              ChunkBatchPipeline: 4 steps, K 4 -> 2 at step 2, suspended
              to the host after step 2 and resumed (the state must come
              back bit for bit); then, under deterministic algorithms, a
              suspended run against an uninterrupted one (bit-equal).
10. timing  — each kernel, its plain version, its bound and its library
              yardstick at the main path's shapes (the paged shapes also
              held within one bf16 ulp of the fp32 plain result; their
              times are profiler device time, since CUDA events over
              back-to-back calls of the split route measure the host),
              then the `kernels` line.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or outside
a checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; bf16 TC
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH = "h2o-danube-1.8b"
DEVICE = "cuda"
ENGINE = dict(capacity=8, page_size=16, cache_len=2048, prefill_bucket=64,
              prefill_chunk=256, kv_layout="paged")
PROMPT_LEN = (32, 1536)  # the serving workloads' prompt lengths (8 x 32 new)
FLAT = dict(capacity=8, cache_len=2048, prefill_bucket=64, kv_layout="flat")
SPEC_K = 4  # the JAX engine's default draft depth
FLAT_ARCH = "smollm-360m"
DRAFT_LAYERS = 4  # depth of the draft arm's target (and draft) model
# the faults phase: (a) crash recovery on the engine burst over two
# workers: a crash while the first long prompts are mid-chunked-prefill on
# worker 1, a straggler (worker 0 at 2x) set and cleared, then a crash of
# the last worker mid-decode; (b)/(c) overload control on a repetitive
# burst of 28 requests, 6 arriving a tick, half of them from tenant t0
# (whose token bucket, 2 a second, refuses some), with a 3-crash storm
# that trips the circuit breaker: fresh admissions pause, the queue and
# the crash victims back up past twice the slots, the brownout ladder
# (one hot tick a step up, two cool ticks a step down, capped at
# spec_off: chunk_cap's one-page chunks would stretch the long prompts'
# prefill past the TTFT target) climbs, then walks back to level 0 as
# the queue drains.
# The SLO targets (ticks) are met by every finish, so the queue alone
# drives the ladder and its way down is not held by a missed target.
FAULT_WORKERS = 2
CRASH_PLAN = dict(prefill_crash=1, slow=(3, 0, 2.0), clear=(6, 0),
                  decode_crash=14)
OVERLOAD = dict(n=28, per_tick=6, storm_at=3, storm_n=3, storm_every=2,
                slo_ttft=100.0, slo_tpot=4.0, queue_cap=20,
                tenant_rate=2.0, tenant_burst=2.0, max_ticks=400,
                ladder=dict(up_patience=1, down_patience=2, max_level=2))
# (c) on the real clock, where a tick takes tens of ms: the SLO targets in
# seconds, and t0's bucket refilled at 20 a second (its burst of 2 stays,
# so it refuses part of t0's 3 a tick)
OVERLOAD_WALL = dict(slo_ttft=3.0, slo_tpot=0.1, tenant_rate=20.0,
                     tenant_burst=2.0)
PROFILE_TICKS = 32  # (c)'s profiled window: the storm and the breaker
# training path (phases cocoa and lsgd)
COCOA = dict(n=11_000_000, features=28, chunk_size=10_000, lam=1e-3, k0=16,
             iters=12, rebalance_iters=6)
LSGD = dict(n_train=50_000, n_test=10_000, image_size=32, chunk_size=50,
            k0=16, iters=24, eval_every=8)
SLOW = [2.0] * 4 + [1.0] * 12  # per-sample times: 4 of 16 workers at 2x
SCD_PATH_M = 4096  # the plain version steps M times from Python
TOL_SCD = 1e-5
TOL_MERGE = {"float32": 1e-5, "bfloat16": 3e-2}
# the chain model of the blocked SCD kernel (F <= 64, the path's F=28): per
# step the q update (FFMA), grad (FFMA), the quotient (FMUL and two FFMA),
# the clip (FADD.SAT), a_new - alpha (FADD), s (FMUL), then the broadcast
# (SHFL.IDX).  Latencies measured with clock64 on one warp by
# scripts/scd_chain_probe.py on an H100 80GB HBM3 (PERF.md): FMA-class
# 4.25 cycles, SHFL.IDX 25.5 (assumed before they were measured: 4 and
# 23); the step alone measured 57.6.  The one-warp kernel's model was
# 5 * (23 + 4) + 20 * 4 = 215 cycles a step (its measured rate: ~445)
SCD_CHAIN_CYCLES = 8 * 4.25 + 25.5
SCD_LONG = (2, 32_768, 28)  # a long chain at the path's width
SELFTEST_CASES = [(3, 2, 4, 32, 8, 4, 0, 1), (2, 1, 8, 64, 16, 3, 0, 1),
                  (4, 2, 2, 32, 8, 8, 16, 1), (3, 2, 4, 32, 8, 4, 0, 3),
                  (2, 2, 2, 32, 8, 6, 16, 4)]
# spans of >= 16 rows at other head dims and windows (bf16: the
# tensor-core kernel): QG 16 at hd 64 with a window, QG 64 at hd 128
TC_PAGED_CASES = [(3, 2, 4, 64, 16, 8, 40, 4), (2, 2, 1, 128, 16, 8, 0, 64)]
# spans of <= 16 rows with their lengths (the split route, runs of 64
# keys): length 0, shorter than a run, one run, exactly P * ps; a window
# starting inside a run; q_span 3 (12 rows) and 4 (16 rows at hd 32)
SPLIT_PAGED_CASES = [((4, 2, 4, 80, 16, 8, 0, 1), [0, 5, 64, 128]),
                     ((3, 2, 4, 80, 16, 16, 40, 1), [200, 77, 256]),
                     ((3, 2, 4, 64, 16, 8, 0, 3), [3, 70, 128]),
                     ((2, 2, 4, 32, 8, 20, 24, 4), [9, 160])]
PAGED_TC_DIMS = (64, 80, 128)  # head dims of the paged tensor-core kernel
# one bf16 ulp (8 significant bits) of the fp32 result, and an absolute
# floor for outputs near zero
ULP_REL, ULP_ABS = 2.0 ** -7, 1e-5
# flash attention (B, S, KV, G, hd, window, causal): tests/test_kernels.py's
# FLASH_CASES, then h2o-danube-1.8b's head geometry, then a bidirectional
# window, then a tile shorter than the CUDA-core kernel's 16 thread-rows,
# then hd 40 (bf16 on the CUDA cores); each in fp32 and bf16 (bf16 with hd
# 32, 64 or 80 on the tensor cores)
FLASH_CASES = [(2, 128, 2, 2, 64, 0, True), (1, 256, 1, 4, 32, 0, True),
               (2, 128, 3, 1, 64, 32, True), (1, 128, 2, 1, 64, 0, False),
               (1, 128, 2, 2, 64, 64, True), (1, 4096, 8, 4, 80, 0, True),
               (1, 4096, 8, 4, 80, 1024, True),
               (1, 4096, 8, 4, 80, 4096, True),
               (1, 1024, 8, 4, 80, 256, False), (2, 8, 2, 1, 32, 0, True),
               (1, 256, 2, 4, 40, 0, True)]
FLASH_PATH = dict(B=4, S=4096)  # with h2o-danube-1.8b's KV, G, hd, window
# LM training (phases lm_train and lm_elastic)
LM_TRAIN = dict(scale="100m", train_steps=20, elastic="4:2", rebalance=True,
                hetero="2.0x2", workers=4, seed=0)
LM_ELASTIC = dict(batch=8, seq=4096, n_seqs=256, chunk_size=8, k0=4,
                  scale_at=2, k1=2, steps=4, suspend_after=2, det_steps=2)


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def one_ulp_excess(got, want) -> float:
    """max of |got - want| - (2^-7 |want| + 1e-5): <= 0 when every element
    of the bf16 `got` is within one ulp of the fp32 `want`."""
    want = want.float()
    return float(((got.float() - want).abs()
                  - (ULP_REL * want.abs() + ULP_ABS)).max())


def sass_counts(lib: Path) -> dict:
    """Tensor-core instructions in a built library's SASS."""
    from repro_torch.kernels.build import find_nvcc
    import re
    sass = subprocess.run(
        [str(Path(find_nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("HGMMA", "HMMA")}


def paged_route(dtype_name, rows, hd) -> str:
    """The paged launcher's rule: "tc" for bf16 spans of >= 16 rows at a
    head dim the tensor-core kernel is built for, "split" for every other
    span of <= 16 rows, "cuda_core" for the rest."""
    if dtype_name == "bfloat16" and rows >= 16 and hd in PAGED_TC_DIMS:
        return "tc"
    return "split" if rows <= 16 else "cuda_core"


def paged_counts(counted):
    return (counted.launches, counted.launches_tc, counted.launches_split)


def took(before, after) -> str:
    """The route of the one launch between two `paged_counts`."""
    d = [a - b for a, b in zip(after, before)]
    if d[0] != 1:
        return f"{d[0]} launches"
    return {(0, 0): "cuda_core", (1, 0): "tc", (0, 1): "split"}.get(
        (d[1], d[2]), f"counts {d}")


def record_paged_launches(module):
    """Wrap `module._launch` (what the paged-attention wrapper calls for
    CUDA tensors) so every launch logs (rows QG, the route it took);
    returns the log and a function that restores it."""
    real, counted = module._launch, module.paged_attention
    log = []

    def wrapped(q, *args, **kwargs):
        before = paged_counts(counted)
        out = real(q, *args, **kwargs)
        log.append((q.shape[2], took(before, paged_counts(counted))))
        return out

    module._launch = wrapped
    return log, lambda: setattr(module, "_launch", real)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs for the paged-attention kernel
# ---------------------------------------------------------------------------


def paged_inputs(torch, np, rng, B, KV, G, hd, ps, P, Q, dtype, *,
                 n_pages=None, lengths=None):
    """Shuffled physical pages, -1 past live, one inactive row in decode;
    lengths include the span, whose first query is the contiguous tail."""
    N = n_pages or B * P + 1
    if lengths is None:
        lengths = rng.integers(Q, P * ps + 1, size=B)
        if Q == 1:
            lengths[rng.integers(B)] = 0
    lengths = np.asarray(lengths, np.int32)
    perm = rng.permutation(np.arange(1, N))
    table = np.full((B, P), -1, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = perm[used: used + n]
        used += n
    dev = DEVICE

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return dict(q=randn(B, KV, Q * G, hd), k_pages=randn(N, ps, KV, hd),
                v_pages=randn(N, ps, KV, hd),
                block_table=torch.from_numpy(table).to(dev),
                lengths=torch.from_numpy(lengths).to(dev),
                q_start=torch.from_numpy(lengths - Q).to(dev), q_span=Q)


def call(fn, inp, window):
    return fn(inp["q"], inp["k_pages"], inp["v_pages"], inp["block_table"],
              inp["lengths"], window=window, q_span=inp["q_span"],
              q_start=inp["q_start"])


def work(np, inp, window, itemsize):
    """(bytes, flops) the function needs on these inputs: q, out and the
    table read/written once, the live K/V rows read once; 4*hd flops per
    (row, unmasked key) for QK^T and PV."""
    B, KV, QG, hd = inp["q"].shape
    G = QG // inp["q_span"]
    lengths = inp["lengths"].cpu().numpy().astype(np.int64)
    q_start = inp["q_start"].cpu().numpy().astype(np.int64)
    live = int(lengths.sum())
    nbytes = (2 * B * KV * QG * hd + 2 * live * KV * hd) * itemsize \
        + inp["block_table"].numel() * 4 + 2 * B * 4
    keys = 0
    for b in range(B):
        if lengths[b] <= 0:
            continue
        q_abs = q_start[b] + np.arange(QG) // G
        hi = np.minimum(q_abs, lengths[b] - 1)
        lo = np.maximum(q_abs - window + 1, 0) if window else 0
        keys += int(np.maximum(hi - lo + 1, 0).sum())
    return nbytes, 4 * hd * KV * keys


def library_call(torch, F, window):
    """A gather plus scaled_dot_product_attention over the same work (the
    yardstick; the port never calls it)."""
    def run(q, k_pages, v_pages, block_table, lengths, *, window=window,
            q_span, q_start):
        B, KV, QG, hd = q.shape
        _, ps, _, _ = k_pages.shape
        P = block_table.shape[1]
        tbl = block_table.clamp_min(0).long()
        k = k_pages[tbl].reshape(B, P * ps, KV, hd).transpose(1, 2)
        v = v_pages[tbl].reshape(B, P * ps, KV, hd).transpose(1, 2)
        pos = torch.arange(P * ps, device=q.device)
        q_abs = q_start[:, None] + torch.arange(QG, device=q.device) // (
            QG // q_span)
        ok = (pos[None, None] <= q_abs[..., None]) \
            & (pos[None, None] < lengths[:, None, None])
        if window:
            ok &= (q_abs[..., None] - pos[None, None]) < window
        return F.scaled_dot_product_attention(q, k, v, attn_mask=ok[:, None])
    return run


def time_ms(torch, fn, inputs, window, iters):
    """CUDA-event time per call, rotating over input copies whose pools
    together exceed the L2 cache, so each call reads its pages from HBM."""
    for inp in inputs[:2]:
        call(fn, inp, window)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(fn, inputs[i % len(inputs)], window)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# engine helpers
# ---------------------------------------------------------------------------


def profile_run(torch, run, kernel="paged_attention", attempts=1):
    """Run `run()` under torch.profiler, device activity only; return the
    device-time breakdown: busy seconds (sum of kernel, memcpy and memset
    time on the card), the wall seconds, the idle share, `kernel`'s share
    of the busy time and the largest kernels by time.  The profiler can
    drop a window's device records; a repeatable `run` gets up to
    `attempts` tries until `kernel` shows in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        mine = sum(e.self_device_time_total for e in dev if kernel in e.key)
        if mine > 0 or attempt == attempts:
            break
    if not dev:  # the profiler saw no device activity in this sandbox
        return {"wall_s": wall, "device_busy_s": None,
                "note": "torch.profiler recorded no device events"}
    if mine == 0:  # records dropped: a busy time without the kernel lies
        return {"wall_s": wall, "device_busy_s": None, "attempts": attempt,
                "note": f"torch.profiler dropped this window's records: "
                        f"no {kernel} launch in {attempt} tries"}
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            f"{kernel}_share_of_busy": mine / busy_us,
            f"{kernel}_kernels": [{"name": e.key[:90], "count": e.count,
                                   "total_ms": e.self_device_time_total / 1e3}
                                  for e in dev if kernel in e.key],
            "attempts": attempt,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "total_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def requests(np, synthetic_requests, vocab):
    return synthetic_requests(8, vocab_size=vocab, arrivals=np.zeros(8),
                              prompt_len=PROMPT_LEN, max_new_tokens=(32, 32),
                              rng=np.random.default_rng(0))


def repetitive_requests(np, Request, vocab, n=8, seed=1):
    """Prompts that tile a short random motif (tests/test_spec.py's
    `_repetitive`, prompt lookup's best case) at the engine workload's
    lengths: 32-1536 prompt tokens, 32 new tokens each."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        motif = rng.integers(0, vocab, size=int(rng.integers(3, 5)))
        plen = int(rng.integers(*PROMPT_LEN))
        prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
        reqs.append(Request(rid=i, prompt=prompt.astype(np.int32),
                            max_new_tokens=32))
    return reqs


def streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def first_divergence(torch, np, M, cfg, params, got, want, prompts):
    """None if the two stream dicts are equal; else the first request and
    step where they differ, the two tokens, and the top-2 logit margin of
    `params` after the common prefix (a near-tie shows as a small
    margin)."""
    if got == want:
        return None
    rid = min(r for r in got if got[r] != want[r])
    a, b = got[rid], want[rid]
    step = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                min(len(a), len(b)))
    toks = torch.tensor(np.concatenate([prompts[rid], b[:step]]),
                        device=DEVICE)[None]
    with torch.inference_mode():
        top2 = M.forward(cfg, params, toks)[0, -1].float().topk(2).values
    return {"rid": rid, "step": step,
            "got_token": a[step] if step < len(a) else None,
            "want_token": b[step] if step < len(b) else None,
            "top2_margin": float(top2[0] - top2[1])}


# ---------------------------------------------------------------------------
# training path: the SCD and weighted-merge kernels, CoCoA and local SGD
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, iters=1):
    """CUDA-event time per call of `fn` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device time per call of `fn` from torch.profiler: the time of the
    kernels it launches, without the host's launch gaps (which bound a
    back-to-back loop of a microsecond kernel).  The profiler can drop
    records, so each kernel is averaged over its own recorded launches
    and counted as often per call as it was recorded per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.count]
    if not dev:
        fail("torch.profiler recorded no device time for a kernel timing")
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / iters)) for e in dev) / 1e3


def rotating_device_ms(torch, fn, inputs, window, iters):
    """`device_ms` of `fn` on the paged inputs in rotation (their pools
    together exceed the L2 cache, so each call reads its pages from
    HBM)."""
    it = iter(range(1 << 30))
    return device_ms(torch, lambda: call(
        fn, inputs[next(it) % len(inputs)], window), iters)


def host_profile(torch, run, n=8):
    """Run `run()` under cProfile; the `n` functions with the most host
    time of their own."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # (file, line, fn) -> (cc, nc, tt, ..)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"fn": f"{Path(f).name}:{line}:{fn}", "calls": v[1],
             "own_s": v[2]} for (f, line, fn), v in top]


def kernel_timer(torch, module, name, log):
    """Wrap `module.name` so each call is bracketed by CUDA events appended
    to `log`; returns the original for restoring."""
    real = getattr(module, name)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        log.append((start, end))
        return out

    setattr(module, name, timed)
    return real


def scd_inputs(torch, np, rng, K, M, F, masked, *, unit_rows):
    """float32 SCD inputs on the card; `unit_rows` normalizes the rows as
    `make_svm_data` does (the CoCoA path), else x ~ 0.3 N(0, 1) as in the
    JAX kernel test."""
    x = rng.standard_normal((K, M, F)).astype(np.float32)
    if unit_rows:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    else:
        x *= 0.3
    y = np.where(rng.standard_normal((K, M)) > 0, 1.0, -1.0).astype(
        np.float32)
    alpha = rng.uniform(size=(K, M)).astype(np.float32)
    w = (rng.standard_normal(F) * 0.1).astype(np.float32)
    mask = np.ones((K, M), np.float32)
    if masked:
        mask[:, M - masked:] = 0.0
    return [torch.from_numpy(a).to(DEVICE) for a in (x, y, alpha, w, mask)]


def scd_work(K, M, F):
    """(bytes, flops) of one SCD pass: x, y, alpha, mask, w and sigma read
    once, v_end and da written once; per step 6F flops (dot, |x|^2 and the
    update) and ~12 scalar ones."""
    nbytes = 4 * (K * M * F + 3 * K * M + F + K + K * F + K * M)
    return nbytes, K * M * (6 * F + 12)


def merge_work(K, N, itemsize):
    return K * N * itemsize + 4 * K + N * itemsize, 2 * K * N


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def check_scd(torch, np, scd_pass, scd_pass_plain, takes_blocked):
    """The SCD kernel against its plain version: the JAX test's shapes, the
    CoCoA path's (K=16, F in {28, 256}, M cut to SCD_PATH_M), a long chain
    (SCD_LONG), then two cases of the one-warp kernel at narrow rows: F=30
    (not a multiple of 4) and F=28 with x a view 4 bytes past 16-byte
    alignment.  Each launch `takes_blocked` sends to the blocked kernel
    must take it, and no other."""
    rng = np.random.default_rng(1)
    cases = [(k, m, f, int(rng.integers(0, 6)), False, 10.0, False)
             for k in (1, 2, 3, 4) for m in (16, 64) for f in (8, 32)]
    lam_n = float(np.float32(COCOA["lam"]) * np.float32(COCOA["n"]))
    cases += [(16, SCD_PATH_M, f, 7, True, lam_n, False) for f in (28, 256)]
    cases += [(*SCD_LONG, 0, True, lam_n, False),
              (16, SCD_PATH_M, 30, 7, True, lam_n, False),
              (16, SCD_PATH_M, 28, 7, True, lam_n, True)]
    worst, out = 0.0, []
    for K, M, F, masked, unit_rows, ln, offset in cases:
        x, y, alpha, w, mask = scd_inputs(torch, np, rng, K, M, F, masked,
                                          unit_rows=unit_rows)
        if offset:  # the same rows at a base 4 bytes past alignment
            flat = torch.empty(x.numel() + 1, device=DEVICE)
            flat[1:] = x.flatten()
            x = flat[1:].view(K, M, F)
        sigma = torch.full((K,), float(K), device=DEVICE)
        n_blocked = scd_pass.launches_blocked
        got = scd_pass(x, y, alpha, w, mask, ln, sigma)
        torch.cuda.synchronize()
        blocked = scd_pass.launches_blocked - n_blocked
        if blocked != takes_blocked(F, aligned=x.data_ptr() % 16 == 0):
            fail(f"scd case K={K} M={M} F={F} offset={offset}: {blocked} "
                 f"blocked launches")
        want = scd_pass_plain(x, y, alpha, w, mask, ln, sigma)
        err = 0.0
        for g, t in zip(got, want):
            err = max(err, float((g - t).abs().max()))
            excess = float(((g - t).abs() - TOL_SCD * t.abs()).max())
            if not math.isfinite(excess) or excess > TOL_SCD:
                fail(f"scd case K={K} M={M} F={F}: max abs err {err}")
        if masked and bool((got[1][:, M - masked:] != 0).any()):
            fail(f"scd case K={K} M={M} F={F}: masked rows moved")
        out.append({"K": K, "M": M, "F": F, "masked": masked,
                    "x_offset_bytes": 4 * offset, "blocked": blocked,
                    "max_abs_err": err})
        worst = max(worst, err)
    return worst, out


def check_merge(torch, weighted_merge, weighted_merge_plain):
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    worst = {}
    for dtype_name, tol in TOL_MERGE.items():
        dtype = getattr(torch, dtype_name)
        err = 0.0
        for K in range(1, 17):
            for N in (7, 5001, 5002, 5003, 4_100, 276_266, 276_267):
                u = torch.randn(K, N, device=DEVICE, generator=gen).to(dtype)
                w = torch.rand(K, device=DEVICE, generator=gen)
                got = weighted_merge(u, w)
                torch.cuda.synchronize()
                want = weighted_merge_plain(u, w)
                if got.dtype != dtype or got.shape != (N,):
                    fail(f"weighted_merge K={K} N={N}: {got.dtype} "
                         f"{tuple(got.shape)}")
                e = (got.float() - want.float()).abs()
                if float((e - tol * want.float().abs()).max()) > tol:
                    fail(f"weighted_merge {dtype_name} K={K} N={N}: max abs "
                         f"err {float(e.max())}")
                err = max(err, float(e.max()))
        worst[dtype_name] = err
    return worst


def cocoa_phase(torch, np):
    """CoCoA/SCD at HIGGS's shape through the kernel: a 16 -> 2 scale-in,
    then a rebalancing run with 4 slow workers."""
    from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                                  ElasticScalingPolicy, RebalancePolicy,
                                  ScaleEvent, UniTaskEngine)
    from repro_torch.data import make_svm_data
    from repro_torch.kernels import ops
    from repro_torch.kernels.scd import scd_pass
    c = COCOA
    t0 = time.perf_counter()
    x, y = make_svm_data(c["n"], c["features"], seed=0)
    data_s = time.perf_counter() - t0
    k0 = c["k0"]
    unit = c["n"] // k0  # one K=16 full pass in sample-units of sim time
    runs = {
        # examples/cocoa_svm.py's schedule, 2 workers every 2 time units,
        # one unit being one K=16 iteration of simulated time
        "scale_in": ([ElasticScalingPolicy(
            [ScaleEvent(2 * i * unit, max(k0 - 2 * i, 2))
             for i in range(8)])], lambda w: 1.0, c["iters"]),
        # examples/load_balancing.py's policy and slow nodes
        "rebalance": ([RebalancePolicy(window=2, max_moves_per_gap=24)],
                      lambda w: SLOW[w % len(SLOW)], c["rebalance_iters"]),
    }
    results = {}
    for name, (policies, node_pst, iters) in runs.items():
        store = ChunkStore({"x": x, "y": y}, chunk_size=c["chunk_size"])
        a = Assignment(store.n_chunks, k0, np.random.default_rng(0))
        solver = CoCoASolver(store, lam=c["lam"], device=DEVICE)
        eng = UniTaskEngine(store, a, policies, node_pst=node_pst,
                            balance_processing=False)
        log, rows = [], []

        def step(s, asg, sh, solver=solver, log=log, rows=rows,
                 store=store):
            t = time.perf_counter()
            out = solver.step(s, asg, sh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ids = sorted(cid for w in asg.workers for cid in w)
            if ids != list(range(store.n_chunks)):
                fail(f"cocoa {name}: chunks not conserved")
            nnz = int(np.count_nonzero(store.state["alpha"]))
            if rows and nnz < rows[-1]["alpha_nonzero"] // 2:
                fail(f"cocoa {name}: alpha was reset ({nnz} nonzero after "
                     f"{rows[-1]['alpha_nonzero']})")
            rows.append({"K": asg.n_workers,
                         "M": int(out["per_worker_samples"].max()),
                         "wall_s": wall,
                         "kernel_ms": log[-1][0].elapsed_time(log[-1][1]),
                         "alpha_nonzero": nnz})
            return out

        real = kernel_timer(torch, ops, "scd_local_pass", log)
        try:
            scd_pass.launches = scd_pass.launches_blocked = 0
            t0 = time.perf_counter()
            hist = eng.run(iters, step, solver.metric)
            run_s = time.perf_counter() - t0
            launches = scd_pass.launches
            blocked = scd_pass.launches_blocked
        finally:
            ops.scd_local_pass = real
        for r, h in zip(rows, hist):
            r["gap"] = h.metric
            r["max_task_time"] = max(h.task_times.values())
        gaps = [h.metric for h in hist]
        if not all(math.isfinite(g) for g in gaps) or gaps[-1] >= gaps[0]:
            fail(f"cocoa {name}: the duality gap did not fall: {gaps}")
        if launches != iters or blocked != launches:
            fail(f"cocoa {name}: {launches} scd launches in {iters} "
                 f"iterations, {blocked} of them on the blocked kernel")
        if name == "scale_in" and hist[-1].n_workers != 2:
            fail(f"cocoa scale_in ended at K={hist[-1].n_workers}")
        if name == "rebalance" and \
                rows[-1]["max_task_time"] >= rows[0]["max_task_time"]:
            fail("cocoa rebalance: the max task time did not fall")
        results[name] = {"launches": launches, "launches_blocked": blocked,
                         "run_s": run_s, "iterations": rows}
        if name == "rebalance":  # one more K=16 iteration, profiled
            emit({"phase": "profile", "cell": "cocoa", "K": a.n_workers,
                  **profile_run(torch, lambda: solver.step(store, a),
                                kernel="scd_blocked_kernel", attempts=3),
                  "host_top": host_profile(
                      torch, lambda: solver.step(store, a))})
        emit({"phase": "cocoa", "run": name, "n": c["n"],
              "features": c["features"], "chunks": store.n_chunks,
              "lam": c["lam"], "data_s": data_s, "run_s": run_s,
              "scd_launches": launches, "scd_launches_blocked": blocked,
              "kernel_ms_total": sum(r["kernel_ms"] for r in rows),
              "iterations": rows,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del solver, eng, store
        torch.cuda.empty_cache()
    return results


def lsgd_phase(torch, np):
    """Local SGD on the paper's CNN at CIFAR-10's shape through the merge
    kernel, K 16 -> 8 -> 16."""
    from repro_torch.configs.chicle_paper import PAPER_LSGD, CNNConfig
    from repro_torch.core import (Assignment, ChunkStore,
                                  ElasticScalingPolicy, LocalSGDSolver,
                                  ScaleEvent, UniTaskEngine)
    from repro_torch.core.nets import cnn_apply, cnn_init, loss_per_sample
    from repro_torch.data import make_images
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunk_reduce import weighted_merge
    c = LSGD
    cfg = dataclasses.replace(CNNConfig(), image_size=c["image_size"])
    t0 = time.perf_counter()
    xtr, ytr = make_images(c["n_train"], cfg.image_size, cfg.channels,
                           cfg.num_classes, seed=0, noise=1.5)
    xte, yte = make_images(c["n_test"], cfg.image_size, cfg.channels,
                           cfg.num_classes, seed=1, noise=1.5)
    data_s = time.perf_counter() - t0
    params = cnn_init(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(v.numel() for v in params.values())
    store = ChunkStore({"x": xtr, "y": ytr}, chunk_size=c["chunk_size"])
    k0 = c["k0"]
    a = Assignment(store.n_chunks, k0, np.random.default_rng(0))
    unit = PAPER_LSGD.local_steps * PAPER_LSGD.local_batch  # per iteration
    pol = ElasticScalingPolicy([ScaleEvent(0, k0),
                                ScaleEvent(8 * unit, k0 // 2),
                                ScaleEvent(16 * unit, k0)])
    solver = LocalSGDSolver(params, cnn_apply, loss_per_sample, PAPER_LSGD,
                            eval_data=xte, eval_labels=yte, seed=0,
                            device=DEVICE)
    eng = UniTaskEngine(store, a, [pol])
    data = torch.from_numpy(xtr).to(DEVICE)
    labels = torch.from_numpy(ytr).to(DEVICE)
    log, rows = [], []

    def step(s, asg, sh):
        t = time.perf_counter()
        out = solver.step(s, asg, data, labels, sh)
        torch.cuda.synchronize()
        rows.append({"K": asg.n_workers, "loss": out["loss"],
                     "wall_s": time.perf_counter() - t,
                     "merge_ms": log[-1][0].elapsed_time(log[-1][1])})
        return out

    real = kernel_timer(torch, ops, "merge_updates", log)
    try:
        weighted_merge.launches = 0
        t0 = time.perf_counter()
        hist = eng.run(c["iters"], step, solver.metric,
                       eval_every=c["eval_every"])
        run_s = time.perf_counter() - t0
        launches = weighted_merge.launches
    finally:
        ops.merge_updates = real
    for r, h in zip(rows, hist):
        r["accuracy"] = h.metric
    emit({"phase": "profile", "cell": "lsgd", "K": a.n_workers,
          **profile_run(torch, lambda: solver.step(store, a, data, labels),
                        kernel="merge_kernel", attempts=3)})
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        fail(f"lsgd: non-finite loss {losses}")
    if launches != c["iters"]:
        fail(f"lsgd: {launches} merge launches in {c['iters']} iterations")
    ks = [r["K"] for r in rows]
    if k0 // 2 not in ks or ks[-1] != k0:
        fail(f"lsgd: K path {ks} is not {k0} -> {k0 // 2} -> {k0}")
    emit({"phase": "lsgd", "n_train": c["n_train"], "n_test": c["n_test"],
          "image_size": cfg.image_size, "params": n_params,
          "chunk_size": c["chunk_size"], "local_batch":
          PAPER_LSGD.local_batch, "local_steps": PAPER_LSGD.local_steps,
          "data_s": data_s, "run_s": run_s, "merge_launches": launches,
          "epochs": hist[-1].epoch, "iterations": rows,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"launches": launches, "n_params": n_params, "run_s": run_s}


def training_timing(torch, np, scd_pass, scd_pass_plain, weighted_merge,
                    weighted_merge_plain):
    """Kernel, plain version, bound and yardstick for the SCD and merge
    kernels at the training path's shapes."""
    out = {}
    rng = np.random.default_rng(3)
    lam_n = float(np.float32(COCOA["lam"]) * np.float32(COCOA["n"]))
    clock = sm_clock_hz()
    # SCD at K=16, F=28 with M cut for the plain version, then the kernel
    # alone at the path's full passes (K=16 and K=2)
    K, F = COCOA["k0"], COCOA["features"]
    x, y, alpha, w, mask = scd_inputs(torch, np, rng, K, SCD_PATH_M, F, 0,
                                      unit_rows=True)
    sigma = torch.full((K,), float(K), device=DEVICE)
    args = (x, y, alpha, w, mask, lam_n, sigma)
    plain1 = cuda_ms(torch, lambda: scd_pass_plain(*args))
    kern1 = cuda_ms(torch, lambda: scd_pass(*args), iters=20)
    kern2 = cuda_ms(torch, lambda: scd_pass(*args), iters=20)
    plain2 = cuda_ms(torch, lambda: scd_pass_plain(*args))
    b_ms, b_by = bound(*scd_work(K, SCD_PATH_M, F))
    scd = {"shape": {"K": K, "M": SCD_PATH_M, "F": F},
           "ms": min(kern1, kern2), "ms_runs": [kern1, kern2],
           "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1,
                                                              plain2],
           "bound_ms": b_ms, "bound_by": b_by,
           "chain_bound_ms": SCD_CHAIN_CYCLES * SCD_PATH_M / clock * 1e3,
           "library_ms": None, "path": []}
    del x, y, alpha, mask
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    for Kp in (COCOA["k0"], 2):
        M = COCOA["n"] // Kp
        x = torch.randn(Kp, M, F, device=DEVICE, generator=gen)
        x /= x.norm(dim=-1, keepdim=True)
        y = torch.where(torch.rand(Kp, M, device=DEVICE, generator=gen)
                        > 0.5, 1.0, -1.0)
        alpha = torch.zeros(Kp, M, device=DEVICE)
        mask = torch.ones(Kp, M, device=DEVICE)
        sigma = torch.full((Kp,), float(Kp), device=DEVICE)
        ms = cuda_ms(torch, lambda: scd_pass(x, y, alpha, w, mask, lam_n,
                                             sigma))
        b_ms, b_by = bound(*scd_work(Kp, M, F))
        scd["path"].append({"K": Kp, "M": M, "F": F, "ms": ms,
                            "ns_per_step": ms * 1e6 / M,
                            "cycles_per_step": ms * 1e-3 * clock / M,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "chain_bound_ms": SCD_CHAIN_CYCLES * M / clock
                            * 1e3})
        del x, y, alpha, mask
        torch.cuda.empty_cache()
    scd["sm_clock_mhz"] = clock / 1e6
    scd["chain_cycles_per_step_model"] = SCD_CHAIN_CYCLES
    out["scd"] = scd
    # merge: the lSGD path's (16, 276,266) fp32 deltas, then a large N;
    # input copies rotate past the 50 MB L2 so reads come from HBM
    merge = {}
    for label, (K, N) in (("path", (LSGD["k0"], 276_266)),
                          ("large", (16, 1 << 24))):
        n_rot = max(1, -(-200_000_000 // (K * N * 4)))
        rot = [(torch.randn(K, N, device=DEVICE, generator=gen),
                torch.rand(K, device=DEVICE, generator=gen))
               for _ in range(n_rot)]
        it = [0]

        def nxt():
            it[0] += 1
            return rot[it[0] % len(rot)]

        def plain():
            return weighted_merge_plain(*nxt())

        def kern():
            return weighted_merge(*nxt())

        def lib():
            u, w = nxt()
            return w @ u

        iters = 50
        # device time per call (the kernels alone), in turns
        runs = [device_ms(torch, f, iters)
                for f in (plain, kern, kern, plain)]
        b_ms, b_by = bound(*merge_work(K, N, 4))
        merge[label] = {"shape": {"K": K, "N": N, "dtype": "float32"},
                        "ms": min(runs[1:3]), "ms_runs": runs[1:3],
                        "plain_ms": min(runs[0], runs[3]),
                        "plain_ms_runs": [runs[0], runs[3]],
                        "library_ms": device_ms(torch, lib, iters),
                        "bound_ms": b_ms, "bound_by": b_by,
                        # CUDA events over back-to-back calls: bounded by
                        # the host's launch rate at the path's small N
                        "events_ms": {"kernel": cuda_ms(torch, kern, iters),
                                      "plain": cuda_ms(torch, plain, iters),
                                      "library": cuda_ms(torch, lib, iters)}}
        del rot
        torch.cuda.empty_cache()
    out["weighted_merge"] = merge
    return out


# ---------------------------------------------------------------------------
# flash attention: kernel checks, the entry point at full width, timing
# ---------------------------------------------------------------------------


def flash_inputs(torch, gen, B, S, KV, G, hd, dtype):
    """q (B*KV*G, S, hd), k/v (B*KV, S, hd) on the card, N(0, 1)."""
    def randn(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)
    return (randn(B * KV * G, S, hd), randn(B * KV, S, hd),
            randn(B * KV, S, hd))


def check_flash(torch, flash_attention, flash_attention_plain, ops):
    """The flash kernel against its plain version on FLASH_CASES in fp32
    and bf16, and the model-layout wrapper on the card against the same
    entry point on the CPU (its plain version)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    worst, cases = {}, []
    for dtype_name, tol in TOL.items():
        dtype = getattr(torch, dtype_name)
        err = 0.0
        for case in FLASH_CASES:
            B, S, KV, G, hd, win, causal = case
            q, k, v = flash_inputs(torch, gen, B, S, KV, G, hd, dtype)
            got = flash_attention(q, k, v, causal=causal, window=win,
                                  block_q=64, block_k=64, group_size=G)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=causal, window=win,
                                         group_size=G)
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"flash_attention {case}: {got.dtype} "
                     f"{tuple(got.shape)}")
            e = float((got.float() - want.float()).abs().max())
            cases.append({"dtype": dtype_name, "case": list(case),
                          "max_abs_err": e})
            if not math.isfinite(e) or e > tol:
                fail(f"flash_attention {dtype_name} case {case}: max abs "
                     f"err {e} > {tol}")
            err = max(err, e)
        worst[dtype_name] = err
    # tests/test_kernels.py's model-layout wrapper case
    B, S, KV, G, hd = 2, 128, 2, 3, 32
    q = torch.randn(B, S, KV, G, hd, device=DEVICE, generator=gen)
    k = torch.randn(B, S, KV, hd, device=DEVICE, generator=gen)
    v = torch.randn(B, S, KV, hd, device=DEVICE, generator=gen)
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                               block_q=64, block_k=64)
    e = float((got.cpu() - want).abs().max())
    if not math.isfinite(e) or e > TOL["float32"]:
        fail(f"ops.flash_attention on the card vs the CPU: max abs err {e}")
    worst["float32"] = max(worst["float32"], e)
    cases.append({"dtype": "float32", "case": "ops wrapper (2, 128, 2, 3, "
                  "32), card vs cpu", "max_abs_err": e})
    return worst, cases


def flash_work(np, B, S, H, KV, hd, window, causal, itemsize):
    """(bytes, flops) of one call: q, k and v read once and the output
    written once; 4*hd flops per visible (query, key) pair."""
    p = np.arange(S, dtype=np.int64)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    hi = p if causal else np.full_like(p, S - 1)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (2 * B * H * S * hd + 2 * B * KV * S * hd) * itemsize
    return nbytes, 4 * hd * B * H * pairs


def flash_phase(torch, np, F, cfg, flash_attention, flash_attention_plain):
    """The flash kernel's path: its entry point `ops.flash_attention` at
    h2o-danube-1.8b's full attention shape, held to the port's
    blocked_attention and to the plain version (and, at the same shape in
    fp32, the kernel to the plain version); then kernel, plain version,
    bound and SDPA."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    KV, G, hd = cfg.kv_heads(), cfg.num_heads // cfg.kv_heads(), \
        cfg.head_dim_()
    kind, HP, g_pad = attn.head_layout(cfg)
    if (kind, g_pad) != ("grouped", G):
        fail(f"h2o-danube-1.8b's head layout is {kind} g_pad={g_pad}")
    B, S, win = FLASH_PATH["B"], FLASH_PATH["S"], cfg.sliding_window
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    q, k, v = flash_inputs(torch, gen, B, S, KV, G, hd, torch.bfloat16)
    # model layout: q (B, S, KV, G, hd), k/v (B, S, KV, hd)
    q5 = q.view(B, KV, G, S, hd).permute(0, 3, 1, 2, 4).contiguous()
    k4 = k.view(B, KV, S, hd).transpose(1, 2).contiguous()
    v4 = v.view(B, KV, S, hd).transpose(1, 2).contiguous()
    flash_attention.launches = flash_attention.launches_tc = 0
    out = ops.flash_attention(q5, k4, v4, causal=True, window=win)
    torch.cuda.synchronize()
    launches, launches_tc = (flash_attention.launches,
                             flash_attention.launches_tc)
    if (launches, launches_tc) != (1, 1):
        fail(f"ops.flash_attention launched {launches} kernels, "
             f"{launches_tc} on the tensor cores (want 1 and 1)")
    with torch.no_grad():
        want = attn.blocked_attention(cfg, q5.reshape(B, S, HP, hd), k4, v4,
                                      window=win)
    # blocked_attention rounds P to bf16 before PV, the kernel keeps it
    # fp32: held at the JAX bf16 tolerance, |a - b| <= 2e-2 (1 + |b|)
    tol = TOL["bfloat16"]
    d = (out.reshape(B, S, HP, hd).float() - want.float()).abs()
    err = float(d.max())
    excess = float((d - tol * want.float().abs()).max())
    if not math.isfinite(excess) or excess > tol:
        fail(f"ops.flash_attention vs blocked_attention: max abs err {err}")
    del want, q5, k4, v4
    torch.cuda.empty_cache()
    # the path's output against the plain version on the same q/k/v (bf16)
    # and within one ulp of the plain version on the fp32-cast inputs;
    # then the kernel against the plain version at this shape in fp32
    kw = dict(causal=True, window=win, group_size=G)
    flat = out.permute(0, 2, 3, 1, 4).reshape(q.shape)
    vs_plain = {}
    for dtype_name, (a, qq, kk, vv) in (
            ("bfloat16", (flat, q, k, v)),
            ("float32", (None, q.float(), k.float(), v.float()))):
        got = a if a is not None else flash_attention(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(qq, kk, vv, **kw)
        e = float((got.float() - want.float()).abs().max())
        if got.dtype != qq.dtype or not math.isfinite(e) \
                or e > TOL[dtype_name]:
            fail(f"flash_attention at the path's shape, {dtype_name}: "
                 f"{got.dtype}, max abs err {e} vs the plain version")
        vs_plain[dtype_name] = e
        if dtype_name == "float32":
            ulp = one_ulp_excess(flat, want)
            if not math.isfinite(ulp) or ulp > 0:
                fail(f"flash_attention bf16 at the path's shape is not "
                     f"within one ulp of the fp32 result (excess {ulp})")
        del got, want, qq, kk, vv
        torch.cuda.empty_cache()
    del out, flat
    # times on the flat tensors; SDPA reads them as (B, H, S, hd) and
    # (B, KV, S, hd) views (head h uses kv head h // G, as the kernel does)
    iters = 5
    kern1 = cuda_ms(torch, lambda: flash_attention(q, k, v, **kw), iters)
    plain1 = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, **kw))
    plain2 = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, **kw))
    kern2 = cuda_ms(torch, lambda: flash_attention(q, k, v, **kw), iters)
    torch.cuda.empty_cache()
    qs, ks, vs = (q.view(B, KV * G, S, hd), k.view(B, KV, S, hd),
                  v.view(B, KV, S, hd))
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), iters)
    nbytes, flops = flash_work(np, B, S, KV * G, KV, hd, win, True, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    # fp32 at the same shape: the CUDA-core kernel, its plain version, its
    # bound at the fp32 CUDA-core peak and SDPA in fp32 (TF32 is off)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32 = {"ms": cuda_ms(torch, lambda: flash_attention(qf, kf, vf, **kw),
                         2),
           "plain_ms": cuda_ms(torch, lambda: flash_attention_plain(
               qf, kf, vf, **kw)),
           "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
               qf.view(B, KV * G, S, hd), kf.view(B, KV, S, hd),
               vf.view(B, KV, S, hd), is_causal=True, enable_gqa=True), 2)}
    nbytes32 = flash_work(np, B, S, KV * G, KV, hd, win, True, 4)[0]
    t32_bytes = nbytes32 / HBM_BYTES_PER_S * 1e3
    t32_ops = flops / PEAK_FLOPS["float32"] * 1e3
    f32.update(bound_ms=max(t32_bytes, t32_ops),
               bound_by="bytes" if t32_bytes >= t32_ops else "operations")
    del qf, kf, vf
    torch.cuda.empty_cache()
    res = {"shape": {"B": B, "S": S, "KV": KV, "G": G, "hd": hd,
                     "window": win, "causal": True, "dtype": "bfloat16"},
           "launches": launches, "launches_tc": launches_tc,
           "vs_blocked_attention_max_abs_err": err,
           "vs_plain_max_abs_err": vs_plain, "one_ulp_excess": ulp,
           "ms": min(kern1, kern2), "ms_runs": [kern1, kern2],
           "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1,
                                                              plain2],
           "library_ms": lib, "library": "scaled_dot_product_attention("
           "is_causal=True, enable_gqa=True)",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops,
           "achieved_tflops": flops / min(kern1, kern2) / 1e9,
           "float32": f32}
    emit({"phase": "flash", **res})
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# LM training: the trainer at the 100m preset, ElasticTrainer at full width
# ---------------------------------------------------------------------------


def lm_train_phase(torch):
    """`launch.train.train` on h2o-danube-1.8b at the 100m preset with an
    elastic event, rebalancing and slow workers; each step's wall time is
    the difference of the history's wall clock (read after the step's
    loss, so after the step)."""
    from repro_torch.launch import train as lm
    t0 = time.perf_counter()
    out = lm.train(ARCH, log_every=LM_TRAIN["train_steps"], device=DEVICE,
                   **LM_TRAIN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    hist, cfg = out["history"], out["cfg"]
    losses = [h["loss"] for h in hist]
    workers = [h["workers"] for h in hist]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"lm_train: losses {losses}")
    if workers[0] != LM_TRAIN["workers"] or workers[-1] != 2:
        fail(f"lm_train: workers {workers}")
    walls = [0.0] + [h["wall_s"] for h in hist]
    emit({"phase": "lm_train", "arch": ARCH, **LM_TRAIN,
          "model": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                    "vocab": cfg.vocab_size, "dtype": cfg.dtype},
          "global_batch": 8, "seq_len": 128, "run_s": run_s,
          "steps": [{"step": h["step"], "loss": h["loss"],
                     "workers": h["workers"], "sim_time": h["sim_time"],
                     "events": h["events"],
                     "step_ms": (walls[i + 1] - walls[i]) * 1e3}
                    for i, h in enumerate(hist)]})
    del out
    torch.cuda.empty_cache()


def lm_batches(np, cfg):
    """ChunkBatchPipeline over make_lm_tokens at train_4k's sequence, with
    an ElasticScalingPolicy K k0 -> k1 at step scale_at, scheduled as
    launch.train schedules its steps."""
    from repro_torch.core import (Assignment, ElasticScalingPolicy,
                                  ScaleEvent)
    from repro_torch.data import ChunkBatchPipeline
    from repro_torch.launch.train import build_data, scheduled_batch
    c = LM_ELASTIC
    store = build_data(cfg, n_seqs=c["n_seqs"], seq_len=c["seq"],
                       chunk_size=c["chunk_size"], seed=0)
    a = Assignment(store.n_chunks, c["k0"], np.random.default_rng(0))
    pipe = ChunkBatchPipeline(store, a, global_batch=c["batch"], seed=0)
    pols = [ElasticScalingPolicy([ScaleEvent(c["scale_at"], c["k1"])])]
    out = []
    for it in range(c["steps"]):
        batch = scheduled_batch(it, pipe, pols, seed=0, stats={})
        out.append((a.n_workers, batch))
        a.end_iteration()
    return out


def state_on_host(trainer, M):
    return ({k: v.detach().cpu().clone()
             for k, v in M.param_dict(trainer.params).items()},
            {k: v.cpu().clone() for k, v in trainer.opt_state.mu.items()},
            int(trainer.opt_state.step))


def same_state(torch, a, b) -> bool:
    """Bit-equality of two (params, momentum, step) host snapshots."""
    return a[2] == b[2] and all(
        torch.equal(x, b[i][k]) for i in (0, 1) for k, x in a[i].items())


def lm_elastic_phase(torch, np):
    """ElasticTrainer on h2o-danube-1.8b at full width and depth: 4 steps of
    8 x 4096 tokens, K 4 -> 2, suspended to the host after step 2 and
    resumed; then a suspended run against an uninterrupted one under
    deterministic algorithms."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.elastic import ElasticTrainer
    from repro_torch.models import model as M
    c = LM_ELASTIC
    cfg = get_config(ARCH)
    tc = TrainConfig()
    batches = lm_batches(np, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = ElasticTrainer(cfg, tc, seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in trainer.params.parameters())
    rows = []
    for it, (k, b) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"step": it, "K": k, "loss": m["loss"],
                     "grad_norm": m["grad_norm"], "step_s": dt,
                     "tokens_per_s": c["batch"] * c["seq"] / dt})
        if it == c["suspend_after"]:
            before = state_on_host(trainer, M)
            t0 = time.perf_counter()
            trainer.suspend()
            if trainer.params.embed.device.type != "cpu":
                fail("lm_elastic: suspend left the params on the card")
            suspend_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer.resume(1)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            if not same_state(torch, before, state_on_host(trainer, M)):
                fail("lm_elastic: the state changed across suspend/resume")
            del before
    peak = torch.cuda.max_memory_allocated()
    # one more step under the profiler: where a full-width step's device
    # time goes (cuBLAS kernel names vary; the elementwise kernels of the
    # attention's softmax tail are always there)
    emit({"phase": "profile", "cell": "lm_elastic",
          **profile_run(torch, lambda: trainer.train_step(batches[-1][1]),
                        kernel="elementwise_kernel")})
    losses = [r["loss"] for r in rows]
    ks = [r["K"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        fail(f"lm_elastic: non-finite losses {losses}")
    if ks[0] != c["k0"] or ks[-1] != c["k1"]:
        fail(f"lm_elastic: K path {ks}")
    del trainer
    torch.cuda.empty_cache()
    # suspended vs uninterrupted, bit for bit, with deterministic kernels
    # (cuBLAS's workspace was fixed by CUBLAS_WORKSPACE_CONFIG in main(),
    # before CUDA started)
    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        states = []
        for suspend in (False, True):
            tr = ElasticTrainer(cfg, tc, seed=0, device=DEVICE)
            for it in range(c["det_steps"]):
                tr.train_step(batches[it][1])
                if suspend and it == 0:
                    tr.suspend()
                    tr.resume(1)
            states.append(state_on_host(tr, M))
            del tr
            torch.cuda.empty_cache()
        det_equal = same_state(torch, *states)
        del states
    finally:
        torch.use_deterministic_algorithms(was_det)
    if not det_equal:
        fail("lm_elastic: a suspended run and an uninterrupted one differ "
             "under deterministic algorithms")
    emit({"phase": "lm_elastic", "arch": ARCH, "params": n_params,
          "model": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                    "heads": cfg.num_heads, "kv_heads": cfg.kv_heads(),
                    "head_dim": cfg.head_dim_(), "d_ff": cfg.d_ff,
                    "vocab": cfg.vocab_size, "window": cfg.sliding_window,
                    "dtype": cfg.dtype},
          "train_config": dataclasses.asdict(tc), **c,
          "reduced": {"global_batch": "256 -> 8 (train_4k's batch cut to "
                      "one card)", "steps": c["steps"]},
          "steps_log": rows, "suspend_s": suspend_s, "resume_s": resume_s,
          "round_trip_bit_exact": True,
          "deterministic_suspended_equals_uninterrupted": det_equal,
          "peak_mem_gb": peak / 1e9})
    torch.cuda.empty_cache()
    return rows


def spec_phase(torch, np, M, cfg, params, ServeEngine, Request, paged_mod):
    """Speculative decoding through the kernel at full width, bf16: the
    repetitive burst with spec off, then with spec="ngram" (launch counts
    zeroed just before and read just after), then the spec run again under
    the profiler."""
    paged_attention = paged_mod.paged_attention
    vocab = cfg.vocab_size
    prompts = {r.rid: r.prompt for r in repetitive_requests(np, Request,
                                                            vocab)}
    off = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                      device=DEVICE, **ENGINE)
    m_off = off.run(repetitive_requests(np, Request, vocab))
    s_off = m_off.summarize()
    del off
    eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                      device=DEVICE, spec="ngram", spec_k=SPEC_K, **ENGINE)
    span_log, restore = record_paged_launches(paged_mod)
    paged_attention.launches = paged_attention.launches_tc = 0
    paged_attention.launches_split = 0
    metrics = eng.run(repetitive_requests(np, Request, vocab))
    launches, launches_tc, launches_split = paged_counts(paged_attention)
    restore()
    s = metrics.summarize()
    from repro_torch.models.attention import head_layout
    rows = (SPEC_K + 1) * head_layout(cfg)[2]  # q_span x padded group
    dispatches = s["decode_dispatches"] + s["prefill_dispatches_total"]
    if launches != cfg.num_layers * dispatches or launches <= 0:
        fail(f"spec: {launches} kernel launches for {dispatches} paged "
             f"dispatches of {cfg.num_layers} layers")
    verify = [r for qg, r in span_log if qg == rows]
    wrong = [(qg, r) for qg, r in span_log if r != "tc"]
    if len(verify) != cfg.num_layers * s["decode_dispatches"] or wrong \
            or len(span_log) != launches or launches_tc != launches:
        fail(f"spec routes: {len(verify)} verify launches for "
             f"{s['decode_dispatches']} verify dispatches of "
             f"{cfg.num_layers} layers, {launches_tc} tensor-core of "
             f"{launches}; misrouted "
             f"(rows, route): {wrong[:5]}")
    toks = [t for r in metrics.requests for t in r.generated]
    if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32 \
            or not all(0 <= t < vocab for t in toks) \
            or not s["spec_drafted_total"]:
        fail(f"spec output wrong: {s['requests_finished']} finished, "
             f"{s['tokens_generated']} tokens, {s['spec_drafted_total']} "
             f"drafted")
    div = first_divergence(torch, np, M, cfg, params, streams(metrics),
                           streams(m_off), prompts)
    emit({"phase": "spec", "arch": ARCH, "dtype": cfg.dtype,
          "paged_impl": "kernel", "spec": "ngram", "spec_k": SPEC_K,
          **ENGINE, "prompt_lens": [r.prompt_len for r in metrics.requests],
          "acceptance_rate": s["spec_acceptance_rate"],
          "drafted": s["spec_drafted_total"],
          "accepted": s["spec_accepted_total"],
          "tokens_per_dispatch": s["tokens_per_dispatch"],
          "tokens_per_s": s["tokens_per_s"], "ttft_p50_s": s["ttft_p50_s"],
          "ttft_p99_s": s["ttft_p99_s"], "tpot_p50_s": s["tpot_p50_s"],
          "wall_s": s["wall_s"], "n_ticks": s["n_ticks"],
          "verify_dispatches": s["decode_dispatches"],
          "prefill_dispatches": s["prefill_dispatches_total"],
          "kernel_launches": launches,
          "kernel_launches_tensor_core": launches_tc,
          "verify_launches": len(verify), "verify_rows": rows,
          "spec_off": {"tokens_per_dispatch": s_off["tokens_per_dispatch"],
                       "tokens_per_s": s_off["tokens_per_s"],
                       "ttft_p50_s": s_off["ttft_p50_s"],
                       "tpot_p50_s": s_off["tpot_p50_s"],
                       "wall_s": s_off["wall_s"],
                       "decode_dispatches": s_off["decode_dispatches"]},
          "bf16_streams_equal_spec_off": div is None,
          "bf16_first_divergence": div})
    del eng
    prof_eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                           device=DEVICE, spec="ngram", spec_k=SPEC_K,
                           **ENGINE)
    emit({"phase": "profile", "cell": "spec", **profile_run(
        torch, lambda: prof_eng.run(repetitive_requests(np, Request,
                                                        vocab)))})
    del prof_eng
    return {"launches": launches, "launches_tc": launches_tc,
            "verify_launches": len(verify)}


def overload_requests(np, Request, vocab):
    """The overload workload: motif-tiled prompts (the spec phase's first 8,
    then 20 more), tenants t0 t1 t0 t2 in turn, and the tick each one
    arrives at (6 a tick)."""
    reqs = repetitive_requests(np, Request, vocab, n=OVERLOAD["n"])
    for i, r in enumerate(reqs):
        r.tenant = ("t0", "t1", "t0", "t2")[i % 4]
    return reqs, [i // OVERLOAD["per_tick"] for i in range(len(reqs))]


def overload_engine(ServeEngine, faults, overload, cfg, params, impl, *,
                    knobs, now=None):
    """The overload configuration: spec="ngram", spec_k 4, brownout="auto"
    with the OVERLOAD ladder, a circuit breaker, SLO targets, a bounded
    queue, a per-tenant token bucket and a 3-crash storm, over two
    workers.  `knobs` holds the SLO targets and the token bucket's rate
    and burst (ticks on the tick clock, seconds on the real one).  With a
    one-element list `now` the engine reads its clock there (the tick
    clock `drive_open_loop` sets); else it runs on the real clock."""
    o = OVERLOAD
    inj = faults.FaultInjector(faults.FaultPlan(faults.crash_storm(
        o["storm_at"], o["storm_n"], o["storm_every"])))
    return ServeEngine(cfg, params=params, paged_impl=impl, seed=0,
                       device=DEVICE, n_workers=FAULT_WORKERS, spec="ngram",
                       spec_k=SPEC_K, brownout="auto",
                       ladder=overload.DegradationLadder(**o["ladder"]),
                       breaker=overload.CircuitBreaker(),
                       queue_cap=o["queue_cap"], fault_injector=inj, **knobs,
                       clock=None if now is None else (lambda: now[0]),
                       **ENGINE)


def drive_open_loop(eng, reqs, due, now=None,
                    max_ticks=OVERLOAD["max_ticks"]):
    """Submit each request at its tick (stamped with the engine's clock, so
    the token buckets see its arrival) and tick until every request is
    done or `max_ticks` ticks have run: the open-loop client of the
    overload runs.  With the tick clock's list `now`, one tick is one
    simulated second: `now[0]` is the tick's number while it runs."""
    order = sorted(range(len(reqs)), key=lambda i: due[i])
    nxt = 0
    while (nxt < len(order) or eng.scheduler.has_pending or eng._by_slot
           or eng._prefilling or eng._retrying) and eng._tick < max_ticks:
        if now is not None:
            now[0] = float(eng._tick)
        batch = []
        while nxt < len(order) and due[order[nxt]] <= eng._tick:
            r = reqs[order[nxt]]
            r.arrival_time = eng._now()
            batch.append(r)
            nxt += 1
        eng.submit(batch)
        eng.tick()
    if now is not None:
        now[0] = float(eng._tick)
    eng.metrics.wall_s = eng._now()
    return eng.metrics


def verify_levels(metrics, layers):
    """Verify dispatches by ladder level: a tick that emitted tokens at
    level 0 ran a spec_k 4 verify (q_span 5), at level 1 (spec_shrink) a
    spec_k 2 one (q_span 3); levels >= 2 decode.  -> {q_span: paged
    launches that many dispatches make}."""
    spans = {0: SPEC_K + 1, 1: SPEC_K // 2 + 1}
    out = {q: 0 for q in spans.values()}
    for t in metrics.ticks:
        if t.tokens_emitted and t.brownout_level in spans:
            out[spans[t.brownout_level]] += layers
    return out


def overload_summary(s, metrics):
    return {k: s[k] for k in (
        "requests_finished", "rejected_requests", "shed_requests",
        "crashes_total", "retries_total", "recoveries", "recovery_events",
        "recovery_ticks_mean", "brownout_events", "brownout_level_max",
        "breaker_events", "slo_met", "goodput", "tokens_generated",
        "spec_drafted_total", "spec_accepted_total", "n_ticks",
        "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tokens_per_s",
        "wall_s")}


def faults_phase(torch, np, cfg32, params32, want32, ServeEngine, Request,
                 synthetic_requests, faults, overload, paged_mod,
                 bf16_params):
    """Crash recovery and overload control at full width.  (a) fp32 crash
    recovery on the engine burst: streams equal the fault-free fp32
    kernel streams `want32`.  (b) fp32 overload on the tick clock, once
    through the kernel and once through the gather path: equal streams,
    event lists and counts; finished streams equal spec-off's; the ladder
    reaches spec_off and returns to 0; verify launches at q_span 5 and 3
    equal layers x the verify dispatches at ladder levels 0 and 1.  (c)
    the same knobs in bf16 on the real clock (reported; every launch on
    its route), then again for its first PROFILE_TICKS ticks (the storm
    and the breaker's cycle) under the profiler, device activity only.
    `bf16_params()` makes the bf16 weights when (c) needs them.  -> the
    launches of each run and of each route, and the 12-row verify
    launches."""
    paged_attention = paged_mod.paged_attention
    from repro_torch.models.attention import head_layout
    vocab = cfg32.vocab_size
    G = head_layout(cfg32)[2]  # the padded group: rows = q_span x G
    hd = cfg32.head_dim_()
    layers = cfg32.num_layers
    launches = {}  # run -> (launches, tensor cores, split-KV)
    seconds = {}
    t0 = time.perf_counter()

    def zero():
        paged_attention.launches = paged_attention.launches_tc = 0
        paged_attention.launches_split = 0

    def check_routes(log, dtype_name, where):
        wrong = [(qg, r) for qg, r in log
                 if r != paged_route(dtype_name, qg, hd)]
        if wrong:
            fail(f"faults {where}: misrouted (rows, route): {wrong[:5]}")

    # ---- (a) crash recovery, fp32 -----------------------------------------
    c = CRASH_PLAN
    plan = faults.FaultPlan([faults.worker_crash(c["prefill_crash"]),
                             faults.worker_slow(*c["slow"]),
                             faults.worker_slow(*c["clear"], 1.0),
                             faults.worker_crash(c["decode_crash"])])
    eng = ServeEngine(cfg32, params=params32, paged_impl="kernel", seed=0,
                      device=DEVICE, n_workers=FAULT_WORKERS,
                      fault_injector=faults.FaultInjector(plan), **ENGINE)
    # run()'s loop (every arrival is at 0), which notes before each crash
    # tick what the crash will take: the highest live worker's slots
    victims = []
    log, restore = record_paged_launches(paged_mod)
    zero()
    eng.submit(requests(np, synthetic_requests, vocab))
    while eng.scheduler.has_pending or eng._by_slot or eng._prefilling \
            or eng._retrying:
        if eng._tick in (c["prefill_crash"], c["decode_crash"]):
            w = eng.scheduler.n_workers - 1
            slots = set(eng.scheduler.slots_of_worker(w))
            victims.append({"tick": eng._tick, "worker": w,
                            "mid_prefill": len(slots & set(eng._prefilling)),
                            "decoding": len(slots & set(eng._by_slot))})
        eng.tick()
    launches["crash"] = paged_counts(paged_attention)
    restore()
    m = eng.metrics
    m.wall_s = eng._now()
    s = m.summarize()
    check_routes(log, "float32", "(a)")
    if streams(m) != want32:
        bad = sorted(r for r, v in streams(m).items() if v != want32[r])
        fail(f"faults (a): fp32 streams of requests {bad} differ from the "
             f"fault-free kernel run")
    if (s["crashes_total"], s["recoveries"], s["shed_requests"]) != (2, 2, 0) \
            or len(victims) != 2 or not victims[0]["mid_prefill"] \
            or not victims[1]["decoding"] or eng._slow_factors \
            or launches["crash"][0] <= 0:
        fail(f"faults (a): crashes {s['crashes_total']}, recoveries "
             f"{s['recoveries']}, shed {s['shed_requests']}, victims "
             f"{victims}, slow factors {eng._slow_factors}, "
             f"{launches['crash'][0]} launches")
    part_a = {"victims": victims, "fault_events": [list(e) for e in
                                                   m.fault_events],
              "recovery_events": s["recovery_events"],
              "retries_total": s["retries_total"],
              "n_ticks": s["n_ticks"],
              "kernel_launches": launches["crash"][0],
              "streams_equal_fault_free": True}
    del eng, m
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (b) overload on the tick clock, fp32: kernel == gather ----------
    runs = {}
    knobs = {k: OVERLOAD[k] for k in ("slo_ttft", "slo_tpot", "tenant_rate",
                                      "tenant_burst")}
    for impl in ("kernel", "gather"):
        now = [0.0]
        eng = overload_engine(ServeEngine, faults, overload, cfg32, params32,
                              impl, knobs=knobs, now=now)
        log, restore = record_paged_launches(paged_mod)
        zero()
        m = drive_open_loop(eng, *overload_requests(np, Request, vocab), now)
        n = paged_counts(paged_attention)
        restore()
        runs[impl] = (m, m.summarize(), log, n)
        del eng
    (mk, sk, logk, nk), (mg, sg, _, ng) = runs["kernel"], runs["gather"]
    launches["overload_fp32"] = nk
    nk, ng = nk[0], ng[0]
    keys = ("requests_finished", "rejected_requests", "shed_requests",
            "brownout_events", "breaker_events", "recovery_events",
            "crashes_total", "retries_total", "n_ticks")
    record = lambda mm: {r.rid: (r.state.name, list(r.generated))  # noqa
                         for r in mm.requests}
    if record(mk) != record(mg) or any(sk[k] != sg[k] for k in keys) \
            or ng != 0:
        diff = [k for k in keys if sk[k] != sg[k]]
        fail(f"faults (b): kernel and gather overload runs differ "
             f"({diff or 'streams or states'}; gather launched {ng})")
    done = {r.rid: list(r.generated) for r in mk.requests
            if r.state.name == "FINISHED"}
    # the spec-off streams of the finished requests, fault- and load-free
    ref = ServeEngine(cfg32, params=params32, paged_impl="kernel", seed=0,
                      device=DEVICE, **ENGINE)
    spec_off = streams(ref.run([r for r in overload_requests(
        np, Request, vocab)[0] if r.rid in done]))
    del ref
    if any(v != spec_off[rid] for rid, v in done.items()) or not done:
        bad = sorted(rid for rid, v in done.items() if v != spec_off[rid])
        fail(f"faults (b): finished streams of {bad} differ from the "
             f"spec-off run")
    levels = [lvl for _, lvl, _ in mk.brownout_events]
    if max(levels, default=0) < 2 or levels[-1:] != [0]:
        fail(f"faults (b): brownout events {mk.brownout_events}: the ladder "
             f"must reach spec_off (2) and return to 0")
    check_routes(logk, "float32", "(b)")
    want_spans = verify_levels(mk, layers)
    got_spans = {q: sum(1 for qg, _ in logk if qg == q * G)
                 for q in want_spans}
    if got_spans != want_spans or not all(want_spans.values()):
        fail(f"faults (b): verify launches by q_span {got_spans}, want "
             f"{want_spans} (layers x verify dispatches at levels 0, 1)")
    part_b = {**overload_summary(sk, mk), "knobs": knobs,
              "queue_cap": OVERLOAD["queue_cap"],
              "kernel_launches": nk,
              "verify_launches_by_rows": {q * G: n for q, n in
                                          got_spans.items()},
              "routes": sorted({(qg, r) for qg, r in logk}),
              "kernel_equals_gather": True,
              "finished_equal_spec_off": len(done)}
    del runs, mk, mg
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (c) the same knobs in bf16 on the real clock (reported) ---------
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params16 = bf16_params()
    eng = overload_engine(ServeEngine, faults, overload, cfg16, params16,
                          "kernel", knobs=OVERLOAD_WALL)
    log, restore = record_paged_launches(paged_mod)
    zero()
    m = drive_open_loop(eng, *overload_requests(np, Request, vocab))
    launches["overload_bf16"] = paged_counts(paged_attention)
    restore()
    s = m.summarize()
    check_routes(log, "bfloat16", "(c)")
    want_spans = verify_levels(m, layers)
    got_spans = {q: sum(1 for qg, _ in log if qg == q * G)
                 for q in want_spans}
    if got_spans != want_spans:
        fail(f"faults (c): verify launches by q_span {got_spans}, want "
             f"{want_spans}")
    toks = [t for r in m.requests for t in r.generated]
    if not all(0 <= t < vocab for t in toks) or not s["requests_finished"]:
        fail(f"faults (c): {s['requests_finished']} finished")
    del eng
    prof_eng = overload_engine(ServeEngine, faults, overload, cfg16,
                               params16, "kernel", knobs=OVERLOAD_WALL)
    prof = profile_run(torch, lambda: drive_open_loop(
        prof_eng, *overload_requests(np, Request, vocab),
        max_ticks=PROFILE_TICKS))
    del prof_eng, params16
    seconds["c"] = time.perf_counter() - t0
    part_c = {**overload_summary(s, m), "knobs_s": OVERLOAD_WALL,
              "recovery_ticks": [e[1] for e in m.recovery_events],
              "kernel_launches": launches["overload_bf16"][0],
              "verify_launches_by_rows": {q * G: n for q, n in
                                          got_spans.items()},
              "routes": sorted({(qg, r) for qg, r in log}),
              "profile": prof}
    emit({"phase": "faults", "arch": ARCH, **ENGINE,
          "n_workers": FAULT_WORKERS, "crash_plan": CRASH_PLAN,
          "overload": OVERLOAD, "a_crash_recovery_fp32": part_a,
          "b_overload_tick_clock_fp32": part_b,
          "c_overload_wall_clock_bf16": part_c, "seconds": seconds})
    n, tc, split = (sum(v[i] for v in launches.values()) for i in range(3))
    return {"launches": n, "by_run": {k: v[0] for k, v in launches.items()},
            "launches_tc": tc, "launches_split": split,
            "verify_12_rows": part_b["verify_launches_by_rows"].get(
                (SPEC_K // 2 + 1) * G, 0)
            + part_c["verify_launches_by_rows"].get((SPEC_K // 2 + 1) * G,
                                                    0)}


def flat_run(np, ServeEngine, synthetic_requests, cfg, params, profile=None,
             **kw):
    """The engine workload on the flat layout; every request must finish
    with its 32 tokens.  `profile(run)`, if given, runs it and returns the
    profile.  -> (summary, streams, profile)."""
    eng = ServeEngine(cfg, params=params, seed=0, device=DEVICE, **FLAT, **kw)
    reqs = requests(np, synthetic_requests, cfg.vocab_size)
    prof = None
    if profile is None:
        metrics = eng.run(reqs)
    else:
        box = {}
        prof = profile(lambda: box.setdefault("m", eng.run(reqs)))
        metrics = box["m"]
    s = metrics.summarize()
    toks = [t for r in metrics.requests for t in r.generated]
    if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32 \
            or not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"flat {cfg.name}: {s['requests_finished']} finished, "
             f"{s['tokens_generated']} tokens")
    return s, streams(metrics), prof


def flat_phase(torch, np, M, cfg, get_config, ServeEngine,
               synthetic_requests):
    """The flat KV layout at full width, bf16: h2o-danube-1.8b and
    smollm-360m (a warm-up run, the measured run, then one under the
    profiler, device activity only; no custom kernel runs here, so the
    profile's share is the elementwise kernels'), then spec="draft" with a 4-layer danube drafting
    for itself."""
    from repro_torch.models import attention as attn
    out = {}
    for arch, c in ((ARCH, cfg), (FLAT_ARCH, get_config(FLAT_ARCH))):
        params = M.init_params(c, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE)
        flat_run(np, ServeEngine, synthetic_requests, c, params)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        s, _, _ = flat_run(np, ServeEngine, synthetic_requests, c, params)
        peak = torch.cuda.max_memory_allocated()
        prof = flat_run(np, ServeEngine, synthetic_requests, c, params,
                        profile=lambda run: profile_run(
                            torch, run, kernel="elementwise"))[2]
        out[arch] = {"layers": c.num_layers, "d_model": c.d_model,
                     "heads": c.num_heads, "kv_heads": c.kv_heads(),
                     "head_layout": attn.head_layout(c)[0],
                     "tokens_per_s": s["tokens_per_s"],
                     "ttft_p50_s": s["ttft_p50_s"],
                     "tpot_p50_s": s["tpot_p50_s"], "wall_s": s["wall_s"],
                     "n_ticks": s["n_ticks"],
                     "admission_bytes": s["admission_bytes_total"],
                     "peak_mem_gb": peak / 1e9,
                     "profile": {k: prof.get(k) for k in (
                         "wall_s", "device_busy_s", "device_idle_share",
                         "top_kernels")}}
        del params
        torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=DRAFT_LAYERS)
    params = M.init_params(small, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    s, _, _ = flat_run(np, ServeEngine, synthetic_requests, small, params,
                       spec="draft", spec_k=SPEC_K, draft_cfg=small,
                       draft_params=params)
    if not s["spec_drafted_total"] or s["draft_dispatches"] <= 0:
        fail(f"draft arm drafted {s['spec_drafted_total']} tokens in "
             f"{s['draft_dispatches']} dispatches")
    out["draft"] = {"arch": ARCH, "layers": DRAFT_LAYERS, "spec_k": SPEC_K,
                    "acceptance_rate": s["spec_acceptance_rate"],
                    "drafted": s["spec_drafted_total"],
                    "tokens_per_dispatch": s["tokens_per_dispatch"],
                    "draft_dispatches": s["draft_dispatches"],
                    "tokens_per_s": s["tokens_per_s"],
                    "tpot_p50_s": s["tpot_p50_s"], "wall_s": s["wall_s"]}
    del params
    torch.cuda.empty_cache()
    emit({"phase": "flat", **FLAT, "dtype": cfg.dtype, "runs": out})


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        sys.exit("chip_smoke: run it from a checkout of the repository "
                 "(src/repro_torch not found beside this script)")
    # lm_elastic's deterministic comparison needs cuBLAS's workspace fixed
    # before CUDA starts (PyTorch reads it once); :4096:8 is also the
    # default size on Hopper, so the other phases run as they would without
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke test runs on an NVIDIA GPU only")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import ElasticScalingPolicy, ScaleEvent
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunk_reduce import (weighted_merge,
                                                  weighted_merge_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    from repro_torch.kernels import scd as scd_mod
    from repro_torch.kernels.scd import scd_pass, scd_pass_plain
    from repro_torch.models import model as M
    from repro_torch import faults as faults_mod
    from repro_torch.serve import Request, ServeEngine, synthetic_requests
    from repro_torch.serve import overload as overload_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    names = ("paged_attention", "scd", "chunk_reduce", "flash_attention")
    kbuild.build(*names)
    build_s = time.perf_counter() - t0
    ptxas, sass = {}, {}
    for kname in names:
        log = kbuild.library_path(kname).with_suffix(".log")
        ptxas[kname] = [ln.strip() for ln in (log.read_text().splitlines()
                                              if log.exists() else [])
                        if "registers" in ln or "spill" in ln]
        sass[kname] = sass_counts(kbuild.library_path(kname))
    for kname in ("paged_attention", "flash_attention"):
        if not sum(sass[kname].values()):
            fail(f"{kname}'s library has no tensor-core instruction")
    emit({"phase": "build", "seconds": build_s, "card": card,
          "ptxas": ptxas, "sass_tensor_core_instructions": sass})

    # ---- 2. kernel vs plain version on the card --------------------------
    cfg = get_config(ARCH)
    KV, G = cfg.kv_heads(), cfg.num_heads // cfg.kv_heads()
    hd, ps = cfg.head_dim_(), ENGINE["page_size"]
    P = ENGINE["cache_len"] // ps
    n_pages = ENGINE["capacity"] * P + 1
    rng = np.random.default_rng(0)
    shapes = {
        # decode: every slot of the pool, live lengths of the workload
        "decode": dict(B=8, Q=1, lengths=rng.integers(33, 1569, size=8)),
        # one 256-token prefill chunk per row at page-aligned offsets
        "chunk": dict(B=4, Q=256, lengths=256 * rng.integers(1, 7, size=4)),
        # a speculative verify span of spec_k + 1 positions in every slot
        "verify": dict(B=8, Q=SPEC_K + 1,
                       lengths=rng.integers(37, 1573, size=8)),
        # the verify span at the ladder's spec_shrink (spec_k 2: q_span 3,
        # 12 rows, the split route in both dtypes)
        "verify_shrink": dict(B=8, Q=SPEC_K // 2 + 1,
                              lengths=rng.integers(35, 1571, size=8)),
    }
    worst = {}
    checks = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        err = 0.0
        cases = ([(c, None, None) for c in SELFTEST_CASES + TC_PAGED_CASES]
                 + [(c, None, lens) for c, lens in SPLIT_PAGED_CASES]
                 + [((s["B"], KV, G, hd, ps, P, cfg.sliding_window, s["Q"]),
                     n_pages, s["lengths"]) for s in shapes.values()])
        for case, pages, lens in cases:
            B, kv, g, d, p_s, pp, win, Q = case
            inp = paged_inputs(torch, np, rng, B, kv, g, d, p_s, pp, Q, dtype,
                               n_pages=pages, lengths=lens)
            before = paged_counts(paged_attention)
            got = call(paged_attention, inp, win)
            torch.cuda.synchronize()
            route = took(before, paged_counts(paged_attention))
            want = call(paged_attention_plain, inp, win)
            e = float((got.float() - want.float()).abs().max())
            checks.append({"dtype": dtype_name, "case": list(case),
                           "route": route, "max_abs_err": e})
            if not math.isfinite(e) or e > TOL[dtype_name]:
                fail(f"paged_attention {dtype_name} case {case}: max abs "
                     f"err {e} > {TOL[dtype_name]}")
            if route != paged_route(dtype_name, Q * g, d):
                fail(f"paged_attention {dtype_name} case {case} took the "
                     f"{route} route, not the "
                     f"{paged_route(dtype_name, Q * g, d)} route")
            if route == "split" and not torch.equal(
                    got, call(paged_attention, inp, win)):
                fail(f"paged_attention {dtype_name} case {case}: two calls "
                     f"of the split route differ")
            err = max(err, e)
        worst[dtype_name] = err
    scd_err, scd_cases = check_scd(torch, np, scd_pass, scd_pass_plain,
                                   scd_mod.takes_blocked)
    merge_err = check_merge(torch, weighted_merge, weighted_merge_plain)
    flash_err, flash_cases = check_flash(torch, flash_attention,
                                         flash_attention_plain, ops)
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": checks, "scd": {"tolerance": TOL_SCD,
                                   "max_abs_err": scd_err,
                                   "cases": scd_cases},
          "weighted_merge": {"tolerance": TOL_MERGE,
                             "max_abs_err": merge_err},
          "flash_attention": {"tolerance": TOL, "max_abs_err": flash_err,
                              "cases": flash_cases}})

    # ---- 3. engine at full width, bf16, through the kernel ----------------
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = M.init_params(cfg, gen, DEVICE)
    warm = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                       device=DEVICE, **ENGINE)
    warm.run(synthetic_requests(1, vocab_size=cfg.vocab_size,
                                arrivals=np.zeros(1), prompt_len=(300, 300),
                                max_new_tokens=(2, 2),
                                rng=np.random.default_rng(1)))
    del warm
    pol = ElasticScalingPolicy([ScaleEvent(0, 1), ScaleEvent(10, 2),
                                ScaleEvent(25, 1)])
    eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                      device=DEVICE, policies=[pol], **ENGINE)
    reqs = requests(np, synthetic_requests, cfg.vocab_size)
    import repro_torch.kernels.paged_attention as paged_mod
    span_log, restore = record_paged_launches(paged_mod)
    paged_attention.launches = paged_attention.launches_tc = 0
    paged_attention.launches_split = 0
    metrics = eng.run(reqs)
    launches, launches_tc, launches_split = paged_counts(paged_attention)
    restore()
    s = metrics.summarize()
    dispatches = s["decode_dispatches"] + s["prefill_dispatches_total"]
    toks = [t for r in metrics.requests for t in r.generated]
    if launches <= 0:
        fail("the engine run launched no paged_attention kernel")
    if launches != cfg.num_layers * dispatches:
        fail(f"{launches} kernel launches for {dispatches} paged "
             f"dispatches of {cfg.num_layers} layers")
    # bf16 spans of >= 16 rows (the prefill chunks) take the tensor-core
    # kernel; decode's G rows the split route
    wrong = [(qg, r) for qg, r in span_log
             if r != ("tc" if qg >= 16 else "split" if qg == G else "?")]
    if len(span_log) != launches or wrong or not launches_tc \
            or not launches_split \
            or launches_tc + launches_split != launches:
        fail(f"routes: {launches_tc} tensor-core and {launches_split} split "
             f"launches of {launches}; misrouted (rows, route): "
             f"{wrong[:5]}")
    if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32 \
            or not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"engine output wrong: {s['requests_finished']} finished, "
             f"{s['tokens_generated']} tokens")
    if [list(e) for e in metrics.scale_events] != [[10, 1, 2], [25, 2, 1]]:
        fail(f"scale events {metrics.scale_events}")
    emit({"phase": "engine", "arch": ARCH, "dtype": cfg.dtype,
          "paged_impl": "kernel", **ENGINE,
          "prompt_lens": [r.prompt_len for r in metrics.requests],
          "tokens_per_s": s["tokens_per_s"], "ttft_p50_s": s["ttft_p50_s"],
          "ttft_p99_s": s["ttft_p99_s"], "tpot_p50_s": s["tpot_p50_s"],
          "wall_s": s["wall_s"], "n_ticks": s["n_ticks"],
          "decode_dispatches": s["decode_dispatches"],
          "prefill_chunks": s["prefill_chunks_total"],
          "prefill_dispatches": s["prefill_dispatches_total"],
          "scale_events": s["scale_events"],
          "resize_moved_bytes": s["resize_moved_bytes_total"],
          "kernel_launches": launches,
          "kernel_launches_tensor_core": launches_tc,
          "kernel_launches_split": launches_split,
          "launch_rows": sorted({qg for qg, _ in span_log}),
          "launches_per_dispatch": launches / dispatches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # the same run again under the profiler: where the device time goes
    prof_eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                           device=DEVICE, policies=[ElasticScalingPolicy(
                               [ScaleEvent(0, 1), ScaleEvent(10, 2),
                                ScaleEvent(25, 1)])], **ENGINE)
    emit({"phase": "profile", **profile_run(torch, lambda: prof_eng.run(
        requests(np, synthetic_requests, cfg.vocab_size)))})
    del eng, prof_eng

    # ---- 4. spec: speculative decoding through the kernel ----------------
    spec = spec_phase(torch, np, M, cfg, params, ServeEngine, Request,
                      paged_mod)
    del params
    torch.cuda.empty_cache()

    # ---- streams: kernel == gather == spec == flat (fp32); card == CPU ---
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init_params(cfg32,
                             torch.Generator(device=DEVICE).manual_seed(0),
                             DEVICE)
    got = {}
    for impl in ("kernel", "gather"):
        eng = ServeEngine(cfg32, params=params32, paged_impl=impl, seed=0,
                          device=DEVICE, **ENGINE)
        got[impl] = streams(eng.run(requests(np, synthetic_requests,
                                             cfg.vocab_size)))
        del eng
    eng = ServeEngine(cfg32, params=params32, paged_impl="kernel", seed=0,
                      device=DEVICE, spec="ngram", spec_k=SPEC_K, **ENGINE)
    m_spec = eng.run(requests(np, synthetic_requests, cfg.vocab_size))
    got["spec"] = streams(m_spec)
    del eng
    # spec == spec-off on the repetitive burst, whose drafts are partly
    # rejected: rollback, page trim and the re-verify over the KV rows that
    # rejected drafts wrote all run through the kernel
    repetitive = {}
    for name, kw in (("off", {}), ("spec", dict(spec="ngram",
                                                 spec_k=SPEC_K))):
        eng = ServeEngine(cfg32, params=params32, paged_impl="kernel",
                          seed=0, device=DEVICE, **kw, **ENGINE)
        repetitive[name] = eng.run(repetitive_requests(np, Request,
                                                       cfg.vocab_size))
        del eng
    spec_rep = repetitive["spec"].summarize()
    if not 0 < spec_rep["spec_accepted_total"] \
            < spec_rep["spec_drafted_total"]:
        fail(f"fp32 repetitive burst: {spec_rep['spec_accepted_total']} of "
             f"{spec_rep['spec_drafted_total']} drafts accepted; the gate "
             f"needs some rejected")
    div = first_divergence(
        torch, np, M, cfg32, params32, streams(repetitive["spec"]),
        streams(repetitive["off"]),
        {r.rid: r.prompt for r in repetitive_requests(np, Request,
                                                      cfg.vocab_size)})
    if div is not None:
        emit({"phase": "streams", "equal": False,
              "vs_spec_off": "spec (repetitive)", **div})
        fail(f"fp32 spec and spec-off streams of the repetitive burst "
             f"diverge at request {div['rid']} step {div['step']}")
    got["flat"] = flat_run(np, ServeEngine, synthetic_requests, cfg32,
                           params32)[1]
    prompts = {r.rid: r.prompt
               for r in requests(np, synthetic_requests, cfg.vocab_size)}
    for name in ("gather", "spec", "flat"):
        div = first_divergence(torch, np, M, cfg32, params32, got[name],
                               got["kernel"], prompts)
        if div is not None:
            emit({"phase": "streams", "equal": False, "vs_kernel": name,
                  **div})
            fail(f"{name} and kernel streams diverge at request "
                 f"{div['rid']} step {div['step']}")
    spec_fp32 = m_spec.summarize()
    small = smoke_variant(cfg)
    small_reqs = lambda: synthetic_requests(  # noqa: E731
        6, vocab_size=small.vocab_size, arrivals=np.zeros(6),
        prompt_len=(10, 40), max_new_tokens=(6, 10),
        rng=np.random.default_rng(2))
    small_kw = dict(capacity=4, cache_len=64, prefill_bucket=16,
                    page_size=8, prefill_chunk=16, seed=0)
    on_card = streams(ServeEngine(small, device=DEVICE, paged_impl="kernel",
                                  kv_layout="paged",
                                  **small_kw).run(small_reqs()))
    cpu_params = M.init_params(
        small, torch.Generator(device=DEVICE).manual_seed(0),
        DEVICE).to("cpu")
    on_cpu = streams(ServeEngine(small, device="cpu", params=cpu_params,
                                 paged_impl="kernel", kv_layout="paged",
                                 **small_kw).run(small_reqs()))
    if on_card != on_cpu:
        fail("smoke-size streams differ between the card and the CPU")
    emit({"phase": "streams", "equal": True, "full_width_fp32_tokens":
          sum(len(v) for v in got["kernel"].values()),
          "equal_to_kernel": ["gather", "spec", "flat"],
          "spec_fp32": {"acceptance_rate": spec_fp32["spec_acceptance_rate"],
                        "tokens_per_dispatch":
                            spec_fp32["tokens_per_dispatch"]},
          "spec_fp32_repetitive_equal_spec_off": True,
          "spec_fp32_repetitive": {
              "acceptance_rate": spec_rep["spec_acceptance_rate"],
              "drafted": spec_rep["spec_drafted_total"],
              "accepted": spec_rep["spec_accepted_total"],
              "tokens_per_dispatch": spec_rep["tokens_per_dispatch"]},
          "smoke_card_vs_cpu_tokens": sum(len(v) for v in on_card.values())})
    torch.cuda.empty_cache()

    # ---- faults: crash recovery and overload control at full width -------
    fault = faults_phase(
        torch, np, cfg32, params32, got["kernel"], ServeEngine, Request,
        synthetic_requests, faults_mod, overload_mod, paged_mod,
        lambda: M.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE))
    del params32
    torch.cuda.empty_cache()

    # ---- flat: the flat KV layout at full width, bf16 --------------------
    flat_phase(torch, np, M, cfg, get_config, ServeEngine,
               synthetic_requests)

    # ---- 5. cocoa, 6. lsgd: the training path at full width --------------
    torch.cuda.reset_peak_memory_stats()
    cocoa = cocoa_phase(torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lsgd = lsgd_phase(torch, np)
    torch.cuda.empty_cache()

    # ---- 7. flash: the entry point at full width; 8-9. LM training -------
    flash = flash_phase(torch, np, F, cfg, flash_attention,
                        flash_attention_plain)
    flash_err = {k: max(e, flash["vs_plain_max_abs_err"][k])
                 for k, e in flash_err.items()}
    lm_train_phase(torch)
    lm_elastic_phase(torch, np)

    # ---- 10. timing at the main path's shapes (bf16, the engine dtype) ----
    lib = library_call(torch, F, cfg.sliding_window)
    timing = {}
    for shape_name, sh in shapes.items():
        rot = []
        for _ in range(4):  # 4 pool copies: > 50 MB of pages in rotation
            rot.append(paged_inputs(torch, np, rng, sh["B"], KV, G, hd, ps,
                                    P, sh["Q"], torch.bfloat16,
                                    n_pages=n_pages, lengths=sh["lengths"]))
        inp = rot[0]
        before = paged_counts(paged_attention)
        got = call(paged_attention, inp, cfg.sliding_window)
        torch.cuda.synchronize()
        route = took(before, paged_counts(paged_attention))
        want = call(paged_attention_plain, dict(
            inp, q=inp["q"].float(), k_pages=inp["k_pages"].float(),
            v_pages=inp["v_pages"].float()), cfg.sliding_window)
        ulp = one_ulp_excess(got, want)
        if not math.isfinite(ulp) or ulp > 0 \
                or route != paged_route("bfloat16", sh["Q"] * G, hd):
            fail(f"paged_attention {shape_name}: one-ulp excess {ulp}, "
                 f"{route} route")
        del got, want, inp
        iters = 50
        nbytes, flops = work(np, rot[0], cfg.sliding_window, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        win = cfg.sliding_window
        # device time (profiler): CUDA events over back-to-back calls
        # measure the host's issue rate (~25 us a call) for a faster kernel
        plain1 = rotating_device_ms(torch, paged_attention_plain, rot, win,
                                    iters)
        kern1 = rotating_device_ms(torch, paged_attention, rot, win, iters)
        kern2 = rotating_device_ms(torch, paged_attention, rot, win, iters)
        plain2 = rotating_device_ms(torch, paged_attention_plain, rot, win,
                                    iters)
        timing[shape_name] = {
            "shape": {"B": sh["B"], "KV": KV, "QG": sh["Q"] * G, "hd": hd,
                      "page_size": ps, "P": P,
                      "live_tokens": int(np.sum(sh["lengths"]))},
            "timer": "device time per call (torch.profiler)",
            "ms": min(kern1, kern2), "ms_runs": [kern1, kern2],
            "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1,
                                                               plain2],
            "library_ms": rotating_device_ms(torch, lib, rot, win, iters),
            "events_ms": {  # back-to-back calls, bounded by the host
                "kernel": time_ms(torch, paged_attention, rot, win, iters),
                "plain": time_ms(torch, paged_attention_plain, rot, win,
                                 iters),
                "library": time_ms(torch, lib, rot, win, iters)},
            "kernel": {"tc": "tensor cores", "split": "split-KV",
                       "cuda_core": "CUDA cores"}[route],
            "one_ulp_excess": ulp,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
        del rot
    dec = timing["decode"]
    train = training_timing(torch, np, scd_pass, scd_pass_plain,
                            weighted_merge, weighted_merge_plain)
    scd_t, merge_t = train["scd"], train["weighted_merge"]
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:47",
        "replaces_function": "src/repro/kernels/paged_attention.py"
                             "::_paged_kernel",
        "launches": launches + spec["launches"] + fault["launches"],
        "launches_by_path": {"engine": launches, "spec": spec["launches"],
                             "faults": fault["by_run"]},
        "launches_tc": launches_tc + spec["launches_tc"]
        + fault["launches_tc"],
        "launches_split": launches_split + fault["launches_split"],
        "routes": {"split (decode)": launches_split,
                   "tensor cores (engine prefill chunks)": launches_tc,
                   "tensor cores (spec: chunks and verify)":
                       spec["launches_tc"],
                   "of which verify spans": spec["verify_launches"],
                   "tensor cores (faults)": fault["launches_tc"],
                   "split (faults: decode and verify)":
                       fault["launches_split"],
                   "of which verify spans of 12 rows (spec_shrink)":
                       fault["verify_12_rows"],
                   "CUDA cores": launches + spec["launches"]
                   + fault["launches"] - launches_tc - launches_split
                   - spec["launches_tc"] - fault["launches_tc"]
                   - fault["launches_split"]},
        "sass": sass["paged_attention"],
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shapes": timing}, {
        "name": "scd_pass", "route": "cuda",
        "source": "src/repro_torch/csrc/scd.cu",
        "replaces": "src/repro/kernels/scd.py:62",
        "replaces_function": "src/repro/kernels/scd.py::scd_pass "
                             "(body _scd_kernel :25)",
        "launches": cocoa["scale_in"]["launches"],
        "launches_rebalance": cocoa["rebalance"]["launches"],
        "launches_blocked": cocoa["scale_in"]["launches_blocked"],
        "launches_blocked_rebalance": cocoa["rebalance"][
            "launches_blocked"],
        "launches_tc": None, "sass": sass["scd"],
        "max_abs_err": scd_err, "ms": scd_t["ms"],
        "plain_ms": scd_t["plain_ms"], "bound_ms": scd_t["bound_ms"],
        "bound_by": scd_t["bound_by"], "library_ms": None,
        "chain_bound_ms": scd_t["chain_bound_ms"], "timing": scd_t}, {
        "name": "weighted_merge", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_reduce.cu",
        "replaces": "src/repro/kernels/chunk_reduce.py:25",
        "replaces_function": "src/repro/kernels/chunk_reduce.py::"
                             "weighted_merge (body _merge_kernel :17)",
        "launches": lsgd["launches"], "launches_tc": None,
        "sass": sass["chunk_reduce"],
        "max_abs_err": merge_err["float32"],
        "max_abs_err_bf16": merge_err["bfloat16"],
        "ms": merge_t["path"]["ms"], "plain_ms": merge_t["path"]["plain_ms"],
        "bound_ms": merge_t["path"]["bound_ms"],
        "bound_by": merge_t["path"]["bound_by"],
        "library_ms": merge_t["path"]["library_ms"], "timing": merge_t}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "replaces_function": "src/repro/kernels/flash_attention.py::"
                             "flash_attention (body _flash_kernel :25; "
                             "model-layout wrapper kernels/ops.py:24)",
        "launches": flash["launches"], "launches_tc": flash["launches_tc"],
        "sass": sass["flash_attention"],
        "max_abs_err": flash_err["float32"],
        "max_abs_err_bf16": flash_err["bfloat16"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"], "timing": flash}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
