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
              q_span 5, 20 rows), two more spans of >= 16 rows, the split
              route's edge cases and the verify route's (length 0,
              shorter than one run of keys, exactly P * ps, a window
              starting inside a run, q_span 2-5, QG 32 at hd 64 and 128)
              and the full-width verify span at the ladder's spec_shrink
              (spec_k 2: q_span 3, 12 rows), fp32 at 2e-5 (TF32 off) and
              bf16 at 2e-2; every launch must take the route the
              launcher's rule names; the split and verify routes give
              bitwise-equal outputs on two calls.
              scd: the JAX kernel test's shapes (K <= 4, M in {16, 64},
              F in {8, 32}, masked tails), the CoCoA paths' shapes at
              K=16, F in {28, 128, 256} with M cut to 4,096, the wide
              kernel's other block sizes (F = 65, 1100, 2048, 4096), the
              row kernel's widths (F = 4097, 4100, 8192, 65536; K <= 2,
              M <= 256), a long chain (K=2, M=32,768, F=28), and rows the
              wrapper
              pads into an aligned copy (F=30; F=28 and F=256 with x 4
              bytes off alignment), fp32 at rtol/atol 1e-5; every launch
              takes the kernel the launcher's rule names (blocked for
              F <= 64, wide up to 4096, row above).  weighted_merge: K in 1..16, N in
              {7, 5001, 5002, 5003, 4,100, 276,266, 276,267} (every
              row-alignment class), f32 at 1e-5 and bf16 at 3e-2.
              flash_attention: the JAX
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
              rows) must take the verify route and every prefill chunk
              the tensor-core chunk kernel, verify launches
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
              brownout level (reported), every launch on its route (each
              verify span, 20 and 12 rows, on the verify route); then
              its first 16 ticks again under torch.profiler.
   overlap  — the overlapped tick (overlap=True) at the same width
              (paged, kernel).  (a) fp32: the engine burst with its scale
              events, the same with spec="ngram", and faults (a)'s crash
              plan, each overlapped, and the engine burst overlapped on
              the flat layout; the streams must equal the synchronous
              fp32 kernel streams (the streams phase's), the paged
              launches layers x paged dispatches, each on the launcher's
              route.  (b) bf16: the engine burst synchronously and
              overlapped in turns (sync, ovl, ovl, sync):
              every run's tokens/s, TTFT and TPOT and each arm's median
              (reported); one overlapped run under torch.profiler, one
              under a Tracer (host_overlap_ratio; a full-pool decode
              launch's host time, its overlap.bind span, against the
              step's device time over 5 profiled decode-only ticks of
              the same run).  (c) the
              metadata ring: RING + 4 buffers packed behind a device
              sleep must all arrive intact (an unguarded ring beside it,
              reported).
   disagg   — disaggregated serving (DisaggEngine: a prefill pool and a
              decode pool over disjoint logical workers on the card, one
              params module, the handoff through host memory) at the same
              width, paged, through the kernel in both pools.  (a) fp32:
              the engine burst over two workers, synchronous, and over
              three with the prefill pool moved 1 -> 2 -> 1 at ticks 2
              and 5, overlapped: the streams must equal the synchronous
              fp32 kernel streams, all 8 requests hand off once, the
              prefill pool's launches must all be 256-token chunks and
              equal layers x its chunk dispatches, the decode pool's
              decode spans and equal layers x its dispatches, each on the
              launcher's route.  (b) bf16, synchronous and overlapped,
              each traced (reported): tokens/s, TTFT, TPOT, handoffs,
              handoff bytes and delay, the host time of the handoff
              spans, and how much extract time fell inside the decode
              pool's overlap window, beside the engine phase's numbers.
   cluster  — the cluster orchestrator (`repro_torch.cluster`): jobs
              lease simulated nodes of one DevicePool on the card (its
              default devices) through the fair-share allocator, and each
              lease change goes through the job's elastic path.  (a) fp32:
              a ServeJob (paged, through the kernel, chunks of 256, 2
              slots a node) under the engine burst is squeezed from 4
              nodes to 1 by a higher-priority CoCoA job (F = 28, n cut to
              1,100,000, 16 micro-tasks; every SCD launch blocked): its
              streams must equal a solo ServeEngine's, the squeeze must
              park slots (kv_moved_bytes > 0, the engine's mem.stats()),
              and the CoCoA gap curve, alpha and w must equal a solo
              run's bit for bit; a DisaggServeJob whose lease changes once
              (3 -> 2 nodes): 8 handoffs and the solo streams; an
              LMTrainJob at the 100m preset scaled to zero and resumed:
              its state equals an uninterrupted ElasticTrainer's
              (deterministic algorithms).  Paged launches = layers x the
              jobs' paged dispatches, each on the launcher's route.  (b)
              bf16: the contention trace untraced, then traced under
              torch.profiler: the orchestrator's wall time, each job's
              `advance` host time, device busy time, idle share and top
              kernels, and the report's simulated makespan, utilization,
              fairness and preemptions.
   moe      — the moe family at grok-1-314b's published widths (d_model
              6144, 48 heads over 8 KV: G 6, hd 128; 8 experts, top-2,
              capacity factor 1.25, d_ff 32768; vocab 131072), paged,
              through the kernel, random weights from a seed.  (c)
              paged_attention at that head geometry: decode (QG 6, the
              split route), the verify spans of spec_k 4 and 2 (QG 30,
              18) and a 256-token chunk (QG 1536), fp32 and bf16, against
              the plain version and a gather + SDPA, then each shape in
              bf16 held within one bf16 ulp of the plain version on the
              fp32-cast inputs and timed as the timing phase times the
              main path's shapes.  (a) fp32 at 2 of 64 layers: the
              engine burst through the kernel must give the streams of
              the kernel's plain version in the same engine and of the
              overlapped tick; the flat layout overlapped those of the
              flat layout; spec ngram on the repetitive burst those of
              spec through the plain version.  Gather, flat and spec-off
              streams are reported against them: a moe row depends on
              every row of its call (expert capacity drops), so those
              paths can differ by design, in the JAX engine too.  Launches =
              layers x paged dispatches.  (b) bf16 at 4 of 64 layers: the
              engine burst synchronously and overlapped in turns, one
              run profiled, one overlapped run traced (a decode launch's
              host time against a step's device time).  Its weights are
              freed before the next phase.
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
              after a warm-up run; danube's then again under
              torch.profiler, device activity only); then
              spec="draft" on the flat layout with a 4-layer
              h2o-danube-1.8b drafting for itself (draft params = the
              target's).
   families — the model families beside dense and moe, no kernel on
              their path (every kernel's count zeroed before, read after:
              0): rwkv6-1.6b (ssm) and whisper-small (audio) at full size,
              llama-3.2-vision-90b (vlm) at published widths with one
              block of 5 layers (4 self + 1 cross; its cross gate set to
              0.5, zeros at init), random weights from a seed.  Each: (a)
              fp32 (TF32 off): a 128-token prefill, then 64 decode_steps,
              each step's logits against forward's over all 192 tokens,
              and the cache after them against a prefill of all 192
              (rwkv's shift/wkv state; k/v, xk/xv), at rtol 2e-2, atol
              1e-1 (tests/test_arch_smoke.py's prefill-vs-decode
              tolerance); (b) bf16: prefill ms, greedy decode through
              launch.steps.make_serve_step (a step's device time against
              the bytes it must move, a launch's host time, tokens/s);
              (c) bf16 training steps through make_train_step (rwkv 8 x
              1024, whisper 4 x 448 tokens): step wall time, peak memory,
              finite loss, parameters moved.  Then jamba-1.5-large-398b's
              mamba mixer at its published widths (d_inner 16384, state
              16; the model does not fit the card) in fp32: mamba_forward
              over 2 x 1024 tokens against 1024 stepwise mamba_decode
              calls (outputs, conv and h states).
   dryrun   — the planner (`launch.dryrun.run_one`) against the card, no
              kernel on its path (counts zeroed, read as 0): rwkv6-1.6b x
              decode_32k (B 128), h2o-danube-1.8b x long_500k (B 1, its
              4096 window as a ring), qwen3-4b x long_500k (the
              swa-variant) and h2o-danube-1.8b x train_4k with
              global_batch cut from 256 to 2, each traced on meta tensors
              at published widths, then run once on the card in bf16
              with random weights (a first, counted run, then a timed
              one).  Gates: the bytes the allocator was asked for while
              the step's arguments were built equal the planner's
              argument_bytes (a prediction check), and the op counter
              over the card's step counts exactly the meta trace's flops
              (a dispatch-parity check: the same counter over the same
              step code, so it fails only if CUDA dispatches other aten
              ops than meta).  Reported: the peak the step allocated
              against the predicted peak_bytes; its CUDA-event ms against
              the eager-traffic bound (the op counter's unfused bytes and
              flops at H100 rates) and against the floor (every argument
              read once, or the model flops, at H100 rates).
5. cocoa    — the paper's GLM at HIGGS's shape: CoCoA/SCD on the uni-task
              engine over 11,000,000 x 28 synthetic samples in 1,100
              chunks, lambda 1e-3, scaling in 16 -> 2 over 12 iterations
              through the SCD kernel, every launch on the blocked kernel;
              then 6 iterations with RebalancePolicy, 4 of 16 workers at
              twice the per-sample time.  Gap, K, wall and kernel time per
              iteration.
   cocoa_wide — the same two schedules at the paper GLM's width (F =
              256, GLMConfig.num_features) over 1,000,000 samples from
              make_svm_data (seed 0), every SCD launch on the wide kernel,
              the cocoa gates (gap falls, chunks conserved, alpha never
              reset, K ends at 2, the rebalance's max task time falls),
              kernel ms per iteration against the pass's chain (59.5
              cycles a step) and byte bounds; then
              examples/cocoa_svm_torch.py and
              examples/load_balancing_torch.py once each (F = 128), every
              SCD launch on the wide kernel and each example's checks
              passing.
   examples — the port's other five examples, each once at its own
              size as its command line runs it (quickstart_torch,
              train_elastic_lm_torch --quick: its full 300-step run took
              37.8-54.2 s, over the 45 s this phase allows it,
              elastic_remesh_torch, serve_decode_torch,
              disagg_serve_torch), each ending on its own "OK" line:
              serve_decode (flat layout) launches no paged attention,
              disagg_serve launches it in both pools (prefill chunks and
              decode spans, layers x each pool's dispatches, on the
              launcher's routes); then disagg_serve_torch at full
              h2o-danube-1.8b width in fp32 (the streams phase's
              weights): its disaggregated streams bit-identical to its
              flat oracle (else the first divergence and its top-2
              margin), every request handed off once.  Wall seconds,
              first and last printed line, launches by route.
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
7b. flash_train — the training step's attention at danube.train.seq4k's
              shape (B=12, S=4096, KV=8, G=4, hd=80, bf16, causal, window
              4096): the forward that writes the log-sum-exp and the
              backward kernel against their plain versions (two batch
              rows; dq/dk/dv within 2^-7 of their largest element, lse
              1e-4), the backward bit-equal across two calls, one launch
              each; then their times, bounds and the plain backward's.
8. lm_train — the LM trainer `launch.train.train` on h2o-danube-1.8b at
              the 100m preset: 20 steps, workers 4 -> 2 at step 4,
              rebalancing, 2 of 4 workers at twice the per-sample time.
9. lm_elastic — ElasticTrainer on h2o-danube-1.8b at full width and depth
              (bf16, sgdm, remat) on batches of 8 x 4096 tokens from
              ChunkBatchPipeline: 2 steps, K 4 -> 2 at step 1, suspended
              to the host after step 1, the first at K 2, and resumed
              (the state must come back bit for bit); every step's 24
              layers on the flash route (48 tensor-core forwards, 24
              backwards); then, under deterministic algorithms, a
              suspended run against an uninterrupted one (bit-equal).
10. timing  — each kernel, its plain version, its bound and its library
              yardstick at the main path's shapes, the wide SCD kernel at
              K=16, M=4,096 and F in {128, 256, 2000} beside its cost
              model and cycles a step, the row SCD kernel at K=2,
              M=1,024, F in {8192, 65536} (the paged shapes also
              held within one bf16 ulp of the fp32 plain result; their
              times are profiler device time, since CUDA events over
              back-to-back calls of the split route measure the host),
              then the `kernels` line.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or outside
a checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
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
FLAT_PROFILED = (ARCH,)  # flat runs profiled (smollm's is left out: time)
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
PROFILE_TICKS = 16  # (c)'s profiled window: the storm and the breaker
SCALE_EVENTS = [(0, 1), (10, 2), (25, 1)]  # the engine burst's k 1 -> 2 -> 1
# the overlap phase: (b) times the engine burst synchronously (False) and
# overlapped (True) in turns, so the host's drift falls on both arms; its
# traced run profiles DECODE_WINDOW ticks in which all 8 slots decode and
# nothing else runs; (c) holds the stream for RING_HOLD_S while RING + 4
# buffers are packed behind it
OVERLAP_ORDER = (False, True, True, False)
DECODE_WINDOW = 5
RING_HOLD_S = 0.1
# the disagg phase's (a2): three workers, the prefill pool 1 -> 2 -> 1 at
# ticks 2 and 5 (tests/test_disagg.py's schedule)
DISAGG_SPLIT = [(2, 2), (5, 1)]
# the cluster phase: the pool's nodes are simulated on the one card.  (a1)
# a ServeJob (2 slots a node, up to 4 nodes) takes the engine burst at
# t = 0 with chunks of 256 (prefill_bucket 256); a higher-priority CoCoA
# job (HIGGS's F = 28; n cut from 11,000,000 to 1,100,000) arrives at t = 2,
# takes 3 of the 4 nodes and parks 6 decoding slots; its sample time makes
# an iteration on 3 nodes about one simulated second, so the server gets
# its nodes back after 8.  (a2) a DisaggServeJob on 3 nodes (at least 2
# while it has work) loses one to a CoCoA hog at t = 2 that outlasts it:
# one lease change.  (a3) an LMTrainJob at danube's 100m preset on one
# node, scaled to zero by a CoCoA hog at t = 2 and resumed when it ends.
# (b) is (a1)'s trace in bf16.
CLUSTER = dict(nodes=4, squeeze_at=2.0, slots_per_node=2,
               serve=dict(capacity=8, cache_len=2048, prefill_bucket=256,
                          page_size=16),
               cocoa=dict(n=1_100_000, f=28, chunk=1000, lam=1e-3,
                          k_tasks=16, iterations=8, sample_time=2.5e-6,
                          max_nodes=3, priority=1),
               hog=dict(n=110_000, f=28, chunk=1000, lam=1e-3),
               disagg_nodes=3, lm_steps=6, lm_batch=8, lm_seq=128)
# the moe phase: grok-1-314b at its published widths (48 heads over 8 KV:
# G 6, hd 128; 8 experts, top-2, d_ff 32768; vocab 131072), its 64
# layers cut to 2 for the fp32 gates (42.6 GB of weights) and 4 for the
# bf16 timing (41.0 GB; the layer pattern's period is one layer)
MOE_ARCH = "grok-1-314b"
MOE_LAYERS = {"float32": 2, "bfloat16": 4}
# training path (phases cocoa and lsgd)
COCOA = dict(n=11_000_000, features=28, chunk_size=10_000, lam=1e-3, k0=16,
             iters=12, rebalance_iters=6)
LSGD = dict(n_train=50_000, n_test=10_000, image_size=32, chunk_size=50,
            k0=16, iters=24, eval_every=8)
# the paper GLM's width (configs/chicle_paper.py GLMConfig.num_features)
# on the same two schedules, through the wide SCD kernel (phase cocoa_wide)
COCOA_WIDE = dict(n=1_000_000, features=256, chunk_size=10_000, lam=1e-3,
                  k0=16, iters=12, rebalance_iters=6)
SLOW = [2.0] * 4 + [1.0] * 12  # per-sample times: 4 of 16 workers at 2x
SCD_PATH_M = 4096  # the plain version steps M times from Python
TOL_SCD = 1e-5
TOL_MERGE = {"float32": 1e-5, "bfloat16": 3e-2}
# the chain model of the blocked and wide SCD kernels (one chain, whatever
# F is): per step the q update (FFMA), grad (FFMA), the quotient (FMUL and
# two FFMA), the clip (FADD.SAT), a_new - alpha (FADD), s (FMUL), then the
# broadcast (SHFL.IDX).  Latencies measured with clock64 on one warp by
# scripts/scd_chain_probe.py on an H100 80GB HBM3 (PERF.md): FMA-class
# 4.25 cycles, SHFL.IDX 25.5 (assumed before they were measured: 4 and
# 23); the step alone measured 57.6
SCD_CHAIN_CYCLES = 8 * 4.25 + 25.5
SCD_LONG = (2, 32_768, 28)  # a long chain at the path's width
SCD_WIDE_F = (128, 256, 2000)  # the timing phase's widths of the wide kernel
SCD_ROW_SHAPES = ((2, 1024, 8192), (2, 1024, 65536))  # (K, M, F), row kernel
# spans of >= 16 rows at other head dims and windows: QG 16 at hd 64 with
# a window (bf16: the verify route), QG 64 at hd 128 (bf16: the
# tensor-core kernel)
TC_PAGED_CASES = [(3, 2, 4, 64, 16, 8, 40, 4), (2, 2, 1, 128, 16, 8, 0, 64)]
# spans of <= 16 rows with their lengths (the split route, runs of 64
# keys): length 0, shorter than a run, one run, exactly P * ps; a window
# starting inside a run; q_span 3 (12 rows) and 4 (16 rows at hd 32)
SPLIT_PAGED_CASES = [((4, 2, 4, 80, 16, 8, 0, 1), [0, 5, 64, 128]),
                     ((3, 2, 4, 80, 16, 16, 40, 1), [200, 77, 256]),
                     ((3, 2, 4, 64, 16, 8, 0, 3), [3, 70, 128]),
                     ((2, 2, 4, 32, 8, 20, 24, 4), [9, 160]),
                     # grok-1-314b's heads (G 6, hd 128): decode (QG 6)
                     # and a 2-position span (QG 12)
                     ((4, 8, 6, 128, 16, 8, 0, 1), [0, 5, 64, 128]),
                     ((3, 8, 6, 128, 16, 16, 40, 2), [200, 77, 256])]
# bf16 spans of G < QG <= 32 rows (the verify route: runs of 512 keys in
# stages of 128) with their lengths: an inactive row, a length shorter
# than one stage, exactly one run and exactly P * ps; windows whose first
# visible key falls inside a run; QG 32 at hd 64 (G 8, q_span 4) and at
# hd 128 (G 16, q_span 2); q_span 2 at G 4
VERIFY_PAGED_CASES = [((4, 2, 4, 80, 16, 64, 0, 5), [0, 7, 512, 1024]),
                      ((3, 2, 4, 80, 16, 40, 300, 2), [640, 333, 257]),
                      ((3, 2, 8, 64, 16, 24, 0, 4), [384, 4, 200]),
                      ((2, 2, 16, 128, 16, 40, 0, 2), [129, 640]),
                      ((3, 2, 6, 128, 16, 64, 100, 3), [0, 700, 512])]
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
# the training step's attention (danube.train.seq4k's micro-batch): the
# forward that writes the log-sum-exp and the backward kernel
FLASH_TRAIN = dict(B=12, S=4096, iters=5)
# LM training (phases lm_train and lm_elastic)
LM_TRAIN = dict(scale="100m", train_steps=20, elastic="4:2", rebalance=True,
                hetero="2.0x2", workers=4, seed=0)
LM_ELASTIC = dict(batch=8, seq=4096, n_seqs=256, chunk_size=8, k0=4,
                  scale_at=1, k1=2, steps=2, suspend_after=1, det_steps=2)
# the remaining model families (phase families): each model at its
# published widths, random weights from a seed; "gate" is the fp32 check
# (prefill of `prompt`, then `decode` decode_steps against forward over
# prompt + decode), "bf16" the reported run (B prompts of `prompt` tokens,
# `steps` greedy decode steps), "train" steps of B x seq tokens
FAMILY_RUNS = {
    "rwkv6-1.6b": dict(layers=None, gate=dict(B=2, prompt=128, decode=64,
                                              state_prompt=32,
                                              state_whole=48),
                       bf16=dict(B=8, prompt=1024, steps=32),
                       train=dict(B=8, seq=1024, steps=2)),
    "whisper-small": dict(layers=None,
                          gate=dict(B=2, prompt=128, decode=64),
                          bf16=dict(B=4, prompt=448, steps=32),
                          train=dict(B=4, seq=448, steps=2)),
    # one block of 5 (4 self-attention + 1 cross-attention layers) of 100
    "llama-3.2-vision-90b": dict(layers=5,
                                 gate=dict(B=2, prompt=128, decode=64),
                                 bf16=dict(B=2, prompt=512, steps=16),
                                 train=None),
}
# jamba-1.5-large-398b: one mamba mixer at its published widths (a whole
# 8-layer block holds 77.3 GB of bf16 experts; the model runs on the CPU)
JAMBA_MIXER = dict(arch="jamba-1.5-large-398b", B=2, S=1024)
# tests/test_arch_smoke.py::test_prefill_matches_decode's tolerance:
# chunked prefill against stepwise decode
FAMILY_TOL = dict(rtol=2e-2, atol=1e-1)
FAMILY_CROSS_GATE = 0.5  # vlm's cross gate (zeros at init: no cross-attn)
FAMILY_DECODE_WINDOW = 3  # bf16 decode steps profiled
# the planner's pairs held against the card: (arch, input shape, batch cut)
DRYRUN = [("rwkv6-1.6b", "decode_32k", None),
          ("h2o-danube-1.8b", "long_500k", None),
          ("qwen3-4b", "long_500k", None),
          ("h2o-danube-1.8b", "train_4k", 2)]


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


def paged_counts(counted):
    """(launches, tensor-core, split-KV, verify) counts of the wrapper."""
    return (counted.launches, counted.launches_tc, counted.launches_split,
            counted.launches_verify)


def zero_paged(counted):
    counted.launches = counted.launches_tc = counted.launches_split = 0
    counted.launches_verify = 0


def took(before, after) -> str:
    """The route of the one launch between two `paged_counts`."""
    d = [a - b for a, b in zip(after, before)]
    if d[0] != 1:
        return f"{d[0]} launches"
    return {(0, 0, 0): "cuda_core", (1, 0, 0): "tc", (0, 1, 0): "split",
            (0, 0, 1): "verify"}.get(tuple(d[1:]), f"counts {d}")


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


def verify_shapes(np):
    """The four bf16 verify spans the `timing` phase and the moe phase's
    `moe_kernel_checks` time, B=8 over the engine's pool, with the live
    lengths they draw (their draws, in their order): name -> ((KV, G,
    hd, window), q_span, lengths).  For the scripts that time the verify
    route outside this script."""
    dr = np.random.default_rng(0)  # main(): decode, chunk, verify, shrink
    dr.integers(33, 1569, size=8)
    dr.integers(1, 7, size=4)
    dv, ds = dr.integers(37, 1573, size=8), dr.integers(35, 1571, size=8)
    lo, hi = PROMPT_LEN
    gr = np.random.default_rng(20)  # moe_kernel_checks: decode, verify, ...
    gr.integers(lo + 1, hi + 33, size=8)
    gv = gr.integers(lo + 5, hi + 37, size=8)
    gs = gr.integers(lo + 3, hi + 35, size=8)
    danube, grok = (8, 4, 80, 4096), (8, 6, 128, 0)
    return {"verify": (danube, SPEC_K + 1, dv),
            "verify_shrink": (danube, SPEC_K // 2 + 1, ds),
            "verify hd128": (grok, SPEC_K + 1, gv),
            "verify_shrink hd128": (grok, SPEC_K // 2 + 1, gs)}


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
        # the program's spans are profiler ranges, mirrored on the device's
        # timeline over its kernels: not device work
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
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


def device_ms(torch, fn, iters, attempts=3, records=None):
    """Device time per call of `fn` from torch.profiler: the time of the
    kernels it launches, without the host's launch gaps (which bound a
    back-to-back loop of a microsecond kernel).  The profiler can drop
    records, so each kernel is averaged over its own recorded launches
    and counted as often per call as it was recorded per call (appended
    to `records`, kernel -> recorded launches, when given); a window
    with no device record at all is profiled again, up to `attempts`
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and not e.is_user_annotation]
        if dev:
            break
    else:
        fail(f"torch.profiler recorded no device time for a kernel timing "
             f"in {attempts} tries")
    if records is not None:
        records.append({e.key: e.count for e in dev})
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / iters)) for e in dev) / 1e3


def rotating_device_ms(torch, fn, inputs, window, iters, records=None):
    """`device_ms` of `fn` on the paged inputs in rotation (their pools
    together exceed the L2 cache, so each call reads its pages from
    HBM)."""
    it = iter(range(1 << 30))
    return device_ms(torch, lambda: call(
        fn, inputs[next(it) % len(inputs)], window), iters,
        records=records)


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


def scd_wide_model(F, wide_rows):
    """SM cycles a step of the wide SCD kernel's cost model (PERF.md §6,
    PR 25): max(chain, producers) + boundary, the producers' lower Gram
    in 4 x 4 tiles on shared-load bandwidth (T F / 4 cycles a block of B
    rows, T tiles), the boundary 2 B F floats of shared loads plus ~300
    cycles of hand-offs a block."""
    B = wide_rows(F)
    T = (B // 4) * (B // 4 + 1) // 2
    return max(SCD_CHAIN_CYCLES, T * F / (4 * B)) + F / 16 + 300 / B


def scd_counts(scd_pass):
    return (scd_pass.launches_blocked, scd_pass.launches_wide,
            scd_pass.launches_row)


def check_scd(torch, np, scd_pass, scd_pass_plain, scd_mod):
    """The SCD kernels against their plain version: the JAX test's shapes,
    the CoCoA paths' (K=16, F in {28, 128, 256}, M cut to SCD_PATH_M), the
    wide kernel's other block sizes (F = 65 and 256: 32 rows, 1100 and
    2048: 8, 4096: 4), the row kernel's (F = 4097, 4100, 8192, 65536), a
    long chain (SCD_LONG), and rows the kernels cannot read as they are,
    which the wrapper copies into an aligned buffer: F=30 (not a multiple
    of 4), F=28 and F=256 with x a view 4 bytes past 16-byte alignment.
    Each launch takes the kernel `takes_blocked`, `takes_wide` or
    `takes_row` names."""
    rng = np.random.default_rng(1)
    cases = [(k, m, f, int(rng.integers(0, 6)), False, 10.0, False)
             for k in (1, 2, 3, 4) for m in (16, 64) for f in (8, 32)]
    lam_n = float(np.float32(COCOA["lam"]) * np.float32(COCOA["n"]))
    cases += [(16, SCD_PATH_M, f, 7, True, lam_n, False)
              for f in (28, 128, 256)]
    cases += [(2, 777, 65, 5, False, 10.0, False),
              (2, 333, 1100, 3, False, 10.0, False),
              (2, 250, 2048, 3, False, 10.0, False),
              (1, 99, 4096, 2, False, 10.0, False)]
    # the row kernel (F > 4096): v in shared memory, and at F = 65,536 in
    # the worker's v_out row
    cases += [(1, 256, 4097, 3, True, lam_n, False),
              (2, 200, 4100, 5, True, lam_n, False),
              (2, 256, 8192, 0, False, 10.0, False),
              (2, 128, 65536, 4, True, lam_n, False)]
    cases += [(*SCD_LONG, 0, True, lam_n, False),
              (16, SCD_PATH_M, 30, 7, True, lam_n, False),
              (16, SCD_PATH_M, 28, 7, True, lam_n, True),
              (16, SCD_PATH_M, 256, 7, True, lam_n, True)]
    worst, out = 0.0, []
    for K, M, F, masked, unit_rows, ln, offset in cases:
        x, y, alpha, w, mask = scd_inputs(torch, np, rng, K, M, F, masked,
                                          unit_rows=unit_rows)
        if offset:  # the same rows at a base 4 bytes past alignment
            flat = torch.empty(x.numel() + 1, device=DEVICE)
            flat[1:] = x.flatten()
            x = flat[1:].view(K, M, F)
        sigma = torch.full((K,), float(K), device=DEVICE)
        before = scd_counts(scd_pass)
        got = scd_pass(x, y, alpha, w, mask, ln, sigma)
        torch.cuda.synchronize()
        blocked, wide, row = (a - b for a, b in zip(scd_counts(scd_pass),
                                                    before))
        if (blocked, wide, row) != (scd_mod.takes_blocked(F),
                                    scd_mod.takes_wide(F),
                                    scd_mod.takes_row(F)):
            fail(f"scd case K={K} M={M} F={F} offset={offset}: {blocked} "
                 f"blocked, {wide} wide and {row} row launches")
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
                    "wide": wide, "row": row, "max_abs_err": err})
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


def cocoa_phase(torch, np, c=None, route="blocked", phase="cocoa",
                profile=True):
    """CoCoA/SCD through the kernel at config `c` (default COCOA, HIGGS's
    shape; COCOA_WIDE, the paper GLM's width, for `cocoa_wide`): a 16 -> 2
    scale-in, then a rebalancing run with 4 slow workers; every SCD launch
    must take the `route` kernel ("blocked" or "wide")."""
    c = c or COCOA
    from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                                  ElasticScalingPolicy, RebalancePolicy,
                                  ScaleEvent, UniTaskEngine)
    from repro_torch.data import make_svm_data
    from repro_torch.kernels import ops
    from repro_torch.kernels.scd import scd_pass
    t0 = time.perf_counter()
    x, y = make_svm_data(c["n"], c["features"], seed=0)
    data_s = time.perf_counter() - t0
    clock = sm_clock_hz()
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
                fail(f"{phase} {name}: chunks not conserved")
            nnz = int(np.count_nonzero(store.state["alpha"]))
            if rows and nnz < rows[-1]["alpha_nonzero"] // 2:
                fail(f"{phase} {name}: alpha was reset ({nnz} nonzero "
                     f"after {rows[-1]['alpha_nonzero']})")
            K, M = asg.n_workers, int(out["per_worker_samples"].max())
            rows.append({"K": K, "M": M, "wall_s": wall,
                         "kernel_ms": log[-1][0].elapsed_time(log[-1][1]),
                         "chain_bound_ms": SCD_CHAIN_CYCLES * M / clock
                         * 1e3,
                         "bound_ms": bound(*scd_work(K, M,
                                                     c["features"]))[0],
                         "alpha_nonzero": nnz})
            return out

        real = kernel_timer(torch, ops, "scd_local_pass", log)
        try:
            scd_pass.launches = scd_pass.launches_blocked = 0
            scd_pass.launches_wide = scd_pass.launches_row = 0
            t0 = time.perf_counter()
            hist = eng.run(iters, step, solver.metric)
            run_s = time.perf_counter() - t0
            launches = scd_pass.launches
            routed = getattr(scd_pass, f"launches_{route}")
        finally:
            ops.scd_local_pass = real
        for r, h in zip(rows, hist):
            r["gap"] = h.metric
            r["max_task_time"] = max(h.task_times.values())
        gaps = [h.metric for h in hist]
        if not all(math.isfinite(g) for g in gaps) or gaps[-1] >= gaps[0]:
            fail(f"{phase} {name}: the duality gap did not fall: {gaps}")
        if launches != iters or routed != launches:
            fail(f"{phase} {name}: {launches} scd launches in {iters} "
                 f"iterations, {routed} of them on the {route} kernel")
        if name == "scale_in" and hist[-1].n_workers != 2:
            fail(f"{phase} scale_in ended at K={hist[-1].n_workers}")
        if name == "rebalance" and \
                rows[-1]["max_task_time"] >= rows[0]["max_task_time"]:
            fail(f"{phase} rebalance: the max task time did not fall")
        results[name] = {"launches": launches, f"launches_{route}": routed,
                         "run_s": run_s, "iterations": rows}
        if profile and name == "rebalance":  # one more K=16 iteration
            emit({"phase": "profile", "cell": phase, "K": a.n_workers,
                  **profile_run(torch, lambda: solver.step(store, a),
                                kernel=f"scd_{route}_kernel", attempts=3),
                  "host_top": host_profile(
                      torch, lambda: solver.step(store, a))})
        emit({"phase": phase, "run": name, "n": c["n"],
              "features": c["features"], "chunks": store.n_chunks,
              "lam": c["lam"], "data_s": data_s, "run_s": run_s,
              "scd_launches": launches, f"scd_launches_{route}": routed,
              "kernel_ms_total": sum(r["kernel_ms"] for r in rows),
              "sm_clock_mhz": clock / 1e6, "iterations": rows,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del solver, eng, store
        torch.cuda.empty_cache()
    return results


def load_example(name):
    """examples/<name>.py of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cocoa_wide_phase(torch, np):
    """The `cocoa` phase's two schedules at the paper GLM's width through
    the wide SCD kernel, then examples/cocoa_svm_torch.py and
    examples/load_balancing_torch.py once each at their own sizes (F =
    128), every SCD launch on the kernel its width names and each
    example's own checks passing (its printed lines kept, not shown)."""
    import contextlib
    import io
    from repro_torch.kernels.scd import scd_pass
    t0 = time.perf_counter()
    res = cocoa_phase(torch, np, COCOA_WIDE, route="wide",
                      phase="cocoa_wide", profile=False)
    examples = {}
    for name in ("cocoa_svm_torch", "load_balancing_torch"):
        mod = load_example(name)
        scd_pass.launches = scd_pass.launches_blocked = 0
        scd_pass.launches_wide = scd_pass.launches_row = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.run(DEVICE)
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        n, wide = scd_pass.launches, scd_pass.launches_wide
        if not n or wide != n or "OK" not in lines[-1]:
            fail(f"cocoa_wide {name}: {n} SCD launches, {wide} wide; last "
                 f"line {lines[-1:]}")
        examples[name] = {"wall_s": time.perf_counter() - t,
                          "scd_launches": n, "scd_launches_wide": wide,
                          "first_line": lines[0], "last_line": lines[-1]}
    emit({"phase": "cocoa_wide", "run": "examples", "examples": examples,
          "phase_s": time.perf_counter() - t0})
    res["examples"] = examples
    return res


# the five examples the `examples` phase runs at their own sizes, with the
# keywords of their command lines: train_elastic_lm as --quick (its full
# 300-step run takes 38-54 s on an H100, past the 45 s the phase gives it)
EXAMPLES = ("quickstart_torch", "train_elastic_lm_torch",
            "elastic_remesh_torch", "serve_decode_torch",
            "disagg_serve_torch")
EXAMPLE_KW = {"train_elastic_lm_torch": dict(quick=True)}


def example_run(torch, paged_mod, mod, on_log=None, **kw):
    """`mod.run(DEVICE, **kw)` with its printed lines captured and the
    paged-attention launches counted (zeroed just before, read just
    after; `on_log(log)` gets the launch log first); fail unless its last
    line is its "... OK" line.  -> (what it returns, a record: wall
    seconds, first and last printed line, launches and their routes)."""
    import collections
    import contextlib
    import io
    buf = io.StringIO()
    t = time.perf_counter()

    def go(log):
        if on_log is not None:
            on_log(log)
        with contextlib.redirect_stdout(buf):
            return mod.run(DEVICE, **kw)
    out, n, log = counted_launches(paged_mod, go)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    if not lines or "OK" not in lines[-1]:
        fail(f"examples {mod.__name__}: last line {lines[-1:]}")
    return out, {
        "wall_s": time.perf_counter() - t, "first_line": lines[0],
        "last_line": lines[-1], "paged_launches": n[0],
        "paged_routes": dict(collections.Counter(r for _, r in log)),
        "paged_counts": list(n)}


def disagg_example_run(torch, np, M, paged_mod, mod, what, **kw):
    """examples/disagg_serve_torch.py's `run` through `example_run`, its
    DisaggEngine's launches split into pools and checked as the disagg
    phase checks them (`check_pool_launches`), its streams against its
    flat oracle's; where they differ (or the example's own check fails),
    the first divergence and its top-2 margin are emitted before the
    phase fails.  -> the record."""
    built, marks, logs = {}, [], []
    base_eng, base_dis = mod.ServeEngine, mod.DisaggEngine

    class Oracle(base_eng):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built["oracle"] = self

    class Marked(base_dis):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built["disagg"] = self
            mark_pool_ticks(self, logs[0], marks)

    mod.ServeEngine, mod.DisaggEngine = Oracle, Marked
    err = None
    try:
        (m, want), rec = example_run(torch, paged_mod, mod,
                                     on_log=logs.append, **kw)
    except AssertionError as e:
        err, m = e, built["disagg"].metrics if "disagg" in built else None
        want = streams(built["oracle"].metrics) if "oracle" in built \
            else None
    finally:
        mod.ServeEngine, mod.DisaggEngine = base_eng, base_dis
    oracle = built.get("oracle")
    div = None if m is None or want is None else first_divergence(
        torch, np, M, oracle.cfg, oracle.params, streams(m), want,
        {r.rid: r.prompt for r in m.requests})
    if err is not None or div is not None:
        emit({"phase": "examples", "run": what, "equal": div is None,
              "error": str(err), **(div or {})})
        fail(f"examples {what}: {err or 'streams differ from the oracle'}"
             + (f" at request {div['rid']} step {div['step']}" if div
                else ""))
    n = tuple(rec["paged_counts"])
    rec["by_pool"] = check_pool_launches(what, built["disagg"], m, n,
                                         logs[0], marks)
    s = m.summarize()
    rec.update(streams_equal_flat_oracle=True,
               requests=s["requests_finished"],
               tokens=s["tokens_generated"],
               handoffs=s["disagg"]["handoffs"],
               handoff_bytes=s["disagg"]["handoff_bytes"],
               split_events=s["disagg"]["split_events"],
               tokens_per_s=s["tokens_per_s"], ttft_p50_s=s["ttft_p50_s"])
    if not n[0] or rec["handoffs"] != rec["requests"]:
        fail(f"examples {what}: {n[0]} paged_attention launches, "
             f"{rec['handoffs']} handoffs for {rec['requests']} requests")
    return rec


def examples_phase(torch, np, M, cfg32, params32, paged_mod):
    """The port's five examples beside the JAX package's (quickstart,
    train_elastic_lm, elastic_remesh, serve_decode, disagg_serve), each once
    at its own size as its command line runs it on the card (no --fast;
    train_elastic_lm --quick, `EXAMPLE_KW`), each printing its own `... OK`
    last line; serve_decode (the flat layout) must launch no paged
    attention, disagg_serve must launch it in both pools.  Then
    disagg_serve at h2o-danube-1.8b's full width in fp32 (`cfg32`,
    `params32`: the streams phase's weights), its flat oracle and streams
    bit-identical.  -> launches by run and route."""
    t0 = time.perf_counter()
    runs = {}
    for name in EXAMPLES:
        mod = load_example(name)
        kw = EXAMPLE_KW.get(name, {})
        if name == "disagg_serve_torch":
            runs[name] = disagg_example_run(torch, np, M, paged_mod, mod,
                                            name, **kw)
            continue
        try:
            runs[name] = {**example_run(torch, paged_mod, mod, **kw)[1], **kw}
        except AssertionError as e:
            fail(f"examples {name}: {e}")
    if runs["serve_decode_torch"]["paged_launches"]:
        fail(f"examples serve_decode_torch: "
             f"{runs['serve_decode_torch']['paged_launches']} "
             f"paged_attention launches on the flat layout")
    full = disagg_example_run(torch, np, M, paged_mod,
                              load_example("disagg_serve_torch"),
                              f"disagg_serve_torch at {ARCH} fp32",
                              cfg=cfg32, params=params32)
    emit({"phase": "examples", "own_size": runs,
          "disagg_serve_torch_full_width": {
              "arch": ARCH, "dtype": cfg32.dtype, **full},
          "phase_s": time.perf_counter() - t0})
    by_run = {name: r["paged_launches"] for name, r in runs.items()}
    by_run[f"disagg_serve_torch@{ARCH}_fp32"] = full["paged_launches"]
    counts = [runs["disagg_serve_torch"]["paged_counts"],
              full["paged_counts"]]
    return {"launches": sum(by_run.values()),
            "launches_tc": sum(c[1] for c in counts),
            "launches_split": sum(c[2] for c in counts),
            "launches_verify": sum(c[3] for c in counts),
            "by_run": by_run,
            "routes": {"own_size": runs["disagg_serve_torch"][
                "paged_routes"], "full_width": full["paged_routes"]}}


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
                    weighted_merge_plain, scd_mod):
    """Kernel, plain version, bound and yardstick for the SCD and merge
    kernels at the training paths' shapes (the wide SCD kernel at K=16,
    M=4,096 and F in SCD_WIDE_F, against its cost model too)."""
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
    # the wide kernel at K=16, M cut to SCD_PATH_M: the paper's F = 128
    # and 256, and F = 2000 (8-row blocks), each on the route it must take
    scd["wide"] = []
    for F in SCD_WIDE_F:
        K, M = COCOA_WIDE["k0"], SCD_PATH_M
        x = torch.randn(K, M, F, device=DEVICE, generator=gen)
        x /= x.norm(dim=-1, keepdim=True)
        y = torch.where(torch.rand(K, M, device=DEVICE, generator=gen)
                        > 0.5, 1.0, -1.0)
        args = (x, y, torch.zeros(K, M, device=DEVICE),
                0.1 * torch.randn(F, device=DEVICE, generator=gen),
                torch.ones(K, M, device=DEVICE), lam_n,
                torch.full((K,), float(K), device=DEVICE))
        n_wide = scd_pass.launches_wide
        runs = [cuda_ms(torch, lambda: scd_pass(*args), iters=20)
                for _ in range(2)]
        if scd_pass.launches_wide - n_wide != 42:
            fail(f"scd timing F={F}: {scd_pass.launches_wide - n_wide} of "
                 f"42 launches on the wide kernel")
        plain = cuda_ms(torch, lambda: scd_pass_plain(*args))
        b_ms, b_by = bound(*scd_work(K, M, F))
        model = scd_wide_model(F, scd_mod.wide_rows)
        ms = min(runs)
        scd["wide"].append({
            "shape": {"K": K, "M": M, "F": F}, "rows_a_block":
            scd_mod.wide_rows(F), "ms": ms, "ms_runs": runs,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "chain_bound_ms": SCD_CHAIN_CYCLES * M / clock * 1e3,
            "model_cycles_per_step": model,
            "model_ms": model * M / clock * 1e3,
            "ns_per_step": ms * 1e6 / M,
            "cycles_per_step": ms * 1e-3 * clock / M})
        del x, y, args
        torch.cuda.empty_cache()
    # the row kernel (F > 4096): v in shared memory (F = 8192) and in the
    # worker's v_out row (F = 65,536)
    scd["row"] = []
    for K, M, F in SCD_ROW_SHAPES:
        x = torch.randn(K, M, F, device=DEVICE, generator=gen)
        x /= x.norm(dim=-1, keepdim=True)
        y = torch.where(torch.rand(K, M, device=DEVICE, generator=gen)
                        > 0.5, 1.0, -1.0)
        args = (x, y, torch.zeros(K, M, device=DEVICE),
                0.1 * torch.randn(F, device=DEVICE, generator=gen),
                torch.ones(K, M, device=DEVICE), lam_n,
                torch.full((K,), float(K), device=DEVICE))
        n_row = scd_pass.launches_row
        runs = [cuda_ms(torch, lambda: scd_pass(*args), iters=5)
                for _ in range(2)]
        if scd_pass.launches_row - n_row != 12:
            fail(f"scd timing F={F}: {scd_pass.launches_row - n_row} of "
                 f"12 launches on the row kernel")
        plain = cuda_ms(torch, lambda: scd_pass_plain(*args))
        b_ms, b_by = bound(*scd_work(K, M, F))
        ms = min(runs)
        scd["row"].append({
            "shape": {"K": K, "M": M, "F": F}, "ms": ms, "ms_runs": runs,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "us_per_step": ms * 1e3 / M})
        del x, y, args
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
    with torch.no_grad():  # the query-blocked path (bf16 on the card
        # takes the flash route itself)
        want = attn._blocked_attention(cfg, q5.reshape(B, S, HP, hd), k4,
                                       v4, causal=True, window=win,
                                       q_block=512)
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


def flash_bwd_work(np, B, S, H, KV, hd, window, causal):
    """(bytes, flops) of one backward call: q, out, dout and dq (B H S hd),
    k, v, dk and dv (B KV S hd) in bf16 and the fp32 log-sum-exp, each once;
    8*hd flops per visible (query, key) pair (dP = dO V^T, dV = P^T dO,
    dQ = dS K, dK = dS^T Q; the scores recomputed are not counted)."""
    _, flops = flash_work(np, B, S, H, KV, hd, window, causal, 2)
    nbytes = (4 * B * H * S * hd + 4 * B * KV * S * hd) * 2 + B * H * S * 4
    return nbytes, 2 * flops


def flash_train_phase(torch, np, cfg):
    """The training step's attention at danube.train.seq4k's shape
    (FLASH_TRAIN, h2o-danube-1.8b's heads, causal, window 4096, bf16): the
    forward that also writes the log-sum-exp (held to the plain scores'
    logsumexp) and the backward kernel, held to its plain version on the
    fp32-cast inputs (two batch rows, dq/dk/dv within 2^-7 of their largest
    element), bit-equal across two calls, one launch a call; then their
    times beside their bounds and the plain backward's."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    KV, G, hd = cfg.kv_heads(), cfg.num_heads // cfg.kv_heads(), \
        cfg.head_dim_()
    B, S, iters = FLASH_TRAIN["B"], FLASH_TRAIN["S"], FLASH_TRAIN["iters"]
    win = cfg.sliding_window
    kw = dict(causal=True, window=win, group_size=G)
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    q, k, v = flash_inputs(torch, gen, B, S, KV, G, hd, torch.bfloat16)
    do = torch.randn(q.shape, device=DEVICE, generator=gen).to(q.dtype)
    n0 = flash_attention.launches_tc, flash_attention_bwd.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    launches = (flash_attention.launches_tc - n0[0],
                flash_attention_bwd.launches - n0[1])
    if launches != (1, 2):
        fail(f"flash_train: {launches[0]} tensor-core forward and "
             f"{launches[1]} backward launches (want 1 and 2)")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail("flash_train: two backward calls on the same inputs differ")
    del again
    errs = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for b in (0, B - 1):  # the plain version a batch row at a time
        qs, ks = (slice(b * KV * G, (b + 1) * KV * G),
                  slice(b * KV, (b + 1) * KV))
        _, want_lse = flash_attention_plain(
            q[qs].float(), k[ks].float(), v[ks].float(), return_lse=True,
            **kw)
        errs["lse"] = max(errs["lse"],
                          float((lse[qs] - want_lse).abs().max()))
        want = flash_attention_bwd_plain(
            q[qs].float(), k[ks].float(), v[ks].float(), out[qs].float(),
            want_lse, do[qs].float(), **kw)
        for name, g, w in zip(("dq", "dk", "dv"),
                              (grads[0][qs], grads[1][ks], grads[2][ks]),
                              want):
            e = float((g.float() - w).abs().max() / w.abs().max())
            errs[name] = max(errs[name], e)
        del want, want_lse
        torch.cuda.empty_cache()
    if not all(math.isfinite(e) for e in errs.values()) \
            or errs["lse"] > 1e-4 \
            or max(errs[n] for n in ("dq", "dk", "dv")) > 2.0 ** -7:
        fail(f"flash_train: the kernels against their plain versions {errs}")
    del grads
    torch.cuda.empty_cache()

    def fwd():
        flash_attention(q, k, v, return_lse=True, **kw)

    def bwd():
        flash_attention_bwd(q, k, v, out, lse, do, **kw)

    def plain_bwd():
        for b in range(B):
            qs, ks = (slice(b * KV * G, (b + 1) * KV * G),
                      slice(b * KV, (b + 1) * KV))
            flash_attention_bwd_plain(q[qs], k[ks], v[ks], out[qs], lse[qs],
                                      do[qs], **kw)

    f1, b1 = cuda_ms(torch, fwd, iters), cuda_ms(torch, bwd, iters)
    plain = cuda_ms(torch, plain_bwd)
    f2, b2 = cuda_ms(torch, fwd, iters), cuda_ms(torch, bwd, iters)
    _, f_flops = flash_work(np, B, S, KV * G, KV, hd, win, True, 2)
    b_bytes, b_flops = flash_bwd_work(np, B, S, KV * G, KV, hd, win, True)
    res = {"shape": {"B": B, "S": S, "KV": KV, "G": G, "hd": hd,
                     "window": win, "causal": True, "dtype": "bfloat16"},
           "launches_tc_fwd": launches[0], "launches_bwd": launches[1],
           "deterministic": True, "rel_err_vs_plain": errs,
           "fwd_lse_ms_runs": [f1, f2],
           "fwd_bound_ms": f_flops / PEAK_FLOPS["bfloat16"] * 1e3,
           "bwd_ms_runs": [b1, b2],
           "bwd_bound_ms": max(b_bytes / HBM_BYTES_PER_S,
                               b_flops / PEAK_FLOPS["bfloat16"]) * 1e3,
           "bwd_bound_by": "bytes" if b_bytes / HBM_BYTES_PER_S
           >= b_flops / PEAK_FLOPS["bfloat16"] else "operations",
           "bwd_flops": b_flops,
           "bwd_achieved_tflops": b_flops / min(b1, b2) / 1e9,
           "bwd_plain_ms": plain}
    emit({"phase": "flash_train", **res})
    del q, k, v, do, out, lse
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


def state_diff(torch, a, b) -> list:
    """Where two (params, momentum, step) host snapshots differ: one row
    [tree, leaf, elements that differ, largest |difference|] a leaf."""
    rows = [] if a[2] == b[2] else [["step", "", 1, abs(a[2] - b[2])]]
    for i, tree in ((0, "params"), (1, "momentum")):
        for k, x in a[i].items():
            if not torch.equal(x, b[i][k]):
                d = (x.float() - b[i][k].float()).abs()
                rows.append([tree, k, int((d != 0).sum()),
                             float(d.nan_to_num(float("inf")).max())])
    return rows


def lm_elastic_phase(torch, np):
    """ElasticTrainer on h2o-danube-1.8b at full width and depth: 2 steps of
    8 x 4096 tokens, K 4 -> 2 at step 1, suspended to the host after that
    step (a state that has just been scaled in) and resumed; then a suspended run against an uninterrupted one under
    deterministic algorithms."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
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
        n0 = flash_attention.launches_tc, flash_attention_bwd.launches
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # every layer's attention on the flash route: a forward and remat's
        # recomputation on the tensor cores, one backward
        flash = (flash_attention.launches_tc - n0[0],
                 flash_attention_bwd.launches - n0[1])
        if flash != (2 * cfg.num_layers, cfg.num_layers):
            fail(f"lm_elastic: step {it} launched {flash[0]} tensor-core "
                 f"flash forwards and {flash[1]} backwards (want "
                 f"{2 * cfg.num_layers} and {cfg.num_layers})")
        rows.append({"step": it, "K": k, "loss": m["loss"],
                     "grad_norm": m["grad_norm"], "step_s": dt,
                     "tokens_per_s": c["batch"] * c["seq"] / dt,
                     "flash_tc_fwd_launches": flash[0],
                     "flash_bwd_launches": flash[1]})
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
    def det_run(suspend):
        tr = ElasticTrainer(cfg, tc, seed=0, device=DEVICE)
        losses = []
        for it in range(c["det_steps"]):
            losses.append(tr.train_step(batches[it][1])["loss"])
            if suspend and it == 0:
                tr.suspend()
                tr.resume(1)
        state = state_on_host(tr, M)
        del tr
        torch.cuda.empty_cache()
        return state, losses

    try:
        (plain, plain_loss), (susp, susp_loss) = det_run(False), det_run(True)
        det_equal = same_state(torch, plain, susp)
        if not det_equal:
            # before failing, say where they differ and whether a second
            # uninterrupted run repeats the first one
            diff = state_diff(torch, plain, susp)
            again, again_loss = det_run(False)
            emit({"phase": "lm_elastic_det_mismatch",
                  "losses": {"uninterrupted": plain_loss,
                             "suspended": susp_loss,
                             "uninterrupted_again": again_loss},
                  "leaves_differing": len(diff), "leaves": diff[:40],
                  "uninterrupted_repeats": same_state(torch, plain, again),
                  "suspended_equals_repeat": same_state(torch, susp,
                                                        again)})
        del plain, susp
    finally:
        torch.use_deterministic_algorithms(was_det)
    if not det_equal:
        fail("lm_elastic: a suspended run and an uninterrupted one differ "
             "under deterministic algorithms (phase lm_elastic_det_mismatch "
             "says where)")
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
    zero_paged(paged_attention)
    metrics = eng.run(repetitive_requests(np, Request, vocab))
    launches, launches_tc, _, launches_verify = paged_counts(paged_attention)
    restore()
    s = metrics.summarize()
    from repro_torch.models.attention import head_layout
    G = head_layout(cfg)[2]  # the padded group
    rows = (SPEC_K + 1) * G  # q_span x padded group
    dispatches = s["decode_dispatches"] + s["prefill_dispatches_total"]
    if launches != cfg.num_layers * dispatches or launches <= 0:
        fail(f"spec: {launches} kernel launches for {dispatches} paged "
             f"dispatches of {cfg.num_layers} layers")
    # every verify span on the verify route, every chunk on the tensor
    # cores
    verify = [r for qg, r in span_log if qg == rows]
    wrong = [(qg, r) for qg, r in span_log
             if r != ("verify" if qg == rows else "tc")
             or r != paged_mod.route(getattr(torch, cfg.dtype), qg, G,
                                     cfg.head_dim_())]
    if len(verify) != cfg.num_layers * s["decode_dispatches"] or wrong \
            or len(span_log) != launches \
            or launches_verify != len(verify) \
            or launches_tc + launches_verify != launches:
        fail(f"spec routes: {len(verify)} verify launches for "
             f"{s['decode_dispatches']} verify dispatches of "
             f"{cfg.num_layers} layers, {launches_verify} on the verify "
             f"route and {launches_tc} tensor-core of {launches}; "
             f"misrouted (rows, route): {wrong[:5]}")
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
          "kernel_launches_verify": launches_verify,
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
            "launches_verify": launches_verify,
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
    launches = {}  # run -> (launches, tensor cores, split-KV, verify)
    seconds = {}
    t0 = time.perf_counter()

    def zero():
        zero_paged(paged_attention)

    def check_routes(log, dtype_name, where):
        wrong = [(qg, r) for qg, r in log
                 if r != paged_mod.route(getattr(torch, dtype_name), qg,
                                         G, hd)]
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
    # bf16 verify spans (q_span 5 and 3) on the verify route
    if sum(1 for qg, r in log if r == "verify") != sum(want_spans.values()) \
            or launches["overload_bf16"][3] != sum(want_spans.values()):
        fail(f"faults (c): {launches['overload_bf16'][3]} launches on the "
             f"verify route, want {sum(want_spans.values())}")
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
    n, tc, split, ver = (sum(v[i] for v in launches.values())
                         for i in range(4))
    return {"launches": n, "by_run": {k: v[0] for k, v in launches.items()},
            "launches_tc": tc, "launches_split": split,
            "launches_verify": ver,
            "verify_12_rows": part_b["verify_launches_by_rows"].get(
                (SPEC_K // 2 + 1) * G, 0)
            + part_c["verify_launches_by_rows"].get((SPEC_K // 2 + 1) * G,
                                                    0),
            "verify_12_rows_bf16": part_c["verify_launches_by_rows"].get(
                (SPEC_K // 2 + 1) * G, 0)}


def ring_gate(torch, np, packer):
    """Hold the stream with a device sleep of RING_HOLD_S, pack RING + 4
    buffers of distinct contents behind it (the ring wraps while the
    first copies still wait in the stream), and count on the device the
    copies that arrived intact.  -> (intact, packed, host seconds of the
    packs)."""
    n = packer.RING + 4
    torch.cuda.synchronize()
    torch.cuda._sleep(int(RING_HOLD_S * sm_clock_hz()))
    t0 = time.perf_counter()
    outs = [packer.pack([np.full(4096, i, np.int32)]) for i in range(n)]
    pack_s = time.perf_counter() - t0
    intact = int(torch.stack([(o == i).all()
                              for i, o in enumerate(outs)]).sum().item())
    return intact, n, pack_s


def overlap_phase(torch, np, M, cfg32, params32, want32, want_spec32,
                  ServeEngine, synthetic_requests, faults, scale_policy,
                  paged_mod, bf16_params):
    """The overlapped tick at full width, paged, through the kernel.  (a)
    fp32 gates: the engine burst (k 1 -> 2 -> 1), the same with
    spec="ngram" and faults (a)'s crash plan, each with overlap=True; their
    streams must equal the synchronous fp32 kernel streams `want32`,
    `want_spec32` (spec) and `want32` (crash); in every run the launches
    equal layers x paged dispatches and take the launcher's routes.  The
    engine burst on the flat layout, overlapped, must give `want32` too
    (the streams phase gates the synchronous flat run against it).  (b)
    bf16 timing: the engine burst synchronously and overlapped in turns
    (OVERLAP_ORDER), each run's tokens/s, TTFT and TPOT; one overlapped run
    under the profiler (device activity only), one under a Tracer
    (host_overlap_ratio, and a full-pool decode launch's host time, its
    `overlap.bind` span, against the step's device time, profiled over
    DECODE_WINDOW decode-only ticks of the same run).  bf16 stream
    equality between
    the arms is reported, not gated: fresh admissions join a tick later
    when overlapped, so GEMM batch shapes differ.  (c) the ring gate: every
    packed copy must arrive intact (and, reported, a ring without its
    event guard beside it).  -> the launches of each run and route."""
    from repro_torch.models.attention import head_layout
    from repro_torch.obs import Tracer, host_overlap_ratio
    from repro_torch.serve.engine import _MetaPacker
    vocab = cfg32.vocab_size
    G = head_layout(cfg32)[2]
    launches = []  # (run, (launches, tensor cores, split-KV))
    seconds = {}
    t0 = time.perf_counter()

    def counted_run(name, eng, reqs):
        m, s, n, _ = counted_paged_run(paged_mod, f"overlap {name}", eng,
                                       reqs)
        launches.append((name, n))
        return m, s

    def same(name, got, want, prompts):
        div = first_divergence(torch, np, M, cfg32, params32, got, want,
                               prompts)
        if div is not None:
            emit({"phase": "overlap", "equal": False, "run": name, **div})
            fail(f"overlap {name}: fp32 streams diverge from the synchronous "
                 f"run at request {div['rid']} step {div['step']}")

    # ---- (a) fp32 gates: overlapped == synchronous --------------------------
    prompts = {r.rid: r.prompt
               for r in requests(np, synthetic_requests, vocab)}
    part_a = {}
    for name, kw, want in (
            ("engine", dict(policies=[scale_policy()]), want32),
            ("spec", dict(spec="ngram", spec_k=SPEC_K), want_spec32)):
        eng = ServeEngine(cfg32, params=params32, paged_impl="kernel",
                          seed=0, device=DEVICE, overlap=True, **kw,
                          **ENGINE)
        m, s = counted_run(f"{name}_fp32", eng,
                           requests(np, synthetic_requests, vocab))
        same(name, streams(m), want, prompts)
        part_a[name] = {"n_ticks": s["n_ticks"],
                        "decode_dispatches": s["decode_dispatches"],
                        "prefill_dispatches": s["prefill_dispatches_total"],
                        "kernel_launches": launches[-1][1][0],
                        "scale_events": s["scale_events"],
                        "spec_accepted": s["spec_accepted_total"]}
        del eng
    c = CRASH_PLAN
    plan = faults.FaultPlan([faults.worker_crash(c["prefill_crash"]),
                             faults.worker_slow(*c["slow"]),
                             faults.worker_slow(*c["clear"], 1.0),
                             faults.worker_crash(c["decode_crash"])])
    eng = ServeEngine(cfg32, params=params32, paged_impl="kernel", seed=0,
                      device=DEVICE, n_workers=FAULT_WORKERS, overlap=True,
                      fault_injector=faults.FaultInjector(plan), **ENGINE)
    m, s = counted_run("crash_fp32", eng,
                       requests(np, synthetic_requests, vocab))
    same("crash", streams(m), want32, prompts)
    if (s["crashes_total"], s["recoveries"], s["shed_requests"]) != (2, 2, 0):
        fail(f"overlap crash: crashes {s['crashes_total']}, recoveries "
             f"{s['recoveries']}, shed {s['shed_requests']}")
    part_a["crash"] = {"recovery_events": s["recovery_events"],
                       "n_ticks": s["n_ticks"],
                       "kernel_launches": launches[-1][1][0]}
    del eng, m
    same("flat", flat_run(np, ServeEngine, synthetic_requests, cfg32,
                          params32, overlap=True)[1], want32, prompts)
    part_a["flat"] = {"equal": True}
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (b) bf16 timing: synchronous and overlapped in turns ---------------
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params16 = bf16_params()
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
            "wall_s", "n_ticks")
    arms = {"sync": [], "overlap": []}
    bf16_streams = {}
    for ovl in OVERLAP_ORDER:
        arm = "overlap" if ovl else "sync"
        eng = ServeEngine(cfg16, params=params16, paged_impl="kernel",
                          seed=0, device=DEVICE, overlap=ovl,
                          policies=[scale_policy()], **ENGINE)
        m, s = counted_run(f"{arm}_bf16", eng,
                           requests(np, synthetic_requests, vocab))
        if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32:
            fail(f"overlap (b) {arm}: {s['requests_finished']} finished, "
                 f"{s['tokens_generated']} tokens")
        arms[arm].append({k: s[k] for k in keys})
        bf16_streams.setdefault(arm, streams(m))
        del eng, m
    timing = {arm: {"runs": runs, "tokens_per_s_median": float(np.median(
        [r["tokens_per_s"] for r in runs]))} for arm, runs in arms.items()}
    prof_eng = ServeEngine(cfg16, params=params16, paged_impl="kernel",
                           seed=0, device=DEVICE, overlap=True,
                           policies=[scale_policy()], **ENGINE)
    prof = profile_run(torch, lambda: prof_eng.run(
        requests(np, synthetic_requests, vocab)))
    del prof_eng
    trc = Tracer(name="overlap")
    eng = ServeEngine(cfg16, params=params16, paged_impl="kernel", seed=0,
                      device=DEVICE, overlap=True, policies=[scale_policy()],
                      tracer=trc, **ENGINE)
    launch, span_s = launch_vs_step(
        torch, eng, trc, requests(np, synthetic_requests, vocab))
    del eng, params16
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (c) the ring gate --------------------------------------------------
    intact, packed, pack_s = ring_gate(torch, np, _MetaPacker(
        torch.device(DEVICE)))
    if intact != packed:
        fail(f"overlap (c): {packed - intact} of {packed} packed copies were "
             f"overwritten before the device read them")

    class NoGuard:  # a ring without its event guard, for contrast
        def synchronize(self):
            pass

        def record(self, stream):
            pass

    bare = _MetaPacker(torch.device(DEVICE))
    bare._events = [NoGuard()] * bare.RING
    bare_intact, _, bare_s = ring_gate(torch, np, bare)
    seconds["c"] = time.perf_counter() - t0
    emit({"phase": "overlap", "arch": ARCH, **ENGINE,
          "a_streams_equal_sync_fp32": part_a,
          "b_timing_bf16": {
              "order": ["overlap" if o else "sync" for o in OVERLAP_ORDER],
              **timing,
              "bf16_streams_equal_between_arms":
                  bf16_streams["sync"] == bf16_streams["overlap"],
              "profile_overlapped": prof,
              "host_overlap_ratio": host_overlap_ratio(trc),
              "traced_span_s": span_s,
              "launch_vs_step": launch},
          "c_ring": {"packed": packed, "intact": intact,
                     "hold_s": RING_HOLD_S, "pack_host_s": pack_s,
                     "unguarded_intact": bare_intact,
                     "unguarded_pack_host_s": bare_s},
          "verify_rows": (SPEC_K + 1) * G, "seconds": seconds})
    n, tc, split, ver = (sum(v[i] for _, v in launches) for i in range(4))
    return {"launches": n, "launches_tc": tc, "launches_split": split,
            "launches_verify": ver,
            "by_run": [[k, v[0]] for k, v in launches],
            "step_device_ms": launch["step_device_ms"]}


def counted_launches(paged_mod, run):
    """Call `run(log)` with the paged-attention launch counts zeroed just
    before and read just after; `log` gains (rows QG, route) at each
    launch.  -> (what `run` returns, (launches, tensor cores, split,
    verify), `log`)."""
    paged_attention = paged_mod.paged_attention
    log, restore = record_paged_launches(paged_mod)
    zero_paged(paged_attention)
    try:
        out = run(log)
    finally:
        restore()
    n = paged_counts(paged_attention)
    if len(log) != n[0]:
        fail(f"{len(log)} paged launches logged, {n[0]} counted")
    return out, n, log


def check_launches(what, cfg, log, dispatches, rows=None):
    """Fail unless `log` holds layers x `dispatches` launches, each on the
    launcher's route and, where `rows` is given, of rows in `rows`."""
    import torch
    from repro_torch.kernels.paged_attention import route
    from repro_torch.models.attention import head_layout
    hd, G = cfg.head_dim_(), head_layout(cfg)[2]
    wrong = [(qg, r) for qg, r in log
             if r != route(getattr(torch, cfg.dtype), qg, G, hd)
             or (rows is not None and qg not in rows)]
    if not log or len(log) != cfg.num_layers * dispatches or wrong:
        fail(f"{what}: {len(log)} launches for {dispatches} paged "
             f"dispatches of {cfg.num_layers} layers; wrong (rows, route): "
             f"{wrong[:5]}")


def counted_paged_run(paged_mod, what, eng, reqs):
    """Run `eng` (paged, through the kernel) over `reqs` with the
    paged-attention launch counts zeroed just before and read just after;
    fail unless the launches are layers x paged dispatches, each on the
    launcher's route.  -> (metrics, summary, (launches, tensor cores,
    split), the rows of the launches)."""
    m, n, log = counted_launches(paged_mod, lambda log: eng.run(reqs))
    s = m.summarize()
    check_launches(what, eng.cfg, log,
                   s["decode_dispatches"] + s["prefill_dispatches_total"])
    return m, s, n, sorted({qg for qg, _ in log})


def launch_vs_step(torch, eng, trc, reqs):
    """Drive the overlapped engine `eng` (traced by `trc`) over `reqs`
    tick by tick until every slot decodes and nothing else runs, profile
    DECODE_WINDOW such ticks (device activity only), then finish the run.
    -> (a full-pool decode launch's host time, its `overlap.bind` spans,
    against a step's device time in the window; the traced spans'
    seconds)."""
    cap = eng.capacity
    eng.submit(reqs)

    def decode_only(rec):  # every slot decodes, so nothing else can run
        return rec.tokens_emitted == cap and rec.prefill_dispatches == 0

    while not decode_only(eng.tick()):
        if eng._tick >= OVERLOAD["max_ticks"]:
            fail(f"{eng.cfg.name}: no tick in which every slot decodes")
    window = []
    win_prof = profile_run(torch, lambda: window.extend(
        eng.tick() for _ in range(DECODE_WINDOW)))
    if not all(decode_only(r) for r in window) \
            or win_prof["device_busy_s"] is None:
        fail(f"{eng.cfg.name}: the profiled decode window held other work "
             f"or no device records: {win_prof}")
    eng.run([])
    span_s = {name: sum(e.dur for e in trc.events
                        if e.ph == "X" and e.name == name)
              for name in ("overlap.bind", "overlap.prep", "overlap.inflight",
                           "device_wait", "prefill.device_wait")}
    bind_ms = sorted(e.dur * 1e3 for e in trc.events
                     if e.ph == "X" and e.name == "overlap.bind"
                     and e.args.get("n") == cap)
    step_ms = win_prof["device_busy_s"] * 1e3 / DECODE_WINDOW
    launch = {"slots": cap, "full_pool_launches": len(bind_ms),
              "launch_host_ms_median": bind_ms[len(bind_ms) // 2],
              "launch_host_ms_range": [bind_ms[0], bind_ms[-1]],
              "step_device_ms": step_ms,
              "device_over_host": step_ms / bind_ms[len(bind_ms) // 2],
              "window_ticks": DECODE_WINDOW,
              "window_idle_share": win_prof["device_idle_share"],
              "window_top_kernels": win_prof["top_kernels"][:6]}
    return launch, span_s


def mark_pool_ticks(dis, log, marks):
    """Wrap each half of the DisaggEngine `dis` so that its `tick` leaves
    (pool, first launch, past the last launch) in `marks`, positions in
    the launch `log`; -> a function that takes the wrappers off."""
    for name in ("prefill", "decode"):
        half = getattr(dis, name)

        def tick(tick=half.tick, name=name):
            start = len(log)
            try:
                return tick()
            finally:
                marks.append((name, start, len(log)))
        half.tick = tick

    def restore():
        for name in ("prefill", "decode"):
            del getattr(dis, name).tick
    return restore


def check_pool_launches(what, dis, m, n, log, marks):
    """Split the launch `log` of the DisaggEngine `dis`'s run (metrics
    `m`, counts `n`) into pools by `marks`; fail unless the prefill pool's
    launches are all chunk-shaped (prefill_chunk x G rows) and equal
    layers x its chunk dispatches, the decode pool's are all decode or
    verify spans and equal layers x its decode dispatches, each on the
    launcher's route.  -> per-pool launches."""
    from repro_torch.models.attention import head_layout
    cfg = dis.cfg
    G = head_layout(cfg)[2]
    pools = {"prefill": [], "decode": []}
    for name, a, b in marks:
        pools[name].extend(log[a:b])
    ps, ds = m.prefill.summarize(), m.decode.summarize()
    if sum(map(len, pools.values())) != n[0] \
            or ds["prefill_dispatches_total"]:
        fail(f"{what}: {n[0]} launches, {len(pools['prefill'])} inside "
             f"prefill pool ticks and {len(pools['decode'])} inside decode "
             f"pool ticks; {ds['prefill_dispatches_total']} chunk "
             f"dispatches in the decode pool")
    check_launches(f"{what} prefill pool", cfg, pools["prefill"],
                   ps["prefill_dispatches_total"],
                   rows={dis.prefill.prefill_chunk * G})
    check_launches(f"{what} decode pool", cfg, pools["decode"],
                   ds["decode_dispatches"],
                   rows={G} | ({(dis.decode.spec_k + 1) * G}
                               if dis.decode.spec_k else set()))
    return {name: len(got) for name, got in pools.items()}


def counted_disagg_run(paged_mod, what, dis, reqs):
    """Run the DisaggEngine `dis` (paged, through the kernel) over `reqs`
    with the paged-attention launch counts zeroed just before and read
    just after, the log split into pools by marks that each half's `tick`
    leaves, and checked by `check_pool_launches`.  -> (metrics,
    (launches, tensor cores, split), per-pool launches)."""
    marks = []  # (pool, first launch, past the last launch) per tick

    def run(log):
        restore = mark_pool_ticks(dis, log, marks)
        try:
            return dis.run(reqs)
        finally:
            restore()
    m, n, log = counted_launches(paged_mod, run)
    return m, n, check_pool_launches(what, dis, m, n, log, marks)


def contained_s(inner, outer):
    """Seconds of the `inner` spans that lie inside one of the `outer`
    spans (both lists of trace events)."""
    return sum(e.dur for e in inner
               if any(o.ts <= e.ts and e.ts + e.dur <= o.ts + o.dur
                      for o in outer))


def disagg_phase(torch, np, M, cfg32, params32, want32, DisaggEngine,
                 ScheduledSplitPolicy, synthetic_requests, paged_mod,
                 bf16_params, engine_s, step_device_ms):
    """Disaggregated serving at full width, paged, through the kernel in
    both pools.  (a) fp32 gates on the engine burst: (a1) two workers,
    synchronous; (a2) three workers with ScheduledSplitPolicy(DISAGG_SPLIT)
    and overlap=True.  Each run's streams must equal the synchronous fp32
    kernel streams `want32`, every request must hand off once, the prefill
    pool's launches must be chunk-shaped and the decode pool's decode-
    shaped (`counted_disagg_run`); (a2)'s split events must hold both
    scheduled moves.  (b) bf16, reported: the burst disaggregated,
    synchronously without a tracer (tokens/s, TTFT, TPOT, as the engine
    phase's run), then synchronously and overlapped, each under a Tracer:
    tokens/s, TTFT, TPOT, handoffs, handoff bytes and delay, each pool's
    host tick time, the host time by trace track, the host time of the
    handoff spans, and in the overlapped run the share of
    `handoff.extract` inside the decode pool's `overlap.prep` window
    (whose blocking gather waits for the in-flight step) against the
    decode step's device time (`step_device_ms`, the overlap phase's);
    beside the engine phase's monolithic numbers `engine_s`.  -> the
    launches of each run and route."""
    from repro_torch.obs import Tracer, phase_attribution
    vocab = cfg32.vocab_size
    kw = {k: v for k, v in ENGINE.items() if k != "kv_layout"}
    launches = []  # (run, (launches, tensor cores, split))
    seconds = {}
    t0 = time.perf_counter()
    prompts = {r.rid: r.prompt
               for r in requests(np, synthetic_requests, vocab)}
    part_a = {}
    for name, n_workers, extra in (
            ("sync", 2, {}),
            ("split_overlapped", 3, dict(
                split_policy=ScheduledSplitPolicy(DISAGG_SPLIT),
                overlap=True))):
        dis = DisaggEngine(cfg32, params=params32, paged_impl="kernel",
                           seed=0, device=DEVICE, n_workers=n_workers,
                           **extra, **kw)
        if dis.prefill.params is not params32 \
                or dis.decode.params is not params32:
            fail(f"disagg {name}: a pool holds a copy of the parameters")
        m, n, per_pool = counted_disagg_run(
            paged_mod, f"disagg {name}_fp32", dis,
            requests(np, synthetic_requests, vocab))
        launches.append((f"{name}_fp32", n))
        div = first_divergence(torch, np, M, cfg32, params32, streams(m),
                               want32, prompts)
        if div is not None:
            emit({"phase": "disagg", "equal": False, "run": name, **div})
            fail(f"disagg {name}: fp32 streams diverge from the monolithic "
                 f"run at request {div['rid']} step {div['step']}")
        kps = [kp for _, kp, _ in m.split_events]
        if m.handoffs != 8 or (n_workers == 3 and not (
                2 in kps and kps[-1] == 1)):
            fail(f"disagg {name}: {m.handoffs} handoffs, split events "
                 f"{m.split_events}")
        part_a[name] = {"decode_ticks": len(m.decode.ticks),
                        "handoffs": m.handoffs,
                        "handoff_bytes": m.handoff_bytes,
                        "split_events": [list(e) for e in m.split_events],
                        "kernel_launches": n[0], "by_pool": per_pool}
        del dis, m
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (b) bf16: synchronous and overlapped, traced ---------------------
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params16 = bf16_params()
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
            "handoff_delay_p50_s", "wall_s")
    part_b = {}
    for name, overlap, trc in (
            ("sync_untraced", False, None),
            ("sync", False, Tracer(name="disagg-sync")),
            ("overlapped", True, Tracer(name="disagg-overlapped"))):
        dis = DisaggEngine(cfg16, params=params16, paged_impl="kernel",
                           seed=0, device=DEVICE, n_workers=2,
                           overlap=overlap, tracer=trc, **kw)
        m, n, per_pool = counted_disagg_run(
            paged_mod, f"disagg {name}_bf16", dis,
            requests(np, synthetic_requests, vocab))
        launches.append((f"{name}_bf16", n))
        s = m.summarize()
        if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32:
            fail(f"disagg (b) {name}: {s['requests_finished']} finished, "
                 f"{s['tokens_generated']} tokens")
        if trc is None:
            part_b[name] = {k: s[k] for k in keys}
            del dis, m
            continue
        spans = {k: trc.spans(k) for k in ("handoff.extract",
                                           "handoff.inject")}
        prep = trc.spans("overlap.prep", track="decode_pool.overlap")
        attr = phase_attribution(trc, exclude=(
            "tick", "overlap", "prefill_pool.overlap", "decode_pool.overlap"))
        part_b[name] = {
            **{k: s[k] for k in keys},
            "pool_tick_host_s": {
                pool: sum(trc.registry.histogram(
                    f"{pool}.serve.tick_s").values)
                for pool in ("prefill_pool", "decode_pool")},
            "host_ms_by_track": {
                track: round(a["host_ms_total"], 3)
                for track, a in attr.items() if a["host_ms_total"]},
            "handoffs": s["disagg"]["handoffs"],
            "handoff_bytes": s["disagg"]["handoff_bytes"],
            "handoff_extract_host_ms": 1e3 * sum(e.dur
                                                 for e in spans[
                                                     "handoff.extract"]),
            "handoff_inject_host_ms": 1e3 * sum(e.dur
                                                for e in spans[
                                                    "handoff.inject"]),
            "kernel_launches": n[0], "by_pool": per_pool}
        if overlap:
            inside = contained_s(spans["handoff.extract"], prep)
            part_b[name]["extract_inside_overlap_prep"] = {
                "host_ms": 1e3 * inside,
                "extracts": sum(1 for e in spans["handoff.extract"]
                                if contained_s([e], prep) > 0),
                "decode_step_device_ms": step_device_ms}
        del dis, m
    del params16
    seconds["b"] = time.perf_counter() - t0
    emit({"phase": "disagg", "arch": ARCH, **ENGINE,
          "split_schedule": DISAGG_SPLIT,
          "a_streams_equal_monolithic_fp32": part_a,
          "b_bf16": part_b,
          "engine_monolithic_bf16": engine_s,
          "kv_pool_gb_per_engine": {
              dt: 2 * cfg32.num_layers * cfg32.kv_heads()
              * cfg32.head_dim_() * ENGINE["cache_len"] * ENGINE["capacity"]
              * sz / 1e9 for dt, sz in (("float32", 4), ("bfloat16", 2))},
          "seconds": seconds})
    n, tc, split, ver = (sum(v[i] for _, v in launches) for i in range(4))
    return {"launches": n, "launches_tc": tc, "launches_split": split,
            "launches_verify": ver,
            "by_run": [[k, v[0]] for k, v in launches]}


def lease_changes(report, name):
    """How often `name`'s lease changed between ticks it held nodes or
    demanded them (its first grant not counted)."""
    leases = [t.alloc.get(name, 0) for t in report.timeline
              if name in t.demand]
    return sum(1 for a, b in zip(leases, leases[1:]) if a != b)


def cluster_phase(torch, np, M, cfg, cfg32, ServeEngine, synthetic_requests,
                  paged_mod):
    """The cluster orchestrator (`repro_torch.cluster`) at full width: jobs
    contend for simulated nodes of one `DevicePool` (its default devices:
    the card), and each lease change goes through the job's elastic path
    on the card.  (a) fp32 gates: (a1) a ServeJob under the engine burst is
    squeezed from 4 nodes to 1 by a higher-priority CoCoA job: its streams
    must equal a solo ServeEngine's on the same requests and params, the
    squeeze must park slots (kv_moved_bytes > 0, the engine's mem.stats()),
    and the CoCoA gap curve, alpha and w must equal a solo run's bit for
    bit; (a2) a DisaggServeJob whose lease changes once (3 -> 2): 8
    handoffs and the solo streams; (a3) an LMTrainJob at the 100m preset,
    scaled to zero and resumed: its parameters and momentum equal an
    uninterrupted ElasticTrainer's after the same steps, under
    deterministic algorithms.  Every paged launch takes the launcher's
    route and they number layers x the jobs' paged dispatches; every SCD
    launch takes the blocked kernel.  (b) bf16: (a1)'s trace untraced (the
    orchestrator's wall time), then traced under torch.profiler: each
    job's `advance` host time, device busy time, idle share and top
    kernels, beside the report's simulated makespan, utilization, Jain
    fairness and preemptions.  -> launches by run."""
    from repro_torch import cluster as C
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_lm_tokens
    from repro_torch.launch.elastic import ElasticTrainer
    from repro_torch.kernels.scd import scd_pass
    from repro_torch.launch.train import scale_config
    from repro_torch.obs import Tracer
    c, srv_kw = CLUSTER, CLUSTER["serve"]
    vocab = cfg32.vocab_size
    G = cfg32.num_heads // cfg32.kv_heads()
    rows = {srv_kw["prefill_bucket"] * G, G}  # chunks and decode spans
    runs = []  # (run, paged (launches, tc, split), SCD (launches, blocked))
    seconds = {}
    t0 = time.perf_counter()

    def trainer(name, **kw):
        return C.cocoa_train_job(name, seed=0, device=DEVICE, **kw)

    def hog(name, iterations, k_tasks, priority, max_nodes):
        h = c["hog"]
        return trainer(name, iterations=iterations, k_tasks=k_tasks,
                       priority=priority, max_nodes=max_nodes, n=h["n"],
                       f=h["f"], chunk=h["chunk"], lam=h["lam"])

    def burst(extra):
        return C.ClusterTrace([
            C.arrive(0.0, "svc"),
            C.burst(0.0, "svc", 8, prompt_len=list(PROMPT_LEN),
                    max_new_tokens=[32, 32], seed=0)] + extra)

    def contention(model_cfg, tracer=None):
        srv = C.ServeJob(C.JobSpec("svc", "serve", max_nodes=c["nodes"]),
                         model_cfg, slots_per_node=c["slots_per_node"],
                         kv_layout="paged", seed=0, device=DEVICE, **srv_kw)
        tr = trainer("train", **c["cocoa"])
        orch = C.ClusterOrchestrator(
            C.DevicePool(c["nodes"]), [srv, tr],
            burst([C.arrive(c["squeeze_at"], "train")]), dt=1.0,
            max_ticks=500, tracer=tracer)
        return orch, srv, tr

    def checked(what, model_cfg, orch, serve_jobs, run=None):
        """Drive `orch` (by `run(drive)` if given) with the paged and SCD
        launch counts zeroed just before and read just after; fail unless
        every job finished, the paged launches number layers x the serve
        jobs' paged dispatches, each on the launcher's route, and every
        SCD launch took the blocked kernel.  -> (report, orchestrator wall
        s)."""
        start = time.perf_counter()

        def drive():
            out = orch.run()
            torch.cuda.synchronize()
            return out

        def counted(log):
            scd_pass.launches = scd_pass.launches_blocked = 0
            out = drive() if run is None else run(drive)
            return out, (scd_pass.launches, scd_pass.launches_blocked)
        (rep, scd), n, log = counted_launches(paged_mod, counted)
        wall = time.perf_counter() - start
        dispatches = 0
        for job in serve_jobs:
            eng = job.engine
            if hasattr(eng, "prefill"):  # disagg: chunks, then decode
                dispatches += eng.prefill.metrics.summarize()[
                    "prefill_dispatches_total"]
                eng = eng.decode
            s = eng.metrics.summarize()
            dispatches += s["decode_dispatches"] \
                + s["prefill_dispatches_total"]
        if serve_jobs:
            check_launches(f"cluster {what}", model_cfg, log, dispatches,
                           rows=rows)
        elif n[0]:
            fail(f"cluster {what}: {n[0]} paged launches without a server")
        if not scd[0] or scd[1] != scd[0]:
            fail(f"cluster {what}: {scd[0]} SCD launches, {scd[1]} of them "
                 f"on the blocked kernel")
        states = {k: j["state"] for k, j in rep.jobs.items()}
        if set(states.values()) != {"finished"}:
            fail(f"cluster {what}: job states {states}")
        runs.append((what, n, scd))
        return rep, wall

    # ---- (a1) serving squeezed by CoCoA, fp32 ---------------------------
    prompts = {r.rid: r.prompt
               for r in requests(np, synthetic_requests, vocab)}
    orch, srv, tr = contention(cfg32)
    params32 = srv.engine.params
    solo = ServeEngine(cfg32, params=params32, n_workers=1,
                       max_admit_per_tick=4, kv_layout="paged", seed=0,
                       device=DEVICE, **srv_kw)
    want = streams(solo.run(requests(np, synthetic_requests, vocab)))
    del solo
    rep, wall = checked("contention_fp32", cfg32, orch, [srv])
    div = first_divergence(torch, np, M, cfg32, params32,
                           streams(srv.engine.metrics), want, prompts)
    if div is not None:
        emit({"phase": "cluster", "equal": False, "run": "contention", **div})
        fail(f"cluster contention: the serve job's streams diverge from the "
             f"solo engine's at request {div['rid']} step {div['step']}")
    st = srv.engine.mem.stats()
    kv = srv.kv_moved_bytes
    if not (kv > 0 and kv == st["park_bytes"] + st["restore_bytes"]
            and rep.kv_moved_bytes == kv and rep.preemptions >= 1):
        fail(f"cluster contention: kv_moved_bytes {kv}, mem.stats {st}, "
             f"report {rep.kv_moved_bytes}, preemptions {rep.preemptions}")
    solo_t = trainer("solo", **c["cocoa"])
    C.ClusterOrchestrator(C.DevicePool(c["nodes"]), [solo_t],
                          C.ClusterTrace([C.arrive(0.0, "solo")]), dt=1.0,
                          max_ticks=500).run()
    same = (solo_t.loss_curve() == tr.loss_curve()
            and np.array_equal(solo_t.solver.store.state["alpha"],
                               tr.solver.store.state["alpha"])
            and torch.equal(solo_t.solver.w, tr.solver.w))
    if not same:
        fail(f"cluster contention: the contended CoCoA run differs from its "
             f"solo run: gaps {tr.loss_curve()} vs {solo_t.loss_curve()}")
    sj = rep.jobs["svc"]
    part_a = {"contention": {
        "streams_equal_solo": True, "cocoa_bit_identical_to_solo": True,
        "kv_moved_bytes": kv, "parked": sj["serve"]["parked_total"],
        "restored": sj["serve"]["restored_total"],
        "preemptions": rep.preemptions, "ticks": rep.ticks,
        "serve_leases": [t.alloc.get("svc", 0) for t in rep.timeline],
        "train_leases": [t.alloc.get("train", 0) for t in rep.timeline],
        "gaps": tr.loss_curve(), "wall_s": wall}}
    del orch, srv, tr, solo_t, params32
    torch.cuda.empty_cache()

    # ---- (a2) disaggregated serving, one lease change, fp32 --------------
    dsv = C.DisaggServeJob(
        C.JobSpec("svc", "serve", min_nodes=2, max_nodes=c["disagg_nodes"]),
        cfg32, slots_per_node=c["slots_per_node"], seed=0, device=DEVICE,
        **srv_kw)
    if dsv.engine.prefill.params is not dsv.engine.decode.params:
        fail("cluster disagg: the pools hold two parameter modules")
    orch = C.ClusterOrchestrator(
        C.DevicePool(c["disagg_nodes"]),
        [dsv, hog("hog", 2, 16, priority=1, max_nodes=1)],
        burst([C.arrive(c["squeeze_at"], "hog")]), dt=1.0, max_ticks=500)
    rep, wall = checked("disagg_fp32", cfg32, orch, [dsv])
    div = first_divergence(torch, np, M, cfg32, dsv.engine.prefill.params,
                           streams(dsv.engine.metrics), want, prompts)
    changes = lease_changes(rep, "svc")
    if div is not None or dsv.engine.metrics.handoffs != 8 or changes != 1:
        fail(f"cluster disagg: first divergence {div}, "
             f"{dsv.engine.metrics.handoffs} handoffs, {changes} lease "
             f"changes")
    part_a["disagg"] = {
        "streams_equal_solo": True, "handoffs": dsv.engine.metrics.handoffs,
        "lease_changes": changes,
        "split_events": [list(e) for e in dsv.engine.metrics.split_events],
        "kv_moved_bytes": rep.kv_moved_bytes,
        "preemptions": rep.preemptions, "ticks": rep.ticks, "wall_s": wall}
    del orch, dsv
    torch.cuda.empty_cache()

    # ---- (a3) the LM job scaled to zero and resumed ----------------------
    cfg100 = scale_config(get_config(ARCH), "100m")
    tc = TrainConfig(learning_rate=3e-3, optimizer="sgdm", momentum=0.9,
                     remat=False)
    n_b, seq = c["lm_batch"], c["lm_seq"]
    data = make_lm_tokens(c["lm_steps"] * n_b, seq, cfg100.vocab_size,
                          seed=0)

    def batch(i):
        sl = slice(n_b * i, n_b * (i + 1))
        return {"tokens": data["tokens"][sl], "labels": data["labels"][sl],
                "weights": np.ones(n_b, np.float32)}

    was_det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        lm = C.LMTrainJob(C.JobSpec("lm", "train", max_nodes=1), cfg100, tc,
                          batch_fn=batch, steps=c["lm_steps"], seed=0,
                          device=DEVICE)
        orch = C.ClusterOrchestrator(
            C.DevicePool(1), [lm, hog("hog", 3, 4, priority=2, max_nodes=1)],
            C.ClusterTrace([C.arrive(0.0, "lm"),
                            C.arrive(c["squeeze_at"], "hog")]),
            dt=1.0, max_ticks=500)
        rep, wall = checked("lm_fp32", cfg100, orch, [])
        ref = ElasticTrainer(cfg100, tc, seed=0, device=DEVICE)
        for i in range(c["lm_steps"]):
            ref.train_step(batch(i))
        lm_same = same_state(torch, state_on_host(lm.trainer, M),
                             state_on_host(ref, M))
    finally:
        torch.use_deterministic_algorithms(was_det)
    leases = [t.alloc.get("lm", 0) for t in rep.timeline if "lm" in t.demand]
    if not lm_same or lm.steps_done != c["lm_steps"] \
            or 0 not in leases[1:] or lm.trainer.suspended:
        fail(f"cluster lm: state equal to the uninterrupted run: {lm_same}; "
             f"{lm.steps_done} steps; leases {leases}")
    part_a["lm"] = {"bit_identical_to_uninterrupted": True,
                    "losses": lm.loss_curve(), "leases": leases,
                    "preemptions": rep.preemptions, "ticks": rep.ticks,
                    "wall_s": wall}
    del lm, ref, orch
    torch.cuda.empty_cache()
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (b) bf16: the contention trace untraced, then profiled ----------
    part_b = {}
    for name in ("untraced", "profiled"):
        trc = Tracer(name="cluster") if name == "profiled" else None
        orch, srv, tr = contention(cfg, tracer=trc)
        prof = {}
        if trc is None:
            rep, wall = checked(f"contention_bf16_{name}", cfg, orch, [srv])
        else:
            def profiled(drive):
                box = {}
                prof.update(profile_run(
                    torch, lambda: box.setdefault("report", drive())))
                return box["report"]
            rep, wall = checked(f"contention_bf16_{name}", cfg, orch, [srv],
                                run=profiled)
        sv = rep.jobs["svc"]["serve"]
        if sv["requests_finished"] != 8 or sv["tokens_generated"] != 8 * 32:
            fail(f"cluster (b) {name}: {sv['requests_finished']} finished, "
                 f"{sv['tokens_generated']} tokens")
        part_b[name] = {
            # the profiled run's own wall time; `wall` there also holds
            # the profiler's processing of the window
            "orchestrator_wall_s": prof.get("wall_s", wall),
            "wall_with_profiler_s": wall, "ticks": rep.ticks,
            "simulated": {"makespan_s": rep.makespan,
                          "utilization": rep.utilization,
                          "fairness_jain": rep.fairness_jain,
                          "preemptions": rep.preemptions,
                          "serve_tokens_per_s": sv["tokens_per_s"],
                          "serve_ttft_p50_s": sv["ttft_p50_s"],
                          "serve_tpot_p50_s": sv["tpot_p50_s"]},
            "kv_moved_bytes": rep.kv_moved_bytes,
            "final_gap": rep.jobs["train"]["final_metric"]}
        if trc is not None:
            part_b[name]["advance_host_ms"] = {
                job: 1e3 * sum(e.dur for e in trc.spans("advance",
                                                        track=job))
                for job in ("svc", "train")}
            part_b[name]["allocator_host_ms"] = 1e3 * sum(
                e.dur for e in trc.spans("allocator.decide"))
            part_b[name]["profile"] = prof
        del orch, srv, tr
        torch.cuda.empty_cache()
    seconds["b"] = time.perf_counter() - t0
    emit({"phase": "cluster", "arch": ARCH, **c,
          "reduced": {"cocoa_n": "11,000,000 -> 1,100,000 (time)",
                      "nodes": "simulated on one card"},
          "a_fp32": part_a, "b_bf16": part_b, "seconds": seconds})
    paged = [sum(n[i] for _, n, _ in runs) for i in range(4)]
    return {"launches": paged[0], "launches_tc": paged[1],
            "launches_split": paged[2], "launches_verify": paged[3],
            "by_run": [[k, n[0]] for k, n, _ in runs],
            "scd_launches": sum(s[0] for _, _, s in runs),
            "scd_launches_blocked": sum(s[1] for _, _, s in runs),
            "scd_by_run": [[k, s[0]] for k, _, s in runs]}


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
    smollm-360m (a warm-up run, the measured run, then for the archs of
    FLAT_PROFILED one under the profiler, device activity only; no custom
    kernel runs here, so the profile's share is the elementwise
    kernels'), then spec="draft" with a 4-layer danube drafting for
    itself."""
    from repro_torch.models import attention as attn
    out = {}
    for arch, c in ((ARCH, cfg), (FLAT_ARCH, get_config(FLAT_ARCH))):
        params = M.init_params(c, torch.Generator(
            device=DEVICE).manual_seed(0), DEVICE)
        flat_run(np, ServeEngine, synthetic_requests, c, params)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        s, _, _ = flat_run(np, ServeEngine, synthetic_requests, c, params)
        peak = torch.cuda.max_memory_allocated()
        prof = {}
        if arch in FLAT_PROFILED:
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


def excess(got, want, rtol, atol) -> float:
    """max of |got - want| - (atol + rtol |want|): <= 0 when close."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def family_memory(torch, cfg, B, gen, dtype):
    """The vlm patch / audio frame stub embeddings (B, T, D), or None."""
    from repro_torch.launch.steps import memory_len
    T = memory_len(cfg)
    if not T:
        return None
    return (torch.randn((B, T, cfg.d_model), generator=gen, device=DEVICE)
            * 0.02).to(dtype)


def family_params(torch, M, cfg):
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                           DEVICE)
    if cfg.family == "vlm":
        with torch.no_grad():
            params.blocks.cross_gate.fill_(FAMILY_CROSS_GATE)
    return params


def record_wkv_decay(torch, ssm):
    """Wrap `ssm.rwkv_wkv_chunked` so every multi-token call logs, per
    chunk offset, the lowest cumulative log decay from the chunk's start
    over rows, heads and channels.  Returns (log, restore)."""
    real = ssm.rwkv_wkv_chunked
    lows = []

    def wrapped(r, k, v, log_w, u, state):
        B, S, H, hd = r.shape
        if S > 1:
            c = min(ssm.RWKV_CHUNK, S)
            lows.append(log_w.float().reshape(B, S // c, c, H, hd)
                        .cumsum(2).amin(dim=(0, 1, 3, 4)))
        return real(r, k, v, log_w, u, state)

    ssm.rwkv_wkv_chunked = wrapped
    return lows, lambda: setattr(ssm, "rwkv_wkv_chunked", real)


def clip_free_until(torch, lows, c) -> int:
    """The last chunk offset t (of chunks of c) at which the reference's
    log-space clip at -60 cannot have engaged in any logged call: every
    earlier offset i < t kept its cumulative decay >= -60, so the chunked
    scan at t is exact.  c - 1 when it never engaged."""
    m = torch.stack([x for x in lows if x.numel() == c]).amin(0)
    bad = (m < -60.0).nonzero()
    return int(bad[0, 0]) if len(bad) else c - 1


def family_gate(torch, M, cfg, params, spec):
    """fp32: a prefill of `prompt` tokens, then `decode` decode_steps;
    each step's logits against forward's over every token at its
    position, and the cache after the last step against a prefill of
    every token (rwkv's shift and wkv state; k/v rows, the memory's
    xk/xv), at FAMILY_TOL.

    ssm: the JAX package's chunked WKV clips its log-space decays at -60,
    so where a chunk's cumulative decay passes -60 (at the init's decay of
    ~e^-1 a token: a chunk's last offsets) forward is not the stepwise
    recurrence, in the reference too (tests/test_torch_families_decode.py
    holds the port to the reference's gap).  There the logits gate holds
    the offsets the clip cannot reach in this run (`clip_free_until`) and
    reports the rest and the 192-token state; the state gate holds a
    prefill of `state_prompt` (one chunk under 64 tokens, clip-free by the
    same log) plus decode steps to a prefill of `state_whole`."""
    from repro_torch.models import ssm
    B, P, D = spec["B"], spec["prompt"], spec["decode"]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + D), generator=gen,
                         device=DEVICE)
    mem = family_memory(torch, cfg, B, gen, torch.float32)
    lows, restore = record_wkv_decay(torch, ssm)

    def states(a, b):
        return {k: (float((v - b["blocks"][k]).abs().max()),
                    excess(v, b["blocks"][k], **FAMILY_TOL))
                for k, v in a["blocks"].items()}

    try:
        with torch.inference_mode():
            full = M.forward(cfg, params, toks, memory=mem)
            _, cache = M.prefill(cfg, params, toks[:, :P], memory=mem,
                                 cache_len=P + D)
            errs = []  # (position, max abs err, excess over FAMILY_TOL)
            for t in range(P, P + D):
                logits, cache = M.decode_step(cfg, params, cache,
                                              toks[:, t:t + 1], t)
                errs.append((t, float((logits[:, 0] - full[:, t]).abs()
                                      .max()),
                             excess(logits[:, 0], full[:, t],
                                    **FAMILY_TOL)))
            _, whole = M.prefill(cfg, params, toks, memory=mem,
                                 cache_len=P + D)
            state = states(cache, whole)
            if cfg.family == "ssm":
                Ps, Pw = spec["state_prompt"], spec["state_whole"]
                _, short = M.prefill(cfg, params, toks[:, :Ps])
                for t in range(Ps, Pw):
                    _, short = M.decode_step(cfg, params, short,
                                             toks[:, t:t + 1], t)
                _, ref = M.prefill(cfg, params, toks[:, :Pw])
                short_state = states(short, ref)
    finally:
        restore()
    del full
    out = {"B": B, "prompt": P, "decode_steps": D,
           "logits_max_abs_err": max(e for _, e, _ in errs),
           "state_max_abs_err": {k: e[0] for k, e in state.items()}}
    gated, gated_state = errs, state
    if cfg.family == "ssm":
        c = min(ssm.RWKV_CHUNK, P + D)
        until = clip_free_until(torch, lows, c)
        if clip_free_until(torch, lows, Pw) < Pw - 1 \
                or clip_free_until(torch, lows, Ps) < Ps - 1:
            fail(f"families {cfg.name}: the clip engaged inside the "
                 f"{Ps}- or {Pw}-token prefill; its state gate is void")
        gated = [e for e in errs if e[0] % c <= until]
        gated_state = short_state
        out.update({
            "chunk": c, "clip_free_until_offset": until,
            "lowest_chunk_cum_decay": float(torch.stack(
                [x for x in lows if x.numel() == c]).amin()),
            "logits_gated_positions": len(gated),
            "logits_max_abs_err_gated": max(e for _, e, _ in gated),
            "logits_past_clip": [[t, e] for t, e, _ in errs
                                 if t % c > until],
            "state_gate": {"prompt": Ps, "whole": Pw,
                           "max_abs_err": {k: e[0] for k, e
                                           in short_state.items()}}})
    bad = [(t, e) for t, e, x in gated if not x <= 0]
    if bad:
        fail(f"families {cfg.name}: decode logits off forward's at "
             f"{bad[:4]} (FAMILY_TOL {FAMILY_TOL})")
    bad = {k: e for k, e in gated_state.items() if not e[1] <= 0}
    if bad:
        fail(f"families {cfg.name}: prefill + decode state differs from "
             f"the prefill of every token: {bad}")
    return out


def family_bf16(torch, M, steps_mod, cfg, params, spec):
    """bf16: prefill (timed), greedy decode through `make_serve_step`
    (each launch's host time; tokens/s over the loop), then a window of
    decode steps under torch.profiler (a step's device time against the
    bytes it must move: every weight once, the recurrent state read and
    written, the K/V rows and the memory's xk/xv read; the idle share, the
    largest kernels) and under cProfile (the host's largest items)."""
    B, P, N = spec["B"], spec["prompt"], spec["steps"]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                         device=DEVICE)
    mem = family_memory(torch, cfg, B, gen, torch.bfloat16)
    serve = steps_mod.make_serve_step(cfg)
    with torch.inference_mode():
        def prefill():
            return M.prefill(cfg, params, toks, memory=mem,
                             cache_len=P + N)

        prefill_ms = cuda_ms(torch, prefill)
        logits, cache = prefill()
        torch.cuda.synchronize()
        out, host_ms = [], []
        t0 = time.perf_counter()
        for t in range(P, P + N):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            h0 = time.perf_counter()
            logits, cache = serve(params, cache, tok, t)
            host_ms.append((time.perf_counter() - h0) * 1e3)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        stream = torch.cat(out, 1)
        if not bool(torch.isfinite(logits).all()) or stream.shape != (B, N) \
                or not bool(((stream >= 0) & (stream < cfg.vocab_size))
                            .all()):
            fail(f"families {cfg.name}: bf16 decode gave non-finite logits "
                 f"or tokens out of range")
        tok = out[-1]

        def window():  # steps at the last position: the cache stays put
            for _ in range(FAMILY_DECODE_WINDOW):
                serve(params, cache, tok, P + N - 1)

        prof = profile_run(torch, window, kernel="elementwise", attempts=3)
        if prof["device_busy_s"] is None:
            fail(f"families {cfg.name}: no device record of the decode "
                 f"window: {prof}")
        host_top = host_profile(torch, window, n=6)
    step_ms = prof["device_busy_s"] * 1e3 / FAMILY_DECODE_WINDOW
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    # what the timed step moves besides the weights: the recurrent state
    # read and written; the K/V rows (all live at the last step: the cache
    # is P + N rows) and the memory's xk/xv read
    cache_bytes = sum(v.numel() * v.element_size()
                      * (2 if k in ("shift_a", "shift_f", "wkv") else 1)
                      for k, v in cache["blocks"].items())
    host_ms.sort()
    return {"B": B, "prompt": P, "steps": N, "prefill_ms": prefill_ms,
            "decode_step_device_ms": step_ms,
            "weight_bytes": weight_bytes,
            "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
            "cache_bytes": cache_bytes,
            "bound_ms": (weight_bytes + cache_bytes)
                        / HBM_BYTES_PER_S * 1e3,
            "decode_launch_host_ms_median": host_ms[len(host_ms) // 2],
            "decode_launch_host_ms_range": [host_ms[0], host_ms[-1]],
            "decode_wall_s": decode_s, "tokens_per_s": B * N / decode_s,
            "decode_window": {"steps": FAMILY_DECODE_WINDOW,
                              "wall_s": prof["wall_s"],
                              "device_idle_share": prof["device_idle_share"],
                              "top_kernels": prof["top_kernels"][:5],
                              "host_top": host_top}}


def family_train(torch, M, steps_mod, cfg, params, spec):
    """bf16 sgdm with remat through `make_train_step`: each step's wall
    time and the peak memory (with a copy of the weights held to check
    that they moved); the loss finite, the parameters moved."""
    from repro_torch.configs import TrainConfig
    from repro_torch.optim import init_opt_state
    B, S = spec["B"], spec["seq"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    step = steps_mod.make_train_step(cfg, TrainConfig(learning_rate=1e-3,
                                                      remat=True))
    opt = init_opt_state(M.param_dict(params))
    before = {k: v.detach().clone() for k, v in M.param_dict(params).items()}
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(spec["steps"]):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, device=DEVICE),
                 "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, device=DEVICE),
                 "weights": torch.ones((B,), device=DEVICE)}
        mem = family_memory(torch, cfg, B, gen, torch.bfloat16)
        if mem is not None:
            batch["memory"] = mem
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(int(not torch.equal(M.param_dict(params)[k].detach(), v))
                for k, v in before.items())
    if not all(math.isfinite(x) for x in losses) or not moved:
        fail(f"families {cfg.name}: train losses {losses}, {moved} of "
             f"{len(before)} leaves moved")
    return {"B": B, "seq": S, "losses": losses, "step_wall_s": walls,
            "peak_mem_gb": peak / 1e9,
            "of_it_weight_copy_gb": sum(v.numel() * v.element_size()
                                        for v in before.values()) / 1e9,
            "leaves_moved": moved, "leaves": len(before)}


def mamba_mixer_gate(torch, get_config):
    """jamba's mamba mixer at its published widths in fp32: mamba_forward
    over B x S tokens against S stepwise mamba_decode calls from the same
    zero state (outputs, final conv and h states)."""
    from repro_torch.models import layers, ssm
    cfg = dataclasses.replace(get_config(JAMBA_MIXER["arch"]),
                              dtype="float32")
    B, S = JAMBA_MIXER["B"], JAMBA_MIXER["S"]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    p = layers.init_tree(ssm.mamba_defs(cfg), gen, torch.float32,
                         torch.device(DEVICE))
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=DEVICE)
    di = cfg.ssm_expand * cfg.d_model
    with torch.inference_mode():
        t0 = time.perf_counter()
        out, (conv, h) = ssm.mamba_forward(cfg, p, x)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        state = (torch.zeros((B, cfg.ssm_conv_width - 1, di),
                             device=DEVICE),
                 torch.zeros((B, di, cfg.ssm_state_dim), device=DEVICE))
        t0 = time.perf_counter()
        outs = []
        for t in range(S):
            o, state = ssm.mamba_decode(cfg, p, x[:, t:t + 1], state)
            outs.append(o)
        step = torch.cat(outs, 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    res = {"out": (out, step), "conv": (conv, state[0]),
           "h": (h, state[1])}
    errs = {k: float((a - b).abs().max()) for k, (a, b) in res.items()}
    bad = {k: errs[k] for k, (a, b) in res.items()
           if not excess(a, b, **FAMILY_TOL) <= 0}
    if bad:
        fail(f"families mamba mixer: chunked != stepwise: {bad}")
    return {"arch": JAMBA_MIXER["arch"], "d_model": cfg.d_model,
            "d_inner": di, "state": cfg.ssm_state_dim,
            "conv": cfg.ssm_conv_width, "B": B, "S": S,
            "params": sum(v.numel() for v in p.values()),
            "max_abs_err": errs, "forward_s": forward_s,
            "stepwise_decode_s": decode_s}


def zero_counts(counted):
    """Every launch count of the kernel wrappers in `counted` to 0."""
    for k in counted.values():
        for attr in ("launches", "launches_tc", "launches_split",
                     "launches_verify", "launches_blocked",
                     "launches_wide", "launches_row"):
            if hasattr(k, attr):
                setattr(k, attr, 0)


def flash_route_only(counted, what):
    """Fail unless the kernels launched since `zero_counts(counted)` are
    the flash route's alone (blocked_attention's bf16 self-attention on
    the grouped layout), every forward on the tensor cores."""
    launches = {name: k.launches for name, k in counted.items()}
    flash = counted["flash_attention"]
    if any(n for name, n in launches.items() if name != "flash_attention") \
            or flash.launches != flash.launches_tc:
        fail(f"{what}: kernels launched off the flash route: {launches}, "
             f"{flash.launches_tc} flash launches on the tensor cores")
    return launches


@contextlib.contextmanager
def blocked_attention_only():
    """blocked_attention on its query-blocked path whatever its inputs, as
    on meta tensors (which never take the flash route)."""
    from repro_torch.models import attention as attn
    route = attn.flash_route
    attn.flash_route = lambda *args: False
    try:
        yield
    finally:
        attn.flash_route = route


def families_phase(torch, M, get_config, steps_mod, counted):
    """The ssm, audio and vlm models at published widths (fp32 gates,
    bf16 prefill, decode and training) and jamba's mamba mixer.  The only
    kernel of the port on this path is the flash route's forward (the
    vlm's bf16 self-attention prefill: grouped heads, 512 tokens); the
    scans, the WKV recurrence and cross-attention are plain PyTorch, as
    the JAX package leaves them to XLA: every kernel's count is zeroed
    before and read after."""
    zero_counts(counted)
    t_phase = time.perf_counter()
    runs = {}
    for arch, run in FAMILY_RUNS.items():
        t0 = time.perf_counter()
        base = get_config(arch)
        if run["layers"]:
            base = dataclasses.replace(base, num_layers=run["layers"])
        cfg32 = dataclasses.replace(base, dtype="float32")
        params = family_params(torch, M, cfg32)
        n_params = sum(p.numel() for p in params.parameters())
        gate = family_gate(torch, M, cfg32, params, run["gate"])
        del params
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(base, dtype="bfloat16")
        params = family_params(torch, M, cfg)
        bf16 = family_bf16(torch, M, steps_mod, cfg, params, run["bf16"])
        train = (family_train(torch, M, steps_mod, cfg, params, run["train"])
                 if run["train"] else None)
        del params
        torch.cuda.empty_cache()
        runs[arch] = {"family": cfg.family, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                      "params": n_params, "fp32_gate": gate, "bf16": bf16,
                      "train": train, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    mixer = mamba_mixer_gate(torch, get_config)
    mixer["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launches = flash_route_only(counted, "families")
    emit({"phase": "families", "tolerance": FAMILY_TOL,
          "vlm_cross_gate": FAMILY_CROSS_GATE, "runs": runs,
          "mamba_mixer": mixer, "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def dryrun_phase(torch, counted):
    """The planner's predictions held against the card: each DRYRUN pair
    is traced by `launch.dryrun.run_one` on meta tensors at published
    widths, then its step runs once on the card in bf16 with random
    weights from a seed.  Gates: the bytes the card's allocator was asked
    for while the arguments were built (`requested_bytes`, before the
    allocator rounds them) equal the planner's argument_bytes; and, a
    dispatch-parity check rather than a prediction, the op counter run
    over the card's own step counts exactly the meta trace's flops (the
    counter's formulas read only shapes, so this fails only if CUDA
    dispatches other aten ops than meta).  Reported: max_memory_allocated
    (and the allocator's requested peak), less what the card held before
    the arguments, against the predicted peak_bytes; the step's
    CUDA-event ms against two bounds at H100 rates: the eager-traffic
    bound (the roofline of the op counter's unfused bytes and flops,
    which include every cast and copy eager PyTorch makes) and the floor
    (the larger of the argument bytes read once and the model flops).
    The meta trace runs blocked_attention's query-blocked path, so the
    parity check runs the card's step on it too (`blocked_attention_only`);
    the timed step runs the program as it is.  The steps are the
    flat-cache serve step and the train step: no kernel of the port lies
    on this path but the flash route, which the train step's attention
    takes (counts zeroed, then read)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as planner
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.sharding import AxisRules

    zero_counts(counted)
    t_phase = time.perf_counter()
    rows = []
    for arch, shape_name, batch in DRYRUN:
        t0 = time.perf_counter()
        cfg, shape, tags = get_config(arch), INPUT_SHAPES[shape_name], ""
        if batch:
            tags = f"global_batch {shape.global_batch}->{batch}"
            shape = dataclasses.replace(shape, global_batch=batch)
        rec = planner.run_one(arch, shape_name, shape=shape,
                              extra_tags=tags, verbose=False)
        spec = steps_mod.input_specs(cfg, shape,
                                     AxisRules(make_host_mesh(data=1)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        req0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
        alloc0 = torch.cuda.memory_allocated()
        args = planner.real_args(
            cfg, spec, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        torch.cuda.synchronize()
        arg_req = torch.cuda.memory_stats()["requested_bytes.all.current"] \
            - req0
        arg_alloc = torch.cuda.memory_allocated() - alloc0
        mem = rec["memory"]
        if arg_req != mem["argument_bytes"]:
            fail(f"dryrun {arch} x {shape_name}: the arguments took "
                 f"{arg_req} bytes on the card, the planner said "
                 f"{mem['argument_bytes']}")
        step = steps_mod.build_step(cfg, spec)
        counter = OpCost()
        counter.hold(args)
        with blocked_attention_only(), counter:
            out = step(*args)
        torch.cuda.synchronize()
        if counter.flops != rec["cost"]["flops"]:
            fail(f"dryrun {arch} x {shape_name}: the card's step counted "
                 f"{counter.flops} flops, the meta trace "
                 f"{rec['cost']['flops']}")
        card = {"flops": counter.flops, "bytes": counter.bytes}
        if spec["kind"] == "train":  # the next step takes the new state
            args = (out[0], out[1], args[2])
        del out
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        # both peaks less what the card held before the arguments
        peak = torch.cuda.max_memory_allocated() - alloc0
        peak_req = torch.cuda.memory_stats()["requested_bytes.all.peak"] \
            - req0
        del out, args, step, counter
        torch.cuda.empty_cache()
        rf = rec["roofline"]
        floor = {"bytes": mem["argument_bytes"] / HBM_BYTES_PER_S * 1e3,
                 "operations": rec["cost"]["model_flops"]
                 / PEAK_FLOPS[cfg.dtype] * 1e3}
        floor_by = max(floor, key=floor.get)
        rows.append({
            "arch": arch, "shape": shape_name, "tags": tags,
            "kind": rec["kind"], "variant": rec["variant"],
            "B": shape.global_batch, "n_params": rec["n_params"],
            "argument_bytes": mem["argument_bytes"],
            "argument_bytes_card_requested": arg_req,
            "argument_bytes_card_allocated": arg_alloc,
            "flops": rec["cost"]["flops"], "flops_card": card["flops"],
            "bytes_accessed": rec["cost"]["bytes_accessed"],
            "bytes_accessed_card": card["bytes"],
            "peak_bytes": mem["peak_bytes"], "peak_bytes_card": peak,
            "peak_ratio": peak / mem["peak_bytes"],
            "peak_requested_ratio": peak_req / mem["peak_bytes"],
            "ms": ms, "eager_bound_ms": rf["bound_s"] * 1e3,
            "eager_bound_by": rf["bottleneck"],
            "ms_over_eager_bound": ms / (rf["bound_s"] * 1e3),
            "floor_ms": floor[floor_by], "floor_by": floor_by,
            "ms_over_floor": ms / floor[floor_by],
            "trace_s": rec["trace_s"],
            "seconds": time.perf_counter() - t0})
    launches = flash_route_only(counted, "dryrun")
    emit({"phase": "dryrun", "card": card_line(), "pairs": rows,
          "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def paged_timing(torch, np, F, paged_mod, rng, heads, n_pages, window,
                 shapes, what):
    """bf16 paged_attention at each of `shapes` (name -> B, Q, live
    lengths) with `heads` = (KV, G, hd, page size, pages a row): the
    kernel held within one bf16 ulp of the plain version on the fp32
    upcast of its inputs, on the launcher's route; then its device time
    (profiler time over 4 rotating pool copies, > 50 MB of pages: the
    plain version, the kernel twice, the plain version, then gather +
    SDPA), CUDA-event times of back-to-back calls, and its bound.  On
    the split and verify routes the last timed call on each copy must
    equal that copy's first call bit for bit, and the routes' counters
    be zero after the timed calls (a launch that skipped its runs'
    merge would show as a fast time).  -> timing by shape name."""
    paged_attention = paged_mod.paged_attention
    plain = paged_mod.paged_attention_plain
    KV, G, hd, ps, P = heads
    lib = library_call(torch, F, window)
    timing = {}
    for name, sh in shapes.items():
        rot = [paged_inputs(torch, np, rng, sh["B"], KV, G, hd, ps, P,
                            sh["Q"], torch.bfloat16, n_pages=n_pages,
                            lengths=sh["lengths"]) for _ in range(4)]
        inp = rot[0]
        before = paged_counts(paged_attention)
        got = call(paged_attention, inp, window)
        torch.cuda.synchronize()
        route = took(before, paged_counts(paged_attention))
        want = call(plain, dict(
            inp, q=inp["q"].float(), k_pages=inp["k_pages"].float(),
            v_pages=inp["v_pages"].float()), window)
        ulp = one_ulp_excess(got, want)
        if not math.isfinite(ulp) or ulp > 0 \
                or route != paged_mod.route(torch.bfloat16, sh["Q"] * G,
                                            G, hd):
            fail(f"{what}paged_attention {name}: one-ulp excess {ulp}, "
                 f"{route} route")
        firsts = [got] + [call(paged_attention, r, window) for r in rot[1:]]
        del want, inp
        kept = {}  # q's address -> the last timed call's output

        def kernel(q, *args, **kw):
            kept[q.data_ptr()] = out = paged_attention(q, *args, **kw)
            return out
        iters = 50
        nbytes, flops = work(np, rot[0], window, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        # device time (profiler): CUDA events over back-to-back calls
        # measure the host's issue rate (~25 us a call) for a faster kernel
        runs = {"plain": [], "kernel": []}
        records = []  # the profiler's kernel records in each kernel run
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kernel
            runs[which].append(rotating_device_ms(
                torch, fn, rot, window, iters,
                records=records if fn is kernel else None))
        torch.cuda.synchronize()
        if route in ("split", "verify"):
            counters = paged_mod._counters[firsts[0].device]
            same = [torch.equal(kept[r["q"].data_ptr()], f)
                    for r, f in zip(rot, firsts)]
            if bool(counters.any()) or not all(same):
                fail(f"{what}paged_attention {name}: after the timed calls "
                     f"{int(counters.count_nonzero())} {route} counters are "
                     f"not zero; timed outputs equal to the first calls: "
                     f"{same}")
        del firsts, kept
        timing[name] = {
            "shape": {"B": sh["B"], "KV": KV, "QG": sh["Q"] * G, "hd": hd,
                      "page_size": ps, "P": P,
                      "live_tokens": int(np.sum(sh["lengths"]))},
            "timer": "device time per call (torch.profiler)",
            "ms": min(runs["kernel"]), "ms_runs": runs["kernel"],
            "kernel_records": records,
            "plain_ms": min(runs["plain"]), "plain_ms_runs": runs["plain"],
            "library_ms": rotating_device_ms(torch, lib, rot, window, iters),
            "events_ms": {  # back-to-back calls, bounded by the host
                "kernel": time_ms(torch, paged_attention, rot, window,
                                  iters),
                "plain": time_ms(torch, plain, rot, window, iters),
                "library": time_ms(torch, lib, rot, window, iters)},
            "kernel": {"tc": "tensor cores", "split": "split-KV",
                       "verify": "split-KV on the tensor cores (verify)",
                       "cuda_core": "CUDA cores"}[route],
            "one_ulp_excess": ulp,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
        del rot
    return timing


def moe_kernel_checks(torch, np, F, paged_mod, cfg):
    """The moe phase's (c): paged_attention at `cfg`'s heads (grok-1-314b:
    KV 8, G 6, hd 128) on the engine's pages and slots (8 rows): decode
    (QG 6), the verify span at spec_k 4 (QG 30) and at the ladder's
    spec_shrink (QG 18), a prefill chunk (256 tokens: QG 1536).  Each in
    fp32 and bf16 against the plain version and a gather + SDPA at TOL,
    on the launcher's route (the split route twice, bitwise equal); then
    `paged_timing` at each shape (bf16 within one ulp of the fp32 plain
    version, device times, bound).  -> (checks, timing, max abs error by
    dtype)."""
    from repro_torch.models.attention import head_layout
    paged_attention = paged_mod.paged_attention
    plain = paged_mod.paged_attention_plain
    KV, G, hd = cfg.kv_heads(), head_layout(cfg)[2], cfg.head_dim_()
    ps = ENGINE["page_size"]
    P = ENGINE["cache_len"] // ps
    n_pages = ENGINE["capacity"] * P + 1
    rng = np.random.default_rng(20)
    B = ENGINE["capacity"]
    lo, hi = PROMPT_LEN  # live lengths of the engine workload's spans
    C = ENGINE["prefill_chunk"]
    shapes = {
        "decode": dict(B=B, Q=1, lengths=rng.integers(lo + 1, hi + 33,
                                                      size=B)),
        "verify": dict(B=B, Q=SPEC_K + 1,
                       lengths=rng.integers(lo + 5, hi + 37, size=B)),
        "verify_shrink": dict(B=B, Q=SPEC_K // 2 + 1,
                              lengths=rng.integers(lo + 3, hi + 35, size=B)),
        "chunk": dict(B=B, Q=C,
                      lengths=C * rng.integers(1, hi // C + 1, size=B))}
    lib = library_call(torch, F, 0)
    checks = []
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, sh in shapes.items():
        Q = sh["Q"]
        for dtype_name in ("float32", "bfloat16"):
            inp = paged_inputs(torch, np, rng, B, KV, G, hd, ps, P, Q,
                               getattr(torch, dtype_name), n_pages=n_pages,
                               lengths=sh["lengths"])
            before = paged_counts(paged_attention)
            got = call(paged_attention, inp, 0)
            torch.cuda.synchronize()
            route = took(before, paged_counts(paged_attention))
            err = float((got.float() - call(plain, inp, 0).float())
                        .abs().max())
            lib_err = float((got.float() - call(lib, inp, 0).float())
                            .abs().max())
            checks.append({"shape": name, "dtype": dtype_name, "QG": Q * G,
                           "route": route, "max_abs_err": err,
                           "vs_library_max_abs_err": lib_err})
            if not (err <= TOL[dtype_name] and lib_err <= TOL[dtype_name]):
                fail(f"moe paged_attention {name} {dtype_name}: max abs err "
                     f"{err} (plain), {lib_err} (gather + SDPA) > "
                     f"{TOL[dtype_name]}")
            rule = paged_mod.route(getattr(torch, dtype_name), Q * G, G, hd)
            if route != rule:
                fail(f"moe paged_attention {name} {dtype_name} took the "
                     f"{route} route, not the {rule} route")
            if route in ("split", "verify") and not torch.equal(
                    got, call(paged_attention, inp, 0)):
                fail(f"moe paged_attention {name} {dtype_name}: two calls "
                     f"of the {route} route differ")
            worst[dtype_name] = max(worst[dtype_name], err)
            del got, inp
    timing = paged_timing(torch, np, F, paged_mod, rng, (KV, G, hd, ps, P),
                          n_pages, 0, shapes, "moe ")
    return checks, timing, worst


def moe_phase(torch, np, F, M, get_config, ServeEngine, synthetic_requests,
              Request, paged_mod):
    """The moe family at grok-1-314b's published widths, paged, through
    the kernel.  (c) the kernel at its head geometry (`moe_kernel_checks`).
    (a) fp32 gates at MOE_LAYERS["float32"] layers (TF32 off): the engine
    burst through the kernel must give the streams of the same engine
    with the kernel's plain version in its place, and of the overlapped
    tick; the flat layout overlapped those of the flat layout; spec ngram
    (spec_k 4) on the repetitive burst through the kernel those through
    the plain version.  A moe row's output depends on every row of its
    call (expert capacity drops), so streams can differ by design between
    paths whose calls batch other rows or give a free slot other values:
    the gather path (its rows of length 0 average the null page, the
    kernel's are zeros), the flat layout, spec against spec-off (the JAX
    engine's streams differ the same way, tests/test_torch_moe_serve.py);
    those equalities are reported.  Launches = layers x paged dispatches
    in every counted run, on the launcher's routes.  (b) bf16 at
    MOE_LAYERS["bfloat16"] layers: the engine burst synchronously and
    overlapped in turns (OVERLAP_ORDER), tokens/s, TTFT and TPOT; one
    synchronous run under torch.profiler (busy, idle share, top kernels,
    `paged_attention` by route); one overlapped run traced (a full-pool
    decode launch's host time against a step's device time).  The
    weights are freed before the phase returns.  -> launches by run and
    route, the kernel timing and errors."""
    from repro_torch.obs import Tracer
    t0 = time.perf_counter()
    seconds = {}
    base = get_config(MOE_ARCH)
    checks, timing, worst = moe_kernel_checks(torch, np, F, paged_mod, base)
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = []  # (run, (launches, tensor cores, split), rows)
    vocab = base.vocab_size

    def burst():
        return requests(np, synthetic_requests, vocab)

    def repetitive():
        return repetitive_requests(np, Request, vocab)

    def engine(cfg, params, **kw):
        return ServeEngine(cfg, params=params, seed=0, device=DEVICE,
                           **{**ENGINE, **kw})

    def counted(name, eng, reqs):
        m, s, n, rows = counted_paged_run(paged_mod, f"moe {name}", eng,
                                          reqs)
        launches.append((name, n, rows))
        if s["requests_finished"] != 8 or s["tokens_generated"] != 8 * 32:
            fail(f"moe {name}: {s['requests_finished']} finished, "
                 f"{s['tokens_generated']} tokens")
        return m, s

    def plain_run(eng, reqs):
        real = paged_mod.paged_attention
        paged_mod.paged_attention = paged_mod.paged_attention_plain
        try:
            return eng.run(reqs)
        finally:
            paged_mod.paged_attention = real

    # ---- (a) fp32 gates -----------------------------------------------------
    cfg32 = dataclasses.replace(base, num_layers=MOE_LAYERS["float32"],
                                dtype="float32")
    params32 = M.init_params(cfg32, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)

    def same(name, got, want, reqs):
        div = first_divergence(torch, np, M, cfg32, params32, got, want,
                               {r.rid: r.prompt for r in reqs})
        if div is not None:
            emit({"phase": "moe", "equal": False, "run": name, **div})
            fail(f"moe {name}: fp32 streams diverge at request "
                 f"{div['rid']} step {div['step']}")

    m, s = counted("kernel_fp32", engine(cfg32, params32), burst())
    want = streams(m)
    part_a = {"kernel": {k: s[k] for k in ("n_ticks", "decode_dispatches",
                                            "prefill_dispatches_total")}}
    same("plain", streams(plain_run(engine(cfg32, params32), burst())),
         want, burst())
    m, s = counted("overlap_fp32", engine(cfg32, params32, overlap=True),
                   burst())
    same("overlap", streams(m), want, burst())
    gather = streams(engine(cfg32, params32, paged_impl="gather").run(
        burst()))
    flat_sync = flat_run(np, ServeEngine, synthetic_requests, cfg32,
                         params32)[1]
    same("flat overlapped", flat_run(np, ServeEngine, synthetic_requests,
                                     cfg32, params32, overlap=True)[1],
         flat_sync, burst())
    spec_kw = dict(spec="ngram", spec_k=SPEC_K)
    m, s = counted("spec_fp32", engine(cfg32, params32, **spec_kw),
                   repetitive())
    spec = streams(m)
    if not s["spec_accepted_total"]:
        fail("moe spec_fp32: no draft accepted")
    same("spec plain", streams(plain_run(engine(cfg32, params32, **spec_kw),
                                         repetitive())), spec, repetitive())
    m, _ = counted("spec_off_fp32", engine(cfg32, params32), repetitive())
    part_a.update({
        "gated_equal": ["kernel == plain", "kernel == overlapped",
                        "flat == flat overlapped",
                        "spec kernel == spec plain"],
        "reported_equal": {"gather == kernel": gather == want,
                           "flat == kernel": flat_sync == want,
                           "spec == spec-off (repetitive)":
                               spec == streams(m)},
        "spec": {k: s[k] for k in ("spec_acceptance_rate",
                                   "spec_drafted_total",
                                   "spec_accepted_total",
                                   "tokens_per_dispatch")}})
    del params32, m
    torch.cuda.empty_cache()
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- (b) bf16 timing ----------------------------------------------------
    cfg16 = dataclasses.replace(base, num_layers=MOE_LAYERS["bfloat16"])
    torch.cuda.reset_peak_memory_stats()
    params16 = M.init_params(cfg16, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    init_peak = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() * p.element_size() for p in params16.parameters())
    warm = PROMPT_LEN[1] // 5  # a prompt of two prefill chunks
    engine(cfg16, params16).run(synthetic_requests(  # warm-up
        1, vocab_size=vocab, arrivals=np.zeros(1), prompt_len=(warm, warm),
        max_new_tokens=(2, 2), rng=np.random.default_rng(1)))
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
            "wall_s", "n_ticks")
    arms = {"sync": [], "overlap": []}
    for ovl in OVERLAP_ORDER:
        arm = "overlap" if ovl else "sync"
        _, s = counted(f"{arm}_bf16", engine(cfg16, params16, overlap=ovl),
                       burst())
        arms[arm].append({k: s[k] for k in keys})
    medians = {arm: float(np.median([r["tokens_per_s"] for r in runs]))
               for arm, runs in arms.items()}
    eng = engine(cfg16, params16)
    prof = profile_run(torch, lambda: eng.run(burst()))
    trc = Tracer(name="moe")
    launch, span_s = launch_vs_step(
        torch, engine(cfg16, params16, overlap=True, tracer=trc), trc,
        burst())
    peak = torch.cuda.max_memory_allocated()
    del params16, eng
    torch.cuda.empty_cache()
    seconds["b"] = time.perf_counter() - t0
    n, tc, split, ver = (sum(v[i] for _, v, _ in launches)
                         for i in range(4))
    emit({"phase": "moe", "arch": MOE_ARCH, "layers": MOE_LAYERS,
          "d_model": base.d_model, "heads": base.num_heads,
          "kv_heads": base.kv_heads(), "head_dim": base.head_dim_(),
          "d_ff": base.d_ff, "experts": base.num_experts,
          "experts_per_token": base.experts_per_token,
          "capacity_factor": base.moe_capacity_factor, "vocab": vocab,
          **ENGINE,
          "a_fp32": part_a,
          "b_bf16": {"order": ["overlap" if o else "sync"
                               for o in OVERLAP_ORDER],
                     **{arm: {"runs": runs,
                              "tokens_per_s_median": medians[arm]}
                        for arm, runs in arms.items()},
                     "overlap_over_sync_median":
                         medians["overlap"] / medians["sync"],
                     "profile_sync": prof, "launch_vs_step": launch,
                     "traced_span_s": span_s, "weights_gb": weights / 1e9,
                     "init_peak_gb": init_peak / 1e9, "peak_gb": peak / 1e9},
          "c_kernels": {"tolerance": TOL, "max_abs_err": worst,
                        "checks": checks, "timing": timing},
          "launches": [{"run": name, "launches": v[0], "tensor_cores": v[1],
                        "split": v[2], "verify": v[3], "rows": rows}
                       for name, v, rows in launches],
          "seconds": seconds})
    return {"launches": n, "launches_tc": tc, "launches_split": split,
            "launches_verify": ver,
            "by_run": [[name, v[0]] for name, v, _ in launches],
            "timing": timing, "max_abs_err": worst}


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
    import repro_torch.kernels.paged_attention as paged_mod
    from repro_torch.kernels import scd as scd_mod
    from repro_torch.kernels.scd import scd_pass, scd_pass_plain
    from repro_torch.models import model as M
    from repro_torch import faults as faults_mod
    from repro_torch.serve import (DisaggEngine, Request,
                                   ScheduledSplitPolicy, ServeEngine,
                                   synthetic_requests)
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
        # 12 rows: the verify route in bf16, the split route in fp32)
        "verify_shrink": dict(B=8, Q=SPEC_K // 2 + 1,
                              lengths=rng.integers(35, 1571, size=8)),
    }
    worst = {}
    checks = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        err = 0.0
        cases = ([(c, None, None)
                  for c in paged_mod.SELFTEST_CASES + TC_PAGED_CASES]
                 + [(c, None, lens) for c, lens in SPLIT_PAGED_CASES
                    + VERIFY_PAGED_CASES]
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
            rule = paged_mod.route(dtype, Q * g, g, d)
            if route != rule:
                fail(f"paged_attention {dtype_name} case {case} took the "
                     f"{route} route, not the {rule} route")
            if route in ("split", "verify") and not torch.equal(
                    got, call(paged_attention, inp, win)):
                fail(f"paged_attention {dtype_name} case {case}: two calls "
                     f"of the {route} route differ")
            if route == "verify":  # its masks' edges, to one bf16 ulp
                ulp = one_ulp_excess(got, call(paged_attention_plain, dict(
                    inp, q=inp["q"].float(), k_pages=inp["k_pages"].float(),
                    v_pages=inp["v_pages"].float()), win))
                checks[-1]["one_ulp_excess"] = ulp
                if not ulp <= 0:
                    fail(f"paged_attention {dtype_name} case {case}: the "
                         f"verify route is {ulp} past one bf16 ulp of the "
                         f"fp32 plain version")
            err = max(err, e)
        worst[dtype_name] = err
    scd_err, scd_cases = check_scd(torch, np, scd_pass, scd_pass_plain,
                                   scd_mod)
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
    def scale_policy():
        return ElasticScalingPolicy([ScaleEvent(*e) for e in SCALE_EVENTS])

    eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                      device=DEVICE, policies=[scale_policy()], **ENGINE)
    reqs = requests(np, synthetic_requests, cfg.vocab_size)
    span_log, restore = record_paged_launches(paged_mod)
    zero_paged(paged_attention)
    metrics = eng.run(reqs)
    launches, launches_tc, launches_split, launches_verify = paged_counts(
        paged_attention)
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
            or not launches_split or launches_verify \
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
    engine_s = {k: s[k] for k in ("tokens_per_s", "ttft_p50_s",
                                  "ttft_p99_s", "tpot_p50_s", "wall_s")}
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
                           device=DEVICE, policies=[scale_policy()],
                           **ENGINE)
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
    def bf16_params():
        return M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
            0), DEVICE)

    fault = faults_phase(
        torch, np, cfg32, params32, got["kernel"], ServeEngine, Request,
        synthetic_requests, faults_mod, overload_mod, paged_mod, bf16_params)
    torch.cuda.empty_cache()

    # ---- overlap: the overlapped tick at full width ----------------------
    ovl = overlap_phase(torch, np, M, cfg32, params32, got["kernel"],
                        got["spec"], ServeEngine, synthetic_requests,
                        faults_mod, scale_policy, paged_mod, bf16_params)
    torch.cuda.empty_cache()

    # ---- disagg: prefill and decode pools at full width ------------------
    dis = disagg_phase(torch, np, M, cfg32, params32, got["kernel"],
                       DisaggEngine, ScheduledSplitPolicy,
                       synthetic_requests, paged_mod, bf16_params,
                       engine_s, ovl["step_device_ms"])
    torch.cuda.empty_cache()

    # ---- cluster: jobs contending for simulated nodes of the card --------
    clu = cluster_phase(torch, np, M, cfg, cfg32, ServeEngine,
                        synthetic_requests, paged_mod)
    torch.cuda.empty_cache()

    # ---- moe: grok-1-314b at full width through the kernel ---------------
    moe = moe_phase(torch, np, F, M, get_config, ServeEngine,
                    synthetic_requests, Request, paged_mod)
    torch.cuda.empty_cache()

    # ---- flat: the flat KV layout at full width, bf16 --------------------
    flat_phase(torch, np, M, cfg, get_config, ServeEngine,
               synthetic_requests)
    torch.cuda.empty_cache()

    # ---- families: ssm, audio and vlm at published widths; jamba's mixer --
    from repro_torch.launch import steps as steps_mod
    counted = {"paged_attention": paged_attention, "scd_pass": scd_pass,
               "weighted_merge": weighted_merge,
               "flash_attention": flash_attention}
    fam = families_phase(torch, M, get_config, steps_mod, counted)
    torch.cuda.empty_cache()

    # ---- dryrun: the planner's predictions against the card --------------
    plan = dryrun_phase(torch, counted)
    torch.cuda.empty_cache()

    # ---- 5. cocoa, 6. lsgd: the training path at full width --------------
    torch.cuda.reset_peak_memory_stats()
    cocoa = cocoa_phase(torch, np)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wide = cocoa_wide_phase(torch, np)
    torch.cuda.empty_cache()

    # ---- examples: the five ported examples, then disagg at full width ----
    ex = examples_phase(torch, np, M, cfg32, params32, paged_mod)
    del params32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lsgd = lsgd_phase(torch, np)
    torch.cuda.empty_cache()

    # ---- 7. flash: the entry point at full width; 8-9. LM training -------
    flash = flash_phase(torch, np, F, cfg, flash_attention,
                        flash_attention_plain)
    flash_err = {k: max(e, flash["vs_plain_max_abs_err"][k])
                 for k, e in flash_err.items()}
    flash_train_phase(torch, np, cfg)
    lm_train_phase(torch)
    lm_elastic_phase(torch, np)

    # ---- 10. timing at the main path's shapes (bf16, the engine dtype) ----
    timing = paged_timing(torch, np, F, paged_mod, rng, (KV, G, hd, ps, P),
                          n_pages, cfg.sliding_window, shapes, "")
    dec = timing["decode"]
    train = training_timing(torch, np, scd_pass, scd_pass_plain,
                            weighted_merge, weighted_merge_plain, scd_mod)
    scd_t, merge_t = train["scd"], train["weighted_merge"]
    wide_launches = wide["scale_in"]["launches"] \
        + wide["rebalance"]["launches"] \
        + sum(v["scd_launches"] for v in wide["examples"].values())
    all_launches = launches + spec["launches"] + fault["launches"] \
        + ovl["launches"] + dis["launches"] + moe["launches"] \
        + clu["launches"] + fam["paged_attention"] + plan["paged_attention"] \
        + ex["launches"]
    all_tc = launches_tc + spec["launches_tc"] + fault["launches_tc"] \
        + ovl["launches_tc"] + dis["launches_tc"] + moe["launches_tc"] \
        + clu["launches_tc"] + ex["launches_tc"]
    all_split = launches_split + fault["launches_split"] \
        + ovl["launches_split"] + dis["launches_split"] \
        + moe["launches_split"] + clu["launches_split"] \
        + ex["launches_split"]
    all_verify = launches_verify + spec["launches_verify"] \
        + fault["launches_verify"] + ovl["launches_verify"] \
        + dis["launches_verify"] + moe["launches_verify"] \
        + clu["launches_verify"] + ex["launches_verify"]
    cuda_core = {k: v["launches"] - v["launches_tc"] - v["launches_split"]
                 - v["launches_verify"] for k, v in (("disagg", dis),
                                                     ("moe", moe),
                                                     ("cluster", clu),
                                                     ("examples", ex))}
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:47",
        "replaces_function": "src/repro/kernels/paged_attention.py"
                             "::_paged_kernel",
        "launches": all_launches,
        "launches_by_path": {"engine": launches, "spec": spec["launches"],
                             "faults": fault["by_run"],
                             "overlap": ovl["by_run"],
                             "disagg": dis["by_run"],
                             "moe": moe["by_run"],
                             "cluster": clu["by_run"],
                             "families": fam["paged_attention"],
                             "dryrun": plan["paged_attention"],
                             "examples": ex["by_run"]},
        "launches_tc": all_tc,
        "launches_split": all_split,
        "launches_verify": all_verify,
        "routes": {"split (decode)": launches_split,
                   "tensor cores (engine prefill chunks)": launches_tc,
                   "tensor cores (spec: chunks)": spec["launches_tc"],
                   "verify (spec: verify spans, bf16 QG 20)":
                       spec["launches_verify"],
                   "tensor cores (faults)": fault["launches_tc"],
                   "split (faults: decode, and fp32 verify)":
                       fault["launches_split"],
                   "verify (faults (c): bf16 verify spans)":
                       fault["launches_verify"],
                   "of which verify spans of 12 rows (spec_shrink)":
                       fault["verify_12_rows"],
                   "of which bf16 verify spans of 12 rows":
                       fault["verify_12_rows_bf16"],
                   "tensor cores (overlap: bf16 chunks)": ovl["launches_tc"],
                   "split (overlap: decode, fp32 and bf16)":
                       ovl["launches_split"],
                   "tensor cores (disagg: prefill pool, bf16 chunks)":
                       dis["launches_tc"],
                   "split (disagg: decode pool, fp32 and bf16)":
                       dis["launches_split"],
                   "CUDA cores (disagg: prefill pool, fp32 chunks)":
                       cuda_core["disagg"],
                   "tensor cores (moe: bf16 chunks, hd 128)":
                       moe["launches_tc"],
                   "split (moe: decode QG 6, hd 128, fp32 and bf16)":
                       moe["launches_split"],
                   "CUDA cores (moe: fp32 chunks and verify QG 30)":
                       cuda_core["moe"],
                   "tensor cores (cluster: bf16 chunks)":
                       clu["launches_tc"],
                   "split (cluster: decode, fp32 and bf16)":
                       clu["launches_split"],
                   "CUDA cores (cluster: fp32 chunks)":
                       cuda_core["cluster"],
                   "split (examples: disagg decode pool, fp32)":
                       ex["launches_split"],
                   "CUDA cores (examples: disagg prefill pool, fp32 "
                   "chunks)": cuda_core["examples"],
                   "CUDA cores": all_launches - all_tc - all_split
                   - all_verify},
        "sass": sass["paged_attention"],
        "max_abs_err": max(worst["float32"], moe["max_abs_err"]["float32"]),
        "max_abs_err_bf16": max(worst["bfloat16"],
                                moe["max_abs_err"]["bfloat16"]),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shapes": timing,
        "shapes_moe_hd128": moe["timing"]}, {
        "name": "scd_pass", "route": "cuda",
        "source": "src/repro_torch/csrc/scd.cu",
        "replaces": "src/repro/kernels/scd.py:62",
        "replaces_function": "src/repro/kernels/scd.py::scd_pass "
                             "(body _scd_kernel :25)",
        "launches": cocoa["scale_in"]["launches"]
                    + cocoa["rebalance"]["launches"] + clu["scd_launches"]
                    + wide_launches + fam["scd_pass"]
                    + plan["scd_pass"],
        "launches_by_path": {
            "cocoa": {"scale_in": cocoa["scale_in"]["launches"],
                      "rebalance": cocoa["rebalance"]["launches"]},
            "cocoa_wide": {"scale_in": wide["scale_in"]["launches"],
                           "rebalance": wide["rebalance"]["launches"],
                           **{k: v["scd_launches"] for k, v in
                              wide["examples"].items()}},
            "cluster": clu["scd_by_run"],
            "families": fam["scd_pass"], "dryrun": plan["scd_pass"]},
        "launches_blocked": cocoa["scale_in"]["launches_blocked"]
                            + cocoa["rebalance"]["launches_blocked"]
                            + clu["scd_launches_blocked"],
        "launches_wide": wide_launches,
        "routes": {"blocked (F <= 64: cocoa, cluster)":
                       cocoa["scale_in"]["launches_blocked"]
                       + cocoa["rebalance"]["launches_blocked"]
                       + clu["scd_launches_blocked"],
                   "wide (64 < F <= 4096: cocoa_wide and the two "
                   "examples)": wide_launches},
        "launches_tc": None, "sass": sass["scd"],
        "max_abs_err": scd_err, "ms": scd_t["ms"],
        "plain_ms": scd_t["plain_ms"], "bound_ms": scd_t["bound_ms"],
        "bound_by": scd_t["bound_by"], "library_ms": None,
        "chain_bound_ms": scd_t["chain_bound_ms"], "timing": scd_t,
        "timing_wide": scd_t["wide"], "timing_row": scd_t["row"]}, {
        "name": "weighted_merge", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_reduce.cu",
        "replaces": "src/repro/kernels/chunk_reduce.py:25",
        "replaces_function": "src/repro/kernels/chunk_reduce.py::"
                             "weighted_merge (body _merge_kernel :17)",
        "launches": lsgd["launches"] + fam["weighted_merge"]
                    + plan["weighted_merge"],
        "launches_by_path": {"lsgd": lsgd["launches"],
                             "families": fam["weighted_merge"],
                             "dryrun": plan["weighted_merge"]},
        "launches_tc": None,
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
        "launches": flash["launches"] + fam["flash_attention"]
                    + plan["flash_attention"],
        "launches_by_path": {"flash": flash["launches"],
                             "families": fam["flash_attention"],
                             "dryrun": plan["flash_attention"]},
        "launches_tc": flash["launches_tc"],
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
