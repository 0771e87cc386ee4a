"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build    — compile every CUDA kernel of the serving path from the
              sources in this checkout (one nvcc per source, all at once).
2. kernels  — each kernel against its plain PyTorch version on the card:
              the JAX kernel's self-test cases plus the full-width
              h2o-danube-1.8b shapes (decode and a 256-token prefill
              chunk), fp32 at 2e-5 (TF32 off) and bf16 at 2e-2.
3. engine   — the port's ServeEngine at full h2o-danube-1.8b width, bf16,
              random weights from a seed, through the kernel: 8 burst
              requests of 32-1536 prompt tokens (chunked prefill for the
              long ones), 32 new tokens each, scale events k 1 -> 2 -> 1.
              Launch counts are zeroed just before and read just after.
   profile  — the same run again under torch.profiler: device busy time,
              idle share and the largest kernels.
4. streams  — the same workload in fp32 through the kernel and through
              the gather path must give equal token streams; and a smoke
              size engine on the card must match the same engine on the
              CPU.
5. timing   — kernel, plain version, bound and library yardstick at the
              decode and chunk shapes, then the `kernels` line.

The last line is {"ok": true, "device": {...}}.  Without CUDA, or outside
a checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
SELFTEST_CASES = [(3, 2, 4, 32, 8, 4, 0, 1), (2, 1, 8, 64, 16, 3, 0, 1),
                  (4, 2, 2, 32, 8, 8, 16, 1), (3, 2, 4, 32, 8, 4, 0, 3),
                  (2, 2, 2, 32, 8, 6, 16, 4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def profile_run(torch, run):
    """Run `run()` under torch.profiler; return the device-time breakdown:
    busy seconds (sum of kernel, memcpy and memset time on the card), the
    wall seconds, the idle share and the largest kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:  # the profiler saw no device activity in this sandbox
        return {"wall_s": wall, "device_busy_s": None,
                "note": "torch.profiler recorded no device events"}
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    paged = sum(e.self_device_time_total for e in dev
                if "paged_attention" in e.key)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "paged_attention_share_of_busy": paged / busy_us,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "total_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def requests(np, synthetic_requests, vocab):
    return synthetic_requests(8, vocab_size=vocab, arrivals=np.zeros(8),
                              prompt_len=(32, 1536), max_new_tokens=(32, 32),
                              rng=np.random.default_rng(0))


def streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        sys.exit("chip_smoke: run it from a checkout of the repository "
                 "(src/repro_torch not found beside this script)")
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
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine, synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.build("paged_attention")
    build_s = time.perf_counter() - t0
    log = kbuild.library_path("paged_attention").with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "ptxas": ptxas})

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
    }
    worst = {}
    checks = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        err = 0.0
        cases = [(c, None) for c in SELFTEST_CASES] + [
            ((s["B"], KV, G, hd, ps, P, cfg.sliding_window, s["Q"]), s)
            for s in shapes.values()]
        for case, full in cases:
            B, kv, g, d, p_s, pp, win, Q = case
            inp = paged_inputs(torch, np, rng, B, kv, g, d, p_s, pp, Q, dtype,
                               n_pages=n_pages if full else None,
                               lengths=full["lengths"] if full else None)
            got = call(paged_attention, inp, win)
            torch.cuda.synchronize()
            want = call(paged_attention_plain, inp, win)
            e = float((got.float() - want.float()).abs().max())
            checks.append({"dtype": dtype_name, "case": list(case),
                           "max_abs_err": e})
            if not math.isfinite(e) or e > TOL[dtype_name]:
                fail(f"paged_attention {dtype_name} case {case}: max abs "
                     f"err {e} > {TOL[dtype_name]}")
            err = max(err, e)
        worst[dtype_name] = err
    emit({"phase": "kernels", "tolerance": TOL, "max_abs_err": worst,
          "cases": checks})

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
    paged_attention.launches = 0
    metrics = eng.run(reqs)
    launches = paged_attention.launches
    s = metrics.summarize()
    dispatches = s["decode_dispatches"] + s["prefill_dispatches_total"]
    toks = [t for r in metrics.requests for t in r.generated]
    if launches <= 0:
        fail("the engine run launched no paged_attention kernel")
    if launches != cfg.num_layers * dispatches:
        fail(f"{launches} kernel launches for {dispatches} paged "
             f"dispatches of {cfg.num_layers} layers")
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
          "launches_per_dispatch": launches / dispatches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # the same run again under the profiler: where the device time goes
    prof_eng = ServeEngine(cfg, params=params, paged_impl="kernel", seed=0,
                           device=DEVICE, policies=[ElasticScalingPolicy(
                               [ScaleEvent(0, 1), ScaleEvent(10, 2),
                                ScaleEvent(25, 1)])], **ENGINE)
    emit({"phase": "profile", **profile_run(torch, lambda: prof_eng.run(
        requests(np, synthetic_requests, cfg.vocab_size)))})
    del eng, prof_eng, params
    torch.cuda.empty_cache()

    # ---- 4. streams: kernel == gather (fp32, full width); card == CPU ----
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
    if got["kernel"] != got["gather"]:
        rid = min(r for r in got["kernel"]
                  if got["kernel"][r] != got["gather"][r])
        a, b = got["kernel"][rid], got["gather"][rid]
        step = next(i for i in range(len(a)) if a[i] != b[i])
        prompt = requests(np, synthetic_requests, cfg.vocab_size)[rid].prompt
        toks_in = torch.tensor(np.concatenate([prompt, b[:step]]),
                               device=DEVICE)[None]
        with torch.inference_mode():
            top2 = M.forward(cfg32, params32, toks_in)[0, -1].topk(2).values
        emit({"phase": "streams", "equal": False, "rid": rid, "step": step,
              "kernel_token": a[step], "gather_token": b[step],
              "top2_margin": float(top2[0] - top2[1])})
        fail(f"kernel and gather streams diverge at request {rid} step "
             f"{step}")
    del params32
    torch.cuda.empty_cache()
    small = smoke_variant(cfg)
    small_reqs = lambda: synthetic_requests(  # noqa: E731
        6, vocab_size=small.vocab_size, arrivals=np.zeros(6),
        prompt_len=(10, 40), max_new_tokens=(6, 10),
        rng=np.random.default_rng(2))
    small_kw = dict(capacity=4, cache_len=64, prefill_bucket=16,
                    page_size=8, prefill_chunk=16, seed=0)
    on_card = streams(ServeEngine(small, device=DEVICE, paged_impl="kernel",
                                  **small_kw).run(small_reqs()))
    cpu_params = M.init_params(
        small, torch.Generator(device=DEVICE).manual_seed(0),
        DEVICE).to("cpu")
    on_cpu = streams(ServeEngine(small, device="cpu", params=cpu_params,
                                 paged_impl="kernel",
                                 **small_kw).run(small_reqs()))
    if on_card != on_cpu:
        fail("smoke-size streams differ between the card and the CPU")
    emit({"phase": "streams", "equal": True, "full_width_fp32_tokens":
          sum(len(v) for v in got["kernel"].values()),
          "smoke_card_vs_cpu_tokens": sum(len(v) for v in on_card.values())})

    # ---- 5. timing at the main path's shapes (bf16, the engine dtype) -----
    lib = library_call(torch, F, cfg.sliding_window)
    timing = {}
    for shape_name, sh in shapes.items():
        rot = []
        for _ in range(4):  # 4 pool copies: > 50 MB of pages in rotation
            rot.append(paged_inputs(torch, np, rng, sh["B"], KV, G, hd, ps,
                                    P, sh["Q"], torch.bfloat16,
                                    n_pages=n_pages, lengths=sh["lengths"]))
        iters = 50
        nbytes, flops = work(np, rot[0], cfg.sliding_window, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        win = cfg.sliding_window
        plain1 = time_ms(torch, paged_attention_plain, rot, win, iters)
        kern1 = time_ms(torch, paged_attention, rot, win, iters)
        kern2 = time_ms(torch, paged_attention, rot, win, iters)
        plain2 = time_ms(torch, paged_attention_plain, rot, win, iters)
        timing[shape_name] = {
            "shape": {"B": sh["B"], "KV": KV, "QG": sh["Q"] * G, "hd": hd,
                      "page_size": ps, "P": P,
                      "live_tokens": int(np.sum(sh["lengths"]))},
            "ms": min(kern1, kern2), "ms_runs": [kern1, kern2],
            "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1,
                                                               plain2],
            "library_ms": time_ms(torch, lib, rot, win, iters),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
        del rot
    dec = timing["decode"]
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:47",
        "replaces_function": "src/repro/kernels/paged_attention.py"
                             "::_paged_kernel",
        "launches": launches, "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "shapes": timing}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
