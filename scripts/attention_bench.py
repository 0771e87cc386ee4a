"""Times the port's two attention kernels on one NVIDIA GPU at the main
path's bf16 shapes, beside their library yardsticks, and holds each
output within one bf16 ulp of the plain version run on the fp32-cast
inputs (|got - want| <= 2^-7 |want| + 1e-5).

    python3 scripts/attention_bench.py [--src DIR] [--csrc DIR] [--iters N]

`--src` names the `src/` directory whose `repro_torch` is measured
(default: this checkout's), and `--csrc` another kernel source directory
to build it from (into `build/kernels-<dir name>/`), so two trees can be
compared in one run on one card, for example a `git archive` of the
parent commit unpacked under `build/`:

    python3 scripts/attention_bench.py --src build/parent/src
    python3 scripts/attention_bench.py

Shapes (h2o-danube-1.8b: KV=8, G=4, hd=80, window 4096):
- flash: `flash_attention` at B=4, S=4096, causal; the yardstick is
  `scaled_dot_product_attention(is_causal=True, enable_gqa=True)`;
- flash training (where the tree has the backward): `chip_smoke.py`'s
  `flash_train` phase at danube.train.seq4k's B=12, S=4096: the forward
  that writes the log-sum-exp and `flash_attention_bwd`, each held to its
  plain version and timed beside its bound (one JSON line, `"phase":
  "flash_train"`);
- paged chunk: a 256-token prefill chunk per row (B=4, QG=1024) over the
  engine's page pool (page_size 16, 128 pages a row); the yardstick is a
  gather plus SDPA (`chip_smoke.library_call`);
- paged decode: B=8, QG=4 over the same pool;
- paged verify spans, B=8 over the same pool, with the live lengths
  `chip_smoke.py` times them at: danube's spec span (q_span 5, QG 20) and
  its spec_shrink span (q_span 3, QG 12), then grok-1-314b's heads (G 6,
  hd 128, no window) at q_span 5 (QG 30) and 3 (QG 18).
Paged times rotate over four pool copies (> 50 MB) so pages come from
HBM.  `ms_runs` are CUDA events over 50 calls back to back, which the
host's issue rate bounds for a kernel under ~25 us; `device_ms_runs` are
the kernel's device time per call from torch.profiler; `host_us` is the
host's time to issue one call (the wrapper and the launch, 200 calls
back to back before one synchronize).  Prints one JSON line per shape
and exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("attention_bench: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.csrc:
        build.CSRC = Path(args.csrc).resolve()
        build.BUILD_DIR = ROOT / "build" / f"kernels-{build.CSRC.name}"
    head = {"src": str(build.CSRC), "card": cs.card_line()}
    build.build("flash_attention", "paged_attention")
    failed = []

    # flash at the path's shape
    B, S, KV, G, hd, win = 4, 4096, 8, 4, 80, 4096
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = cs.flash_inputs(torch, gen, B, S, KV, G, hd, torch.bfloat16)
    kw = dict(causal=True, window=win, group_size=G)
    n0 = getattr(flash_attention, "launches_tc", None)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tc = None if n0 is None else flash_attention.launches_tc - n0
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    ulp = cs.one_ulp_excess(got, want)
    err = float((got.float() - want).abs().max())
    del got, want
    torch.cuda.empty_cache()
    kern1 = cs.cuda_ms(torch, lambda: flash_attention(q, k, v, **kw),
                       args.iters)
    lib = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q.view(B, KV * G, S, hd), k.view(B, KV, S, hd),
        v.view(B, KV, S, hd), is_causal=True, enable_gqa=True), args.iters)
    kern2 = cs.cuda_ms(torch, lambda: flash_attention(q, k, v, **kw),
                       args.iters)
    nbytes, flops = cs.flash_work(np, B, S, KV * G, KV, hd, win, True, 2)
    bound = max(nbytes / cs.HBM_BYTES_PER_S,
                flops / cs.PEAK_FLOPS["bfloat16"]) * 1e3
    print(json.dumps({**head, "shape": "flash B=4 S=4096 KV=8 G=4 hd=80",
                      "launches_tc": tc, "ms_runs": [kern1, kern2],
                      "library_ms": lib, "bound_ms": bound,
                      "tflops": flops / min(kern1, kern2) / 1e9,
                      "max_abs_err_vs_fp32": err,
                      "one_ulp_excess": ulp}), flush=True)
    if not math.isfinite(ulp) or ulp > 0:
        failed.append("flash one-ulp check")
    del q, k, v
    torch.cuda.empty_cache()

    # the training step's attention (B=12): the forward that writes the
    # log-sum-exp and the backward kernel, where the tree has them
    import repro_torch.kernels.flash_attention as fa_mod
    if hasattr(fa_mod, "flash_attention_bwd"):
        from repro_torch.configs import get_config
        cs.flash_train_phase(torch, np, get_config("h2o-danube-1.8b"))

    # paged chunk, decode and verify spans over the engine's pool
    ps, P = 16, 128
    n_pages = 8 * P + 1
    rng = np.random.default_rng(0)
    danube = (KV, G, hd, win)
    for name, heads, Bp, Q, lengths in (
            ("chunk", danube, 4, 256, [512, 1280, 1024, 1536]),
            ("decode", danube, 8, 1, rng.integers(33, 1569, size=8)),
            *((name, heads, 8, Q, lens) for name, (heads, Q, lens)
              in cs.verify_shapes(np).items())):
        kvh, g, d, w = heads
        lib_call = cs.library_call(torch, F, w)
        rot = [cs.paged_inputs(torch, np, rng, Bp, kvh, g, d, ps, P, Q,
                               torch.bfloat16, n_pages=n_pages,
                               lengths=lengths) for _ in range(4)]
        inp = rot[0]
        before = {c: getattr(paged_attention, c, None) for c in
                  ("launches_tc", "launches_split", "launches_verify")}
        got = cs.call(paged_attention, inp, w)
        torch.cuda.synchronize()
        took = {c: None if n is None else getattr(paged_attention, c) - n
                for c, n in before.items()}
        f32 = dict(inp, q=inp["q"].float(), k_pages=inp["k_pages"].float(),
                   v_pages=inp["v_pages"].float())
        want = cs.call(paged_attention_plain, f32, w)
        ulp = cs.one_ulp_excess(got, want)
        err = float((got.float() - want).abs().max())
        kern1 = cs.time_ms(torch, paged_attention, rot, w, 50)
        libt = cs.time_ms(torch, lib_call, rot, w, 50)
        kern2 = cs.time_ms(torch, paged_attention, rot, w, 50)
        dev = [cs.rotating_device_ms(torch, fn, rot, w, 50)
               for fn in (paged_attention, lib_call, paged_attention)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(200):
            cs.call(paged_attention, rot[i % len(rot)], w)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        nbytes, flops = cs.work(np, inp, w, 2)
        bound = max(nbytes / cs.HBM_BYTES_PER_S,
                    flops / cs.PEAK_FLOPS["bfloat16"]) * 1e3
        print(json.dumps({**head, "shape": f"paged {name} B={Bp} "
                          f"QG={Q * g} hd={d}",
                          "live_tokens": int(np.sum(lengths)),
                          **took,
                          "ms_runs": [kern1, kern2], "library_ms": libt,
                          "device_ms_runs": [dev[0], dev[2]],
                          "library_device_ms": dev[1], "host_us": host_us,
                          "bound_ms": bound, "max_abs_err_vs_fp32": err,
                          "one_ulp_excess": ulp}), flush=True)
        if not math.isfinite(ulp) or ulp > 0:
            failed.append(f"paged {name} one-ulp check")
        del rot, inp, f32, got, want
        torch.cuda.empty_cache()
    if failed:
        sys.exit(f"attention_bench: FAILED: {', '.join(failed)}")


if __name__ == "__main__":
    main()
