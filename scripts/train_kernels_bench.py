"""Times the port's two training kernels, `weighted_merge` (local SGD) and
`scd_pass` (CoCoA), on one NVIDIA GPU at the training path's shapes.

    python3 scripts/train_kernels_bench.py [--src DIR] [--csrc DIR]

`--src` names the `src/` directory whose `repro_torch` is measured
(default: this checkout's), and `--csrc` another kernel source directory
to build it from (into `build/kernels-<dir name>/`), so two trees can be
compared in one run on one card, for example a `git archive` of the
parent commit unpacked under `build/`:

    python3 scripts/train_kernels_bench.py --src build/parent/src
    python3 scripts/train_kernels_bench.py

To time a kernel change against its parent, run the parent's tree and
this one in turns in one call (parent, change, change, parent).

Shapes and what is printed (one JSON line each):
- merge, fp32: K=16 at N=276,266 (the paper CNN's deltas) and at
  N=16,777,216; device time per call from torch.profiler over inputs that
  rotate past the 50 MB L2, beside `w @ u` timed the same way, and the
  byte bound at 3.35 TB/s;
- scd, F=28 at HIGGS's lambda*n (11,000): K=16 with M=4,096 and M=687,500
  (a K=16 pass of the `cocoa` path) and K=2 with M=5,500,000 (its K=2
  pass), plus the paper's F=128 and F=256 at K=16, M=4,096; CUDA-event
  time per pass, ns and SM cycles per step (at the card's maximum SM
  clock), and which kernel the launcher took (`launches_blocked`,
  `launches_wide`, where the tree counts them: a tree before the wide
  kernel runs F > 64 on its one-warp kernel).
The K=16, M=4,096 cases are held to the plain version at rtol/atol 1e-5
first; a failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAM_N = 11_000.0  # lambda 1e-3 x n 11,000,000, as the cocoa path
ROUTES = ("launches_blocked", "launches_wide")  # the trees' route counters


def scd_case(torch, gen, K, M, F):
    """Unit-norm rows, labels +-1, alpha 0 and mask 1 (a first pass), w
    small, sigma K: the cocoa path's inputs at its first iteration."""
    x = torch.randn(K, M, F, device="cuda", generator=gen)
    x /= x.norm(dim=-1, keepdim=True)
    y = torch.where(torch.rand(K, M, device="cuda", generator=gen) > 0.5,
                    1.0, -1.0)
    alpha = torch.zeros(K, M, device="cuda")
    w = 0.1 * torch.randn(F, device="cuda", generator=gen)
    mask = torch.ones(K, M, device="cuda")
    sigma = torch.full((K,), float(K), device="cuda")
    return x, y, alpha, w, mask, LAM_N, sigma


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--csrc", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_kernels_bench: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_reduce import (weighted_merge,
                                                  weighted_merge_plain)
    from repro_torch.kernels.scd import scd_pass, scd_pass_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.csrc:
        build.CSRC = Path(args.csrc).resolve()
        build.BUILD_DIR = ROOT / "build" / f"kernels-{build.CSRC.name}"
    head = {"src": str(build.CSRC), "card": cs.card_line()}
    build.build("chunk_reduce", "scd")
    clock = cs.sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []

    # merge: device time of kernel, w @ u and the plain version, in turns
    for K, N in ((16, 276_266), (16, 1 << 24)):
        n_rot = max(2, -(-200_000_000 // (K * N * 4)))
        rot = [(torch.randn(K, N, device="cuda", generator=gen),
                torch.rand(K, device="cuda", generator=gen))
               for _ in range(n_rot)]
        u, w = rot[0]
        err = float((weighted_merge(u, w) - weighted_merge_plain(u, w))
                    .abs().max())
        if not math.isfinite(err) or err > 1e-5 * (1 + float(
                weighted_merge_plain(u, w).abs().max())):
            failed.append(f"merge K={K} N={N}")
        it = [0]

        def nxt():
            it[0] += 1
            return rot[it[0] % len(rot)]

        fns = {"kernel": lambda: weighted_merge(*nxt()),
               "library": lambda: (lambda u, w: w @ u)(*nxt()),
               "plain": lambda: weighted_merge_plain(*nxt())}
        runs = {name: [] for name in fns}
        for name in ("kernel", "library", "plain", "plain", "library",
                     "kernel"):
            runs[name].append(cs.device_ms(torch, fns[name], 50))
        b_ms, b_by = cs.bound(*cs.merge_work(K, N, 4))
        print(json.dumps({**head, "kernel": "weighted_merge",
                          "shape": {"K": K, "N": N, "dtype": "float32"},
                          "ms_runs": runs["kernel"],
                          "library_ms_runs": runs["library"],
                          "plain_ms_runs": runs["plain"],
                          "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err}), flush=True)
        del rot, u, w
        torch.cuda.empty_cache()

    # scd at the cocoa path's shapes
    def time_scd(a, iters):
        n0 = {r: getattr(scd_pass, r, 0) for r in ROUTES}
        ms = cs.cuda_ms(torch, lambda: scd_pass(*a), iters)
        return ms, {r: getattr(scd_pass, r) - n0[r] for r in ROUTES
                    if hasattr(scd_pass, r)}

    for K, M, F, iters in ((16, 4096, 28, 20), (16, 4096, 128, 20),
                           (16, 4096, 256, 20), (16, 687_500, 28, 3),
                           (2, 5_500_000, 28, 2)):
        a = scd_case(torch, gen, K, M, F)
        row = {**head, "kernel": "scd_pass", "shape": {"K": K, "M": M,
                                                       "F": F}}
        if M == 4096:
            got = scd_pass(*a)
            want = scd_pass_plain(*a)
            excess = max(float(((g - t).abs() - 1e-5 * t.abs()).max())
                         for g, t in zip(got, want))
            row["max_abs_err"] = max(float((g - t).abs().max())
                                     for g, t in zip(got, want))
            if not math.isfinite(excess) or excess > 1e-5:
                failed.append(f"scd K={K} M={M} F={F}")
        ms1, routes = time_scd(a, iters)
        ms2, _ = time_scd(a, iters)
        b_ms, b_by = cs.bound(*cs.scd_work(K, M, F))
        ms = min(ms1, ms2)
        row.update({"ms_runs": [ms1, ms2], "ns_per_step": ms * 1e6 / M,
                    "cycles_per_step": ms * 1e-3 * clock / M,
                    "sm_clock_mhz": clock / 1e6,
                    "launches_by_route": routes, "calls": 2 * iters + 2,
                    "bound_ms": b_ms, "bound_by": b_by})
        print(json.dumps(row), flush=True)
        del a
        torch.cuda.empty_cache()

    if failed:
        sys.exit(f"train_kernels_bench: FAILED: {', '.join(failed)}")


if __name__ == "__main__":
    main()
