"""Where the wide SCD kernel's time goes, on one NVIDIA GPU: patched copies
of `src/repro_torch/csrc/scd.cu` built into `build/` and timed at K=16,
M=4,096 (the `timing` phase's shapes), F in {128, 256, 2000} by default.

    python3 scripts/scd_wide_probe.py [F ...]

Prints one JSON line per variant and width, then one per width of a
clock64 timeline:
- variants (CUDA-event ms and SM cycles a step): `base` (the kernel as it
  is), `no_gram` (the Gram warps' FMAs skipped), `no_boundary` (the
  block-end v update and base dots skipped), `neither`; results of the
  last three are wrong, their time is what the skipped work costs;
- timeline (worker 0, blocks 4-59, medians in SM cycles): the chain's
  steps of a block and its wait between blocks; the Gram warps' rows'
  wait, FMAs, butterfly and barrier, and their wait on Q; the boundary
  warps' v update, barrier and base dots.  Timestamps go to shared memory
  and are copied out at the end (a global store before a barrier would
  delay the barrier).
"""
from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
GRAM = "for (int ch = sp; 4 * ch < F; ch += S) {"
VUPD = "for (int ch = p; 4 * ch < F; ch += kWideBoundP) {"
DOTS = "for (int ch = lane; 4 * ch < F; ch += 32) {"
STAMP = ("if (k == 0 && threadIdx.x == {t} && ({i}) >= 0 && ({i}) < 64) "
         "s_tr[{i}][{e}] = clock64();\n")
DUMP = ("if (k == 0 && threadIdx.x == {t}) for (int i = 0; i < 64; ++i) "
        "for (int e = {e0}; e < {e1}; ++e) g_trace[i][e] = s_tr[i][e];\n")
CHAIN, GRAMW, BOUND = 0, 32, 128  # thread 0, a Gram warp's, a boundary's


def stamp(t, i, e):
    return STAMP.format(t=t, i=i, e=e)


def skip(text, loop):
    """The loop's body never runs (its bound F becomes 0)."""
    assert text.count(loop) == 1, loop
    return text.replace(loop, loop.replace("< F", "< 0"))


def insert(text, anchor, before="", after=""):
    assert text.count(anchor) == 1, anchor
    return text.replace(anchor, before + anchor + after)


def traced(text):
    """The kernel with timestamps of worker 0 in shared memory, by block:
    the chain 0 (steps start), 1 (steps done); a Gram warp 2 (Gram
    start), 3 (rows in), 4 (FMAs done), 5 (Gram and parameters' barrier
    done), 10 (past Q); a boundary warp 6 (past S: block c-1 done), 7 (v
    updated), 8 (past the boundary barrier), 9 (block c's base dots done,
    arriving on Q)."""
    t = insert(text, "// ---- the wide kernel (64 < F <= 4096)",
               before="__device__ long long g_trace[64][16];\n")
    t = insert(t, "  extern __shared__ __align__(16) float smem[];\n"
               "  const int slot = B * F;",
               after="\n  __shared__ long long s_tr[64][16];")
    t = insert(t, "    float tk = 0.f;\n", before=stamp(CHAIN, "c", 0))
    t = insert(t, "    if (lane < B) sb[lane] = cm * tk;",
               before=stamp(CHAIN, "c", 1))
    t = insert(t, "      mbar_wait(smem_u32(&xbar[c % NS]), (c / NS) & 1);\n"
               "      if (gw * 32 < NT * S) {",
               before=stamp(GRAMW, "c", 2))
    t = insert(t, "      if (gw * 32 < NT * S) {", before=stamp(GRAMW, "c", 3))
    t = insert(t, "        reduce_scatter<TS * TS, S / 2>(acc, lane);",
               before=stamp(GRAMW, "c", 4))
    t = insert(t, "      if (gw == 0 && lane < B) {\n        const float* g",
               before=stamp(GRAMW, "c", 5))
    t = insert(t, "      nbar_sync<kWideThreads>(kBarQ);\n    }\n    return;",
               after="")
    t = t.replace("      nbar_sync<kWideThreads>(kBarQ);\n    }\n    return;",
                  "      nbar_sync<kWideThreads>(kBarQ);\n"
                  + stamp(GRAMW, "c", 10) + "    }\n"
                  + DUMP.format(t=GRAMW, e0=2, e1=6)
                  + DUMP.format(t=GRAMW, e0=10, e1=11) + "    return;")
    t = insert(t, "      nbar_sync<kWideBoundP + 32>(kBarS);  // warp 0 is "
               "done with block c\n", after=stamp(BOUND, "c + 1", 6))
    t = insert(t, "      nbar_sync<kWideBoundP>(kBarV);  // v is whole; "
               "block c's slot is read\n", before=stamp(BOUND, "c + 1", 7),
               after=stamp(BOUND, "c + 1", 8))
    t = insert(t, "      nbar_arrive<kWideThreads>(kBarQ);\n    };",
               before=stamp(BOUND, "c", 9))
    end = "    return;\n  }\n  if (warp > 0) {"
    t = insert(t, end, before=DUMP.format(t=BOUND, e0=6, e1=10))
    last = "      promote(c + 1);\n    }\n  }\n}"
    t = insert(t, last, before="")
    t = t.replace(last, last[:-1] + DUMP.format(t=CHAIN, e0=0, e1=2) + "}")
    return t + ('\nextern "C" int scd_trace_read(long long* host) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, g_trace, "
                "sizeof(g_trace));\n}\n")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("scd_wide_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import scd
    src = (CSRC / "scd.cu").read_text()
    variants = {"base": src, "no_gram": skip(src, GRAM),
                "no_boundary": skip(skip(src, VUPD), DOTS),
                "neither": skip(skip(skip(src, GRAM), VUPD), DOTS),
                "trace": traced(src)}
    widths = [int(a) for a in sys.argv[1:]] or [128, 256, 2000]
    clock = cs.sm_clock_hz()
    print(json.dumps({"card": cs.card_line(), "sm_clock_mhz": clock / 1e6}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    K, M = 16, 4096
    inputs = {}
    for F in widths:
        x = torch.randn(K, M, F, device="cuda", generator=gen)
        x /= x.norm(dim=-1, keepdim=True)
        y = torch.where(torch.rand(K, M, device="cuda", generator=gen)
                        > 0.5, 1.0, -1.0)
        inputs[F] = (x, y, torch.zeros(K, M, device="cuda"),
                     0.1 * torch.randn(F, device="cuda", generator=gen),
                     torch.ones(K, M, device="cuda"), 11000.0,
                     torch.full((K,), float(K), device="cuda"))
    for name, text in variants.items():
        d = ROOT / "build" / "probe_csrc" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / "scd.cu").write_text(text)
        build.CSRC = d
        build.BUILD_DIR = ROOT / "build" / f"kernels-probe-{name}"
        build._loaded.clear()
        lib = build.build("scd")["scd"]
        for F, args in inputs.items():
            if name != "trace":
                ms = [cs.cuda_ms(torch, lambda: scd.scd_pass(*args), 20)
                      for _ in range(2)]
                print(json.dumps({"variant": name, "F": F, "ms": ms,
                                  "cycles_per_step": [t * 1e-3 * clock / M
                                                      for t in ms]}),
                      flush=True)
                continue
            read = lib.scd_trace_read
            read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
            scd.scd_pass(*args)
            torch.cuda.synchronize()
            t = np.zeros((64, 16), np.int64)
            if read(t.ctypes.data):
                sys.exit("scd_wide_probe: reading the timeline failed")
            blocks = range(4, 60)

            def med(f):
                return float(statistics.median(f(c) for c in blocks))

            print(json.dumps({"F": F, "rows_a_block": scd.wide_rows(F),
                              "median_cycles": {
                "block": med(lambda c: t[c + 1, 0] - t[c, 0]),
                "chain: steps": med(lambda c: t[c, 1] - t[c, 0]),
                "chain: wait between blocks":
                    med(lambda c: t[c + 1, 0] - t[c, 1]),
                "gram: rows' mbarrier": med(lambda c: t[c, 3] - t[c, 2]),
                "gram: FMAs": med(lambda c: t[c, 4] - t[c, 3]),
                "gram: butterfly and barrier":
                    med(lambda c: t[c, 5] - t[c, 4]),
                "gram of c+1 done before steps of c":
                    med(lambda c: t[c, 1] - t[c + 1, 5]),
                "gram: wait on Q": med(lambda c: t[c, 10] - t[c, 5]),
                "boundary: S after steps":
                    med(lambda c: t[c + 1, 6] - t[c, 1]),
                "boundary: v update": med(lambda c: t[c, 7] - t[c, 6]),
                "boundary: barrier": med(lambda c: t[c, 8] - t[c, 7]),
                "boundary: dots": med(lambda c: t[c, 9] - t[c, 8]),
                "boundary: Q to steps": med(lambda c: t[c, 0] - t[c, 9])}}),
                  flush=True)


if __name__ == "__main__":
    main()
