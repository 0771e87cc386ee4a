"""Where the time of the paged verify kernel goes, on one NVIDIA GPU.

    python3 scripts/paged_verify_probe.py

Builds copies of `src/repro_torch/csrc/` under `build/probe-verify/`,
each with one patch to `paged_attention.cu`'s verify kernel, and times
the four served bf16 verify spans (`chip_smoke.verify_shapes`: danube's
QG 20 and 12, grok-1-314b's heads at QG 30 and 18; B=8, page_size 16,
P=128) through each, by device time (torch.profiler,
`chip_smoke.rotating_device_ms`):
- base:      the kernel as committed;
- k256:      runs of 256 keys instead of 512;
- nomerge:   every run returns after writing its partial (no fence,
             counter or merge of the runs);
- nocompute: no QK^T, softmax or P.V (the gathers and both merges stay);
- nogather:  every K/V copy zero-filled (no reads of the pools);
- empty:     every block returns at once (the launch of the grid alone).
The patched kernels give wrong outputs; only their times are read.  Then
the committed kernel on danube's QG 20 span with every sequence at one
run (256 tokens: one wave of single-run blocks).  Prints one JSON line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC_ROW = "unsigned char verify_smem_raw[];\n"
PATCHES = {
    "base": [],
    "k256": [("constexpr int VERIFY_KEYS = 512;",
              "constexpr int VERIFY_KEYS = 256;")],
    "nomerge": [("  if (single) return;\n  merge_runs<__nv_bfloat16, true",
                 "  return;\n  merge_runs<__nv_bfloat16, true")],
    "nocompute": [("    if (max(lo_min, kq) < min(hi_max, kq + VSUB)) {",
                   "    if (kq < 0) {")],
    "nogather": [("      const long long off = roff_s[j0 + jr];",
                  "      const long long off = -1;")],
    "empty": [(SRC_ROW, SRC_ROW + "  if (s.QG > 0) return;\n")],
}


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_verify_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch.kernels.paged_attention as pa
    from repro_torch.kernels import build
    src = build.CSRC
    base_dir = ROOT / "build" / "probe-verify"
    dirs = {}
    for name, patches in PATCHES.items():
        d = dirs[name] = base_dir / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d / "csrc")
        cu = d / "csrc" / "paged_attention.cu"
        text = cu.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                sys.exit(f"paged_verify_probe: patch {name} does not apply")
            text = text.replace(old, new)
        cu.write_text(text)
    procs = []  # one nvcc per variant, all at once
    for name, d in dirs.items():
        build.CSRC, build.BUILD_DIR = d / "csrc", d / "kernels"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs.append((name, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(build.library_path("paged_attention")),
             str(build.CSRC / "paged_attention.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    for name, p in procs:
        _, err = p.communicate()
        if p.returncode:
            sys.exit(f"paged_verify_probe: {name} did not build:\n{err}")

    def use(name):
        build.CSRC = dirs[name] / "csrc"
        build.BUILD_DIR = dirs[name] / "kernels"
        build._loaded.pop("paged_attention", None)

    rng = np.random.default_rng(0)

    def inputs(heads, Q, lens):
        KV, G, hd, _ = heads
        return [cs.paged_inputs(torch, np, rng, 8, KV, G, hd, 16, 128, Q,
                                torch.bfloat16, n_pages=8 * 128 + 1,
                                lengths=lens) for _ in range(4)]

    shapes = {name: (heads[3], inputs(heads, Q, lens))
              for name, (heads, Q, lens) in cs.verify_shapes(np).items()}
    variants = {}
    for _ in range(2):  # two passes, interleaved
        for name in PATCHES:
            use(name)
            for shape, (window, rot) in shapes.items():
                n = pa.paged_attention.launches_verify
                ms = cs.rotating_device_ms(torch, pa.paged_attention, rot,
                                           window, 50)
                if pa.paged_attention.launches_verify == n:
                    sys.exit(f"paged_verify_probe: {name} {shape} took "
                             f"another route")
                variants.setdefault(name, {}).setdefault(
                    shape, []).append(ms)
    use("base")
    danube = cs.verify_shapes(np)["verify"][0]
    one_run = inputs(danube, 5, [256] * 8)
    print(json.dumps({
        "card": cs.card_line(),
        "live_tokens": {k: int(np.sum(v[2]))
                        for k, v in cs.verify_shapes(np).items()},
        "variants_device_ms": variants,
        "verify_all_one_run_device_ms": [
            cs.rotating_device_ms(torch, pa.paged_attention, one_run,
                                  danube[3], 50) for _ in range(2)]}),
        flush=True)


if __name__ == "__main__":
    main()
