"""Where the time of the split-KV decode kernel goes, on one NVIDIA GPU.

    python3 scripts/paged_split_probe.py

Builds copies of `src/repro_torch/csrc/` under `build/probe-split/`, each
with one patch to `paged_attention.cu`'s split kernel, and times the
served decode call (B=8, KV=8, QG=4, hd=80, page_size 16, P=128, bf16,
the `chip_smoke.py` lengths) through each, by device time
(torch.profiler, `chip_smoke.rotating_device_ms`):
- base:      the kernel as committed;
- k128:      runs of 128 keys instead of 64;
- nomerge:   every run returns after writing its partial (no fence,
             counter or merge);
- nocompute: no QK^T and no P.V loops (the gathers, softmax and merges
             stay);
- nogather:  every K/V copy zero-filled (no reads of the pools);
- empty:     every block returns at once (the launch of the grid alone).
The patched kernels give wrong outputs; only their times are read.  Then
the committed kernel at other lengths: the decode shape, its longest
sequence alone (B=1), all eight sequences at that length, and all at one
run (64 tokens).  Prints one JSON line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATCHES = {
    "base": [],
    "k128": [("constexpr int SPLIT_KEYS = 64;",
              "constexpr int SPLIT_KEYS = 128;")],
    "nomerge": [("  if (single) return;\n  // the last live run",
                 "  return;\n  // the last live run")],
    "nocompute": [("    if (d0 < hd) {\n      float kf[VEC];",
                   "    if (d0 < 0) {\n      float kf[VEC];"),
                  ("for (int t = 0; t < KPW; ++t) {\n    const T* vr",
                   "for (int t = 0; t < 0; ++t) {\n    const T* vr")],
    "nogather": [("    const bool seen = my_pos >= ld_lo && my_pos < ld_hi;",
                  "    const bool seen = false;")],
    "empty": [("  using attn_mma::cp_async16;\n",
               "  using attn_mma::cp_async16;\n  if (s.QG > 0) return;\n")],
}


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_split_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch.kernels.paged_attention as pa
    from repro_torch.kernels import build
    src = build.CSRC
    base_dir = ROOT / "build" / "probe-split"
    dirs = {}
    for name, patches in PATCHES.items():
        d = dirs[name] = base_dir / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d / "csrc")
        cu = d / "csrc" / "paged_attention.cu"
        text = cu.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                sys.exit(f"paged_split_probe: patch {name} does not apply")
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
            sys.exit(f"paged_split_probe: {name} did not build:\n{err}")

    def use(name):
        build.CSRC = dirs[name] / "csrc"
        build.BUILD_DIR = dirs[name] / "kernels"
        build._loaded.pop("paged_attention", None)

    rng = np.random.default_rng(0)
    lengths = rng.integers(33, 1569, size=8)  # chip_smoke's decode lengths

    def inputs(B, lens):
        return [cs.paged_inputs(torch, np, rng, B, 8, 4, 80, 16, 128, 1,
                                torch.bfloat16, n_pages=8 * 128 + 1,
                                lengths=lens) for _ in range(4)]

    def ms(rot):
        return cs.rotating_device_ms(torch, pa.paged_attention, rot, 4096,
                                     100)

    rot = inputs(8, lengths)
    variants = {}
    for _ in range(2):  # two passes, interleaved
        for name in PATCHES:
            use(name)
            variants.setdefault(name, []).append(ms(rot))
    use("base")
    longest = int(lengths.max())
    shapes = {"decode": [ms(rot) for _ in range(2)]}
    for name, B, lens in (("longest_only", 1, [longest]),
                          ("all_longest", 8, [longest] * 8),
                          ("all_one_run", 8, [64] * 8)):
        r = inputs(B, lens)
        shapes[name] = [ms(r) for _ in range(2)]
    print(json.dumps({"card": cs.card_line(), "lengths": lengths.tolist(),
                      "variants_device_ms": variants,
                      "shapes_device_ms": shapes}), flush=True)


if __name__ == "__main__":
    main()
