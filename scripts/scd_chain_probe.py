"""Measures, with clock64() on one warp of an NVIDIA GPU, the latencies that
the blocked SCD kernel's chain model is built from: dependent FFMA, FMUL,
FADD, FADD.SAT and SHFL.IDX, then the kernel's chain step alone, with its
off-chain v update, and with the chain warp's block boundary (probe
kinds in `scripts/scd_chain_probe.cu`).

    python3 scripts/scd_chain_probe.py

Prints one JSON line: SM cycles per dependent step of each probe (the
median of 5 launches), the chain model built from the measured latencies
(8 FMA-class ops + one SHFL a step, as `chip_smoke.SCD_CHAIN_CYCLES`) and
the card's name and power limit.  Compare the last probe with the blocked
kernel's cycles a step in `scripts/train_kernels_bench.py`: the rest is
the producer warps' traffic and the hand-off between them and the chain.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ["ffma", "fmul", "fadd", "fadd_sat", "fadd_shfl_idx", "chain",
         "chain_v", "chain_warp0"]
ITERS = 4096  # x 32 dependent steps a launch


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("scd_chain_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    src = ROOT / "scripts" / "scd_chain_probe.cu"
    lib = ROOT / "build" / "probe" / "scd_chain_probe.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).scd_chain_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                            ctypes.c_void_p]
    inp = torch.cat([torch.ones(32), torch.full((32,), 1e-3),
                     torch.linspace(-1.0, 1.0, 64)]).cuda()
    out = torch.zeros(64, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for kind, name in enumerate(KINDS):
        runs = []
        for _ in range(6):  # the first launch warms up, not counted
            err = fn(kind, inp.data_ptr(), out.data_ptr(), cyc.data_ptr(),
                     ITERS, stream)
            if err:
                sys.exit(f"scd_chain_probe: launch of {name} failed: "
                         f"cudaError {err}")
            torch.cuda.synchronize()
            runs.append(int(cyc.item()) / (ITERS * 32))
        if not torch.isfinite(out).all():
            sys.exit(f"scd_chain_probe: {name} gave non-finite values")
        res[name] = statistics.median(runs[1:])
    res["shfl_idx"] = res["fadd_shfl_idx"] - res["fadd"]
    fma = max(res[k] for k in ("ffma", "fmul", "fadd", "fadd_sat"))
    print(json.dumps({"card": cs.card_line(),
                      "cycles_per_step": res,
                      "model_cycles_per_step": 8 * fma + res["shfl_idx"],
                      "model": "8 x max(FFMA, FMUL, FADD, FADD.SAT) + "
                               "SHFL.IDX (FADD+SHFL less FADD)",
                      "steps_per_launch": ITERS * 32}), flush=True)


if __name__ == "__main__":
    main()
