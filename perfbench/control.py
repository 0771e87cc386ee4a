"""Reads the numbers that a cell's correctness limits are set from, for
many seeds in one process (the set-up of a cell is long):

    python3 perfbench/control.py --workload <name> --program <p> \
        --seconds <s> --seeds <n> [<n> ...]

`--program port` runs the cell as the benchmark does (the lower readings);
a precision (`fp8` for the bfloat16 LM cells, `bfloat16` for the float32
GLM cell) puts the plain reference, computed at that precision, in the
program's place (the control, which has to come out not correct);
`--fault <name>` plants one of the system's faults.  Each seed prints one
JSON line with the compared numbers, their limits and the readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="port")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import pb_harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    spec = pb_harness.load_json(ROOT / "BENCHMARK.json")
    run = pb_harness.Run(spec, args.workload, root=ROOT,
                         fault=args.fault, program=args.program)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run(seed, args.seconds, False, "cuda", t0)
        print(json.dumps({
            "workload": args.workload, "program": args.program,
            "fault": args.fault, "seed": seed, "correct": res["correct"],
            "compared": {c["name"]: [c["value"], c["limit"]]
                         for c in res["compared"]},
            "readings": res["readings"], "attempted": res["attempted"],
            "run_s": time.perf_counter() - t0}, default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
