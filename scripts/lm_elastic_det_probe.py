"""Repeats `chip_smoke.py`'s lm_elastic determinism check, on one NVIDIA GPU.

    python3 scripts/lm_elastic_det_probe.py [--rounds 3]

Under deterministic algorithms (cuBLAS workspace fixed, TF32 off, as
`chip_smoke.main` sets them), trains h2o-danube-1.8b at full width for
`det_steps` steps of 8 x 4096 tokens from seed 0: one uninterrupted
reference run, then `--rounds` rounds of an uninterrupted run and a run
suspended to the host after its first step and resumed, each held bit for
bit against the reference (params, momentum, step; `chip_smoke.state_diff`
names any leaf that differs).  Then the three training examples
(quickstart, train_elastic_lm's full run, elastic_remesh) on the card, and
the same rounds again, to see whether what ran before the check changes
it.  Prints one JSON line a run and a last summary line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.elastic import ElasticTrainer
    from repro_torch.models import model as M
    if not torch.cuda.is_available():
        sys.exit("lm_elastic_det_probe: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tc = get_config(cs.ARCH), TrainConfig()
    batches = cs.lm_batches(np, cfg)

    def run(suspend):
        tr = ElasticTrainer(cfg, tc, seed=0, device="cuda")
        losses = []
        for it in range(cs.LM_ELASTIC["det_steps"]):
            losses.append(tr.train_step(batches[it][1])["loss"])
            if suspend and it == 0:
                tr.suspend()
                tr.resume(1)
        state = cs.state_on_host(tr, M)
        del tr
        torch.cuda.empty_cache()
        return state, losses

    def rounds(tag):
        torch.use_deterministic_algorithms(True)
        try:
            ref, ref_losses = run(False)
            n_equal = 0
            for r in range(args.rounds):
                for suspend in (False, True):
                    t0 = time.perf_counter()
                    state, losses = run(suspend)
                    diff = cs.state_diff(torch, ref, state)
                    n_equal += not diff
                    print(json.dumps({
                        "tag": tag, "round": r, "suspended": suspend,
                        "run_s": time.perf_counter() - t0, "losses": losses,
                        "reference_losses": ref_losses,
                        "leaves_differing": len(diff),
                        "leaves": diff[:8]}), flush=True)
            return n_equal
        finally:
            torch.use_deterministic_algorithms(False)

    def example(name):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    fresh = rounds("fresh")
    t0 = time.perf_counter()
    example("quickstart_torch").run("cuda")
    with tempfile.TemporaryDirectory() as d:
        example("train_elastic_lm_torch").run("cuda", ckpt_dir=d)
    example("elastic_remesh_torch").run("cuda")
    examples_s = time.perf_counter() - t0
    after = rounds("after_examples")
    print(json.dumps({"card": cs.card_line(), "runs_per_tag":
                      2 * args.rounds, "equal_fresh": fresh,
                      "equal_after_examples": after,
                      "examples_s": examples_s}))


if __name__ == "__main__":
    main()
