"""End-to-end run (deliverable b): train a ~100M-param LM for a few
hundred steps with ELASTIC scaling mid-run — the worker pool shrinks from 8
to 2 and returns to 6 while the chunk scheduler redistributes data, without
recompilation or state loss (the paper's core scenario on the big-model
path).

The PyTorch port's run of examples/train_elastic_lm.py: the same two runs
(--quick: qwen3-4b at the tiny preset, 40 steps; default: the 100m preset,
300 steps of 16 x 256 tokens, checkpointed at the end), output and checks
through `repro_torch.launch.train`, on the card, or on the CPU with
--device cpu.  The checkpoint goes to `chicle_ckpt` in the temporary
directory (/tmp unless TMPDIR names another).

Full run:
    PYTHONPATH=src python examples/train_elastic_lm_torch.py [--device cpu]
Quick check:
    PYTHONPATH=src python examples/train_elastic_lm_torch.py --quick
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import train


def run(device="cuda", quick=False, ckpt_dir=None):
    """The example (`quick` as --quick); the full run checkpoints into
    `ckpt_dir`, by default `chicle_ckpt` in the temporary directory.
    Returns `train`'s output (history, params, config)."""
    if quick:
        out = train("qwen3-4b", scale="tiny", train_steps=40, global_batch=8,
                    seq_len=64, workers=8, elastic="5:8,15:2,25:6",
                    rebalance=True, lr=5e-3, log_every=5, device=device)
    else:
        out = train("qwen3-4b", scale="100m", train_steps=300,
                    global_batch=16, seq_len=256, workers=8,
                    elastic="50:8,120:2,200:6", rebalance=True,
                    lr=2e-3, log_every=10,
                    ckpt_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                      "chicle_ckpt"),
                    device=device)
    hist = out["history"]
    workers_seen = sorted({h["workers"] for h in hist})
    print(f"worker counts during run: {workers_seen}")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert len(workers_seen) >= 3, "elastic schedule should have fired"
    assert hist[-1]["loss"] < hist[0]["loss"]
    print("elastic LM training OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card)")
    args = ap.parse_args()
    run(args.device, quick=args.quick)
