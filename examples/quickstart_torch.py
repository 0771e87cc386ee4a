"""Quickstart: train a reduced transformer with the Chicle uni-task pipeline
end-to-end in under a minute.

The PyTorch port's run of examples/quickstart.py: the same training run
(smoke smollm-360m, 30 steps, 4 workers), output and check through
`repro_torch.launch.train`, on the card, or on the CPU with --device cpu.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.train import train


def run(device="cuda"):
    """The example; returns `train`'s output (history, params, config)."""
    out = train("smollm-360m", smoke=True, train_steps=30, global_batch=8,
                seq_len=64, workers=4, lr=5e-3, log_every=5, device=device)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"quickstart OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card)")
    run(ap.parse_args().device)
