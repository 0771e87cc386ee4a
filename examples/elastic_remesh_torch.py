"""TRUE device elasticity (remesh mode): the device pool shrinks 8 -> 2 and
grows back to 6 mid-training; the trainer re-places the training state on
the devices granted (the device-level analogue of moving Chicle's chunks)
and continues with the same train step — no state resets, loss keeps
falling.

The PyTorch port's run of examples/elastic_remesh.py: the same model, data,
resize schedule, output and check through `repro_torch.launch.elastic`, on
the card, or on the CPU with --device cpu.  The JAX example sets XLA_FLAGS
for 8 placeholder host devices so that its mesh really resizes; PyTorch
has no such placeholder devices, and the port's ElasticTrainer clamps k to
the devices present (as the JAX trainer does), so on one card, or on the
CPU, every resize line reads 1 device: the resize happens in name only.
On 8 cards it reads 8, 2 and 6.

    PYTHONPATH=src python examples/elastic_remesh_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.data import make_lm_tokens
from repro_torch.launch.elastic import ElasticTrainer
from repro_torch.launch.mesh import make_host_mesh


def run(device="cuda"):
    """The example; returns the 32 losses and the trainer."""
    cfg = smoke_variant(get_config("smollm-360m"))
    tc = TrainConfig(learning_rate=5e-3, remat=False)
    trainer = ElasticTrainer(cfg, tc, device=device)
    data = make_lm_tokens(512, 64, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)

    schedule = {8: 8, 16: 2, 24: 6}  # step -> device count
    losses = []
    for step in range(32):
        if step in schedule:
            trainer.resize(schedule[step])
            print(f"step {step}: RESIZED to {trainer.k} devices "
                  f"(mesh {make_host_mesh(trainer.k).shape})")
        idx = rng.integers(0, 512, 8)
        batch = {
            "tokens": data["tokens"][idx],
            "labels": data["labels"][idx],
            "weights": np.ones((8,), np.float32),
        }
        m = trainer.train_step(batch)
        losses.append(m["loss"])
        if step % 8 == 0 or step == 31:
            print(f"step {step:3d} devices {trainer.k} loss {m['loss']:.4f}")
    assert losses[-1] < losses[0], "loss should fall across resizes"
    print(f"elastic remesh OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"across device counts 8->2->6")
    return losses, trainer


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the card)")
    run(ap.parse_args().device)
