"""Paper workload end-to-end: CoCoA/SCD SVM training with elastic scale-in,
duality-gap convergence, and per-sample dual state (alpha) riding along in
the chunks (paper §4.4/§5.3).

The PyTorch port's run of examples/cocoa_svm.py: the same data, chunking,
schedule, output and checks through `repro_torch.core`; the SCD passes run
on the card, every one through the wide SCD kernel (F = 128), or its plain
version on the CPU with --device cpu.

    PYTHONPATH=src python examples/cocoa_svm_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                              ElasticScalingPolicy, ScaleEvent, UniTaskEngine)
from repro_torch.data import make_svm_data


def run(device="cuda", n=20000, iters=12):
    """The example at `n` samples (at least 3,200: 16 chunks of 200) for
    `iters` iterations; returns the engine's history and the store."""
    x, y = make_svm_data(n, 128, seed=3)
    store = ChunkStore({"x": x, "y": y}, chunk_size=200)
    assignment = Assignment(store.n_chunks, 16, np.random.default_rng(0))
    # paper's scale-in scenario: 16 -> 2 workers, 2 nodes every 2 time units
    policy = ElasticScalingPolicy(
        [ScaleEvent(i * 2.0, max(16 - 2 * i, 2)) for i in range(8)])
    solver = CoCoASolver(store, lam=1e-3, device=device)
    engine = UniTaskEngine(store, assignment, [policy])

    hist = engine.run(iters, lambda s, a, sh: solver.step(s, a, sh),
                      solver.metric)
    for r in hist:
        print(f"iter {r.iteration:2d} epoch {r.epoch:5.2f} "
              f"workers {r.n_workers:2d} gap {r.metric:.5f}")
    assert hist[-1].metric < hist[0].metric
    assert hist[-1].n_workers == 2
    # alpha state lives in the store and was never reset by scaling
    assert store.state["alpha"].max() > 0
    print("CoCoA elastic SVM OK")
    return hist, store


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solver runs (default: the card)")
    run(ap.parse_args().device)
