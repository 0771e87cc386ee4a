"""Heterogeneous-cluster load balancing demo (paper Fig. 6): 4 of 16 nodes
run 2x slower; the rebalance policy learns per-sample runtimes from
iteration timings and shifts chunks until task runtimes align.

The PyTorch port's run of examples/load_balancing.py: the same data,
chunking, nodes, policy, output and checks through `repro_torch.core`; the
SCD passes run on the card, every one through the wide SCD kernel
(F = 128), or its plain version on the CPU with --device cpu.

    PYTHONPATH=src python examples/load_balancing_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                              RebalancePolicy, UniTaskEngine)
from repro_torch.data import make_svm_data


def run(device="cuda", n=16000, iters=12):
    """The example at `n` samples (at least 1,600: 16 chunks of 100) for
    `iters` iterations; returns the engine's history."""
    x, y = make_svm_data(n, 128, seed=1)
    store = ChunkStore({"x": x, "y": y}, chunk_size=100)
    assignment = Assignment(store.n_chunks, 16, np.random.default_rng(0))
    psts = [2.0] * 4 + [1.0] * 12  # 4 throttled nodes (paper: 1.2GHz clamp)
    policy = RebalancePolicy(window=2, max_moves_per_gap=24)
    solver = CoCoASolver(store, lam=1e-3, device=device)
    engine = UniTaskEngine(store, assignment, [policy],
                           node_pst=lambda w: psts[w % 16])

    hist = engine.run(iters, lambda s, a, sh: solver.step(s, a, sh),
                      solver.metric)
    print("iter | iteration_time | slow-node chunks | swimlane (task times)")
    for r in hist:
        tt = max(r.task_times.values())
        slow = sum(r.chunk_counts[:4])
        lanes = " ".join(f"{r.task_times[w]:5.0f}" for w in range(16))
        print(f"{r.iteration:4d} | {tt:13.1f} | {slow:16d} | {lanes}")
    t_first = max(hist[0].task_times.values())
    t_last = max(hist[-1].task_times.values())
    assert t_last < t_first * 0.8, "rebalancer should cut iteration time >20%"
    print(f"load balancing OK: iteration time {t_first:.0f} -> {t_last:.0f}")
    return hist


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solver runs (default: the card)")
    run(ap.parse_args().device)
