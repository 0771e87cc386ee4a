"""Chunk-aware batch pipeline bridging the Chicle core to the LM trainer:
assembles per-step global batches where each example carries the weight of
the uni-task worker whose chunks it came from (numpy; the same picks and
weights as the JAX package's `data/pipeline.py` for the same seed).

The (B,) `weights` vector IS the |D_k|/|D^| merge weighting: elastic scale
events and rebalancing change the chunk->worker table on the host, never
the train step.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.chunks import Assignment, ChunkStore


class ChunkBatchPipeline:
    def __init__(self, store: ChunkStore, assignment: Assignment, *,
                 global_batch: int, seed: int = 0):
        self.store = store
        self.assignment = assignment
        self.global_batch = global_batch
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> Dict[str, np.ndarray]:
        """Global batch with per-example uni-task weights.

        Each active worker contributes examples proportional to its share of
        samples; examples carry weight share_k * B / n_k so that the
        weighted-mean loss equals the Stich-weighted merge of per-worker
        updates.
        """
        a, store = self.assignment, self.store
        K = a.n_workers
        counts = a.sample_counts(store).astype(np.float64)
        shares = counts / max(counts.sum(), 1.0)
        per_worker = np.maximum(1, np.round(shares * self.global_batch)
                                ).astype(int)
        # fix rounding to hit the global batch exactly
        while per_worker.sum() > self.global_batch:
            per_worker[np.argmax(per_worker)] -= 1
        while per_worker.sum() < self.global_batch:
            per_worker[np.argmin(per_worker)] += 1

        picks, weights = [], []
        for w in range(K):
            cids = a.chunks_of(w)
            pool = (np.concatenate([store.chunk_sample_ids(c) for c in cids])
                    if cids else np.zeros(1, np.int64))
            picks.append(self.rng.choice(pool, size=per_worker[w]))
            # weight per example: worker share spread over its examples
            weights.append(np.full(per_worker[w],
                                   shares[w] * self.global_batch
                                   / per_worker[w], np.float32))
        idx = np.concatenate(picks)
        out = {k: v[idx] for k, v in store.data.items()}
        out["weights"] = np.concatenate(weights)
        return out
