"""Mobile, stateful data chunks + the chunk->task assignment table.

This is the paper's §3/§4.4 substrate:

- All training samples live in fixed-size chunks.  A chunk also carries
  *per-sample state* (e.g. CoCoA's dual variables alpha) in the same
  contiguous buffer region, so state always moves WITH its data — the
  invariant Chicle gets from its RDMA in-memory format, which we keep
  with host-side numpy views.
- The ownership contract: solvers may mutate chunk contents (state) during
  an iteration; only the scheduler mutates the assignment, strictly between
  iterations (`Assignment.move` asserts the engine is in scheduler phase).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Default generator for scheduler mutations when the caller does not thread
# an engine RNG through.  Module-level so successive default calls draw
# DIFFERENT picks (a fresh default_rng(0) per call made every invocation
# pick the same chunks, defeating the shuffle-on-move policies).
_default_rng = np.random.default_rng(0)


def default_rng() -> np.random.Generator:
    return _default_rng


class ChunkStore:
    """Training data + per-sample state, partitioned into fixed-size chunks."""

    def __init__(self, data: Dict[str, np.ndarray], chunk_size: int,
                 state: Optional[Dict[str, np.ndarray]] = None):
        ns = {len(v) for v in data.values()}
        assert len(ns) == 1, "all data arrays must share the sample dim"
        self.n_samples = ns.pop()
        self.chunk_size = int(chunk_size)
        self.data = data
        self.state = state or {}
        for v in self.state.values():
            assert len(v) == self.n_samples
        self.n_chunks = (self.n_samples + chunk_size - 1) // chunk_size

    def chunk_slice(self, cid: int) -> slice:
        lo = cid * self.chunk_size
        return slice(lo, min(lo + self.chunk_size, self.n_samples))

    def chunk_len(self, cid: int) -> int:
        s = self.chunk_slice(cid)
        return s.stop - s.start

    def chunk_sample_ids(self, cid: int) -> np.ndarray:
        s = self.chunk_slice(cid)
        return np.arange(s.start, s.stop)

    def get(self, name: str, cids: Sequence[int]) -> np.ndarray:
        return np.concatenate([self.data[name][self.chunk_slice(c)] for c in cids])


class Assignment:
    """chunk -> worker assignment; scheduler-owned between iterations."""

    def __init__(self, n_chunks: int, n_workers: int,
                 rng: Optional[np.random.Generator] = None):
        self.n_chunks = n_chunks
        rng = rng or np.random.default_rng(0)
        perm = rng.permutation(n_chunks)
        self.workers: List[List[int]] = [
            sorted(perm[w::n_workers].tolist()) for w in range(n_workers)]
        self._scheduler_phase = True

    # --- phase contract -------------------------------------------------
    def begin_iteration(self) -> None:
        self._scheduler_phase = False

    def end_iteration(self) -> None:
        self._scheduler_phase = True

    def _check(self) -> None:
        if not self._scheduler_phase:
            raise RuntimeError(
                "chunk assignment mutated during an iteration — the Chicle "
                "ownership contract forbids this (scheduler owns chunks only "
                "between iterations)")

    # --- queries ----------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return len(self.workers)

    def chunks_of(self, w: int) -> List[int]:
        return self.workers[w]

    def counts(self) -> np.ndarray:
        return np.array([len(c) for c in self.workers])

    def sample_counts(self, store: ChunkStore) -> np.ndarray:
        return np.array([sum(store.chunk_len(c) for c in w) for w in self.workers])

    # --- scheduler mutations (between iterations only) ---------------------
    def move(self, cid: int, src: int, dst: int) -> None:
        self._check()
        self.workers[src].remove(cid)
        self.workers[dst].append(cid)

    def move_n(self, n: int, src: int, dst: int,
               rng: Optional[np.random.Generator] = None) -> int:
        """Move up to n randomly-picked chunks src -> dst; returns moved count."""
        self._check()
        rng = rng or _default_rng
        n = min(n, len(self.workers[src]))
        picked = rng.choice(self.workers[src], size=n, replace=False)
        for cid in picked:
            self.move(int(cid), src, dst)
        return n

    def add_worker(self) -> int:
        self._check()
        self.workers.append([])
        return len(self.workers) - 1

    def remove_worker(self, w: int,
                      rng: Optional[np.random.Generator] = None) -> None:
        """Redistribute w's chunks round-robin to the remaining workers
        (paper: elastic scaling policy, revocation path)."""
        self._check()
        chunks = self.workers.pop(w)
        if not self.workers:
            raise RuntimeError("cannot remove the last worker")
        rng = rng or _default_rng
        order = rng.permutation(len(chunks))
        for i, j in enumerate(order):
            self.workers[i % len(self.workers)].append(chunks[j])

    def rebalance_even(self, rng: Optional[np.random.Generator] = None) -> None:
        """Even out chunk counts (used after scale events; the runtime-aware
        balancing lives in policies.RebalancePolicy)."""
        self._check()
        rng = rng or _default_rng
        while True:
            counts = self.counts()
            hi, lo = int(np.argmax(counts)), int(np.argmin(counts))
            if counts[hi] - counts[lo] <= 1:
                return
            self.move_n(1, hi, lo, rng)
