"""Chicle policy modules (§4.5): elastic scaling, rebalancing, stragglers.

Policies observe per-iteration events/metrics from the trainer and make
scheduling decisions between iterations — exactly the paper's contract.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import chunks
from .chunks import Assignment, ChunkStore


class Policy:
    def between_iterations(self, engine, stats: Dict) -> None:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class ScaleEvent:
    at_time: float
    n_workers: int


class ElasticScalingPolicy(Policy):
    """Scale the worker set according to a resource-manager schedule.

    The paper interfaces with YARN; here the 'resource manager' is either a
    schedule of (time, node-count) events (benchmarks replay the paper's
    2-nodes-every-20s scale-in/out) or a callable ``t -> target`` for
    dynamic decisions (e.g. `repro.cluster`'s fair-share allocator; the
    callable may return None for "no opinion right now").  Constructing the
    policy with an empty event list and no callable is a silent no-op and
    therefore raises.  On scale-out, chunks are picked randomly from old
    workers (the paper notes this *shuffles* data and helps CoCoA); on
    scale-in, revoked workers' chunks are redistributed round-robin.

    Every APPLIED scale decision is appended to ``stats['scale_events']`` as
    ``(sim_time, k_before, k_after)``; `UniTaskEngine` copies these into the
    iteration's `IterationRecord.events` so benchmarks can plot decision
    points against the convergence curve.
    """

    def __init__(self, schedule, rng=None):
        if callable(schedule):
            self._fn = schedule
            self.schedule: List[ScaleEvent] = []
        else:
            self._fn = None
            self.schedule = sorted(schedule or [], key=lambda e: e.at_time)
            if not self.schedule:
                raise ValueError(
                    "ElasticScalingPolicy with an empty event schedule and "
                    "no callable never fires; pass events or a callable")
        self.rng = rng  # None -> engine.rng at decision time

    def target_workers(self, t: float) -> Optional[int]:
        if self._fn is not None:
            tgt = self._fn(t)
            return None if tgt is None else int(tgt)
        n = None
        for ev in self.schedule:
            if ev.at_time <= t:
                n = ev.n_workers
        return n

    def between_iterations(self, engine, stats: Dict) -> None:
        tgt = self.target_workers(engine.sim_time)
        if tgt is None or tgt == engine.assignment.n_workers:
            return
        k_before = engine.assignment.n_workers
        stats.setdefault("scale_events", []).append(
            (float(engine.sim_time), k_before, int(tgt)))
        a = engine.assignment
        rng = self.rng if self.rng is not None else \
            getattr(engine, "rng", None) or chunks.default_rng()
        while a.n_workers < tgt:  # scale out
            new_w = a.add_worker()
            engine.on_worker_added(new_w)
            # pull a fair share of chunks, picked randomly from each old worker
            share = a.n_chunks // a.n_workers
            donors = list(range(a.n_workers - 1))
            i = 0
            while len(a.chunks_of(new_w)) < share and donors:
                d = donors[i % len(donors)]
                if len(a.chunks_of(d)) > 1:
                    a.move_n(1, d, new_w, rng)
                i += 1
                if i > 10 * a.n_chunks:
                    break
        while a.n_workers > tgt:  # scale in (advance notice -> move chunks out)
            w = a.n_workers - 1
            engine.on_worker_removed(w)
            a.remove_worker(w, rng)


class RebalancePolicy(Policy):
    """Learn per-sample runtime per worker (median over the last I iterations)
    and gradually move chunks from slower to faster workers until runtime
    differences fall below the estimated processing time of one chunk."""

    def __init__(self, window: int = 3, max_moves_per_gap: int = 4):
        self.window = window
        self.max_moves = max_moves_per_gap
        self.history: Dict[int, Deque[float]] = {}

    def observe(self, worker: int, per_sample_time: float) -> None:
        self.history.setdefault(worker, deque(maxlen=self.window)).append(
            per_sample_time)

    def estimate(self, worker: int) -> Optional[float]:
        h = self.history.get(worker)
        if not h or len(h) < min(self.window, 2):
            return None
        return float(np.median(h))

    def between_iterations(self, engine, stats: Dict) -> None:
        a = engine.assignment
        store = engine.store
        # record observations from the last iteration
        for w, t in stats.get("per_sample_times", {}).items():
            self.observe(w, t)
        est = {w: self.estimate(w) for w in range(a.n_workers)}
        if any(v is None for v in est.values()):
            return
        counts = a.sample_counts(store)
        times = np.array([est[w] * counts[w] for w in range(a.n_workers)])
        chunk_cost = np.array([est[w] * store.chunk_size for w in range(a.n_workers)])
        # move chunks from the slowest to the fastest until the projected
        # runtime gap is below one chunk's processing time (paper §4.5)
        for _ in range(self.max_moves):
            slow = int(np.argmax(times))
            fast = int(np.argmin(times))
            if times[slow] - times[fast] <= chunk_cost[slow]:
                return
            if len(a.chunks_of(slow)) <= 1:
                return
            moved = a.move_n(1, slow, fast, engine.rng)
            if not moved:
                return
            times[slow] -= chunk_cost[slow]
            times[fast] += chunk_cost[fast]
        stats["rebalanced"] = True


class StragglerMitigationPolicy(Policy):
    """Detect one-off stragglers: a worker whose last iteration took more
    than `threshold`x its own median gets one chunk offloaded to the fastest
    worker (transient slowness; complements RebalancePolicy which tracks
    persistent speed differences)."""

    def __init__(self, threshold: float = 2.0, window: int = 5):
        self.threshold = threshold
        self.history: Dict[int, Deque[float]] = {}
        self.window = window

    def between_iterations(self, engine, stats: Dict) -> None:
        times: Dict[int, float] = stats.get("task_times", {})
        for w, t in times.items():
            self.history.setdefault(w, deque(maxlen=self.window)).append(t)
        if not times:
            return
        a = engine.assignment
        med = {w: float(np.median(self.history[w])) for w in times}
        fastest = min(times, key=lambda w: times[w])
        for w, t in times.items():
            if med[w] > 0 and t > self.threshold * med[w] and w != fastest:
                if len(a.chunks_of(w)) > 1:
                    a.move_n(1, w, fastest, engine.rng)
                    stats.setdefault("straggler_moves", []).append((w, fastest))


class ShufflePolicy(Policy):
    """Global background data shuffling (paper §4.5 'other policies'):
    every `period` iterations, swap random chunk pairs between random workers."""

    def __init__(self, period: int = 10, pairs: int = 4, rng=None):
        self.period = period
        self.pairs = pairs
        self.rng = rng or np.random.default_rng(2)
        self._it = 0

    def between_iterations(self, engine, stats: Dict) -> None:
        self._it += 1
        if self._it % self.period:
            return
        a = engine.assignment
        if a.n_workers < 2:
            return
        for _ in range(self.pairs):
            w1, w2 = self.rng.choice(a.n_workers, size=2, replace=False)
            if a.chunks_of(int(w1)) and a.chunks_of(int(w2)):
                a.move_n(1, int(w1), int(w2), self.rng)
                a.move_n(1, int(w2), int(w1), self.rng)
