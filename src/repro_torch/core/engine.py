"""UniTaskEngine: the Chicle trainer loop, plus the paper's micro-task
emulation and time-projection methodology (§5.1, §5.3, §5.4).

The engine owns:
  - the ChunkStore and the chunk->worker Assignment (ownership contract),
  - the policies (elastic scaling, rebalancing, stragglers, shuffling),
  - a node-speed model (per-sample processing time per node) used to
    SIMULATE heterogeneous clusters on this single-host setup and to
    project iteration times exactly the way the paper does:

    * uni-tasks: iteration time = max_k samples_k * pst_k  (synchronous)
    * micro-tasks, K tasks on N nodes: tasks are identical units of
      |D|/K samples; the optimal schedule length is computed by water-
      filling task counts over nodes (== the paper's max(i*1.5, j*1.0) *
      16/K construction, generalized to any speed vector).

Convergence-per-epoch comes from actually running the algorithm at the
engine's data parallelism; convergence-over-time combines it with the
projected schedule — the paper's exact methodology (it, too, emulates
micro-tasks with Chicle at fixed K and projects optimal schedules).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs import PROGRAM_TRACER
from .chunks import Assignment, ChunkStore
from .policies import Policy


def microtask_schedule_len(n_tasks: int, task_time_unit: float,
                           node_psts: Sequence[float]) -> float:
    """Optimal makespan for n_tasks identical tasks (each task_time_unit *
    pst_node seconds on its node) over heterogeneous nodes: waterfill."""
    node_psts = list(node_psts)
    if not node_psts:
        return math.inf
    counts = [0] * len(node_psts)
    finish = [0.0] * len(node_psts)
    import heapq
    heap = [(task_time_unit * p, i) for i, p in enumerate(node_psts)]
    heapq.heapify(heap)
    for _ in range(n_tasks):
        t, i = heapq.heappop(heap)
        counts[i] += 1
        finish[i] = t
        heapq.heappush(heap, (t + task_time_unit * node_psts[i], i))
    return max(finish)


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    epoch: float
    sim_time: float
    metric: Optional[float]
    n_workers: int
    task_times: Dict[int, float]
    chunk_counts: List[int]
    # scale decisions applied by policies in this iteration's scheduler
    # phase, as (sim_time, k_before, k_after) — benchmark plot markers
    events: List = dataclasses.field(default_factory=list)


class UniTaskEngine:
    """Central trainer loop (the paper's 'trainer' + scheduler).

    Each iteration is an ``engine.iteration`` span (arg ``it``) of
    `obs.PROGRAM_TRACER` (which records only under a profiler) over its
    phases: ``engine.schedule``, ``engine.solver_step``,
    ``engine.metric``."""

    def __init__(self, store: ChunkStore, assignment: Assignment,
                 policies: Sequence[Policy], *,
                 node_pst: Callable[[int], float] = lambda w: 1.0,
                 comm_overhead: float = 0.0, seed: int = 0,
                 balance_processing: bool = True):
        self.store = store
        self.assignment = assignment
        self.policies = list(policies)
        self.node_pst = node_pst  # per-sample time of the node hosting worker w
        self.comm_overhead = comm_overhead
        self.rng = np.random.default_rng(seed)
        self.sim_time = 0.0
        self.iteration = 0
        self.samples_processed = 0
        self.history: List[IterationRecord] = []
        self.balance_processing = balance_processing
        self._last_stats: Dict = {}

    # -- elastic notifications (solvers may hook) -------------------------
    def on_worker_added(self, w: int) -> None:
        pass

    def on_worker_removed(self, w: int) -> None:
        pass

    # -- main loop ----------------------------------------------------------
    def run(self, iterations: int, solver_step: Callable[..., Dict],
            metric_fn: Callable[[], float], *, eval_every: int = 1) -> List[IterationRecord]:
        for _ in range(iterations):
            with PROGRAM_TRACER.span("engine.iteration", it=self.iteration):
                self._iteration(solver_step, metric_fn, eval_every)
        return self.history

    def _iteration(self, solver_step, metric_fn, eval_every: int) -> None:
        trc = PROGRAM_TRACER
        # ---- scheduler phase (owns chunks); policies see the LAST
        # iteration's timings (the paper's feedback loop) ----
        with trc.span("engine.schedule"):
            stats: Dict = dict(self._last_stats)
            for p in self.policies:
                p.between_iterations(self, stats)

            # ---- solver phase (workers own chunks) ----
            self.assignment.begin_iteration()
            K = self.assignment.n_workers
            shares = None
            if self.balance_processing:
                counts = self.assignment.sample_counts(
                    self.store).astype(float)
                shares = counts / max(counts.sum(), 1.0)
        with trc.span("engine.solver_step"):
            out = solver_step(self.store, self.assignment, shares)
        self.assignment.end_iteration()

        # ---- time accounting (simulated heterogeneous cluster) ----
        per_worker = np.asarray(out["per_worker_samples"], float)
        task_times = {w: per_worker[w] * self.node_pst(w) for w in range(K)}
        it_time = max(task_times.values()) + self.comm_overhead
        self.sim_time += it_time
        self.samples_processed += int(out["samples_processed"])
        self.iteration += 1

        stats["task_times"] = task_times
        stats["per_sample_times"] = {
            w: self.node_pst(w) for w in range(K)}
        self._last_stats = {"task_times": task_times,
                            "per_sample_times": stats["per_sample_times"]}

        metric = None
        if self.iteration % eval_every == 0:
            with trc.span("engine.metric"):
                metric = metric_fn()
        self.history.append(IterationRecord(
            iteration=self.iteration,
            epoch=self.samples_processed / self.store.n_samples,
            sim_time=self.sim_time,
            metric=metric,
            n_workers=K,
            task_times=task_times,
            chunk_counts=[len(c) for c in self.assignment.workers],
            events=list(stats.get("scale_events", [])),
        ))


class MicroTaskEmulator:
    """The paper's micro-task emulation: run the ALGORITHM at fixed data
    parallelism K_tasks (convergence per epoch depends only on K_tasks), and
    PROJECT time per iteration from the optimal task schedule on the nodes
    available at that moment (wave quantization included)."""

    def __init__(self, store: ChunkStore, k_tasks: int, *,
                 nodes_at: Callable[[float], int],
                 node_pst_pool: Callable[[int], float] = lambda i: 1.0,
                 comm_overhead: float = 0.0, seed: int = 0):
        self.store = store
        self.assignment = Assignment(store.n_chunks, k_tasks,
                                     np.random.default_rng(seed))
        self.k_tasks = k_tasks
        self.nodes_at = nodes_at
        self.node_pst_pool = node_pst_pool
        self.comm_overhead = comm_overhead
        self.sim_time = 0.0
        self.iteration = 0
        self.samples_processed = 0
        self.history: List[IterationRecord] = []

    def run(self, iterations: int, solver_step: Callable[..., Dict],
            metric_fn: Callable[[], float], *, eval_every: int = 1) -> List[IterationRecord]:
        for _ in range(iterations):
            self.assignment.begin_iteration()
            out = solver_step(self.store, self.assignment, None)
            self.assignment.end_iteration()

            n_nodes = max(1, int(self.nodes_at(self.sim_time)))
            psts = [self.node_pst_pool(i) for i in range(n_nodes)]
            per_task = np.asarray(out["per_worker_samples"], float).mean()
            it_time = microtask_schedule_len(self.k_tasks, per_task, psts) \
                + self.comm_overhead
            self.sim_time += it_time
            self.samples_processed += int(out["samples_processed"])
            self.iteration += 1

            metric = metric_fn() if self.iteration % eval_every == 0 else None
            self.history.append(IterationRecord(
                iteration=self.iteration,
                epoch=self.samples_processed / self.store.n_samples,
                sim_time=self.sim_time,
                metric=metric,
                n_workers=self.k_tasks,
                task_times={},
                chunk_counts=[len(c) for c in self.assignment.workers],
            ))
        return self.history


def epochs_to_target(history: Sequence[IterationRecord], target: float,
                     *, higher_is_better: bool) -> Optional[float]:
    for r in history:
        if r.metric is None:
            continue
        if (higher_is_better and r.metric >= target) or \
           (not higher_is_better and r.metric <= target):
            return r.epoch
    return None


def time_to_target(history: Sequence[IterationRecord], target: float,
                   *, higher_is_better: bool) -> Optional[float]:
    for r in history:
        if r.metric is None:
            continue
        if (higher_is_better and r.metric >= target) or \
           (not higher_is_better and r.metric <= target):
            return r.sim_time
    return None
