"""Simulated device pool: N nodes with heterogeneous per-sample speeds.

The pool is the cluster-level analogue of the engines' node-speed model
(`UniTaskEngine.node_pst` / `MicroTaskEmulator.node_pst_pool`): each node i
has a per-sample-time multiplier pst[i] (1.0 = baseline, 1.5 = 50% slower —
the paper's heterogeneous-cluster construction).  Nodes are notionally
backed by the CUDA devices present, round-robin, which is how the
single-host examples simulate multi-node runs; on one card all nodes map
onto it and the pst vector carries the heterogeneity.  The pool needs a
card unless the caller passes its devices (the CPU tests pass
`devices=[torch.device("cpu")]`); nothing falls back to the CPU.

`reassign` converts an allocator decision (job -> node count) into concrete
node leases with minimal churn: jobs keep nodes they already hold, freed
nodes go to growing jobs fastest-first in the caller-supplied job order.
Node migrations are counted — with Chicle's mobile chunks a migration is
cheap (state moves with chunks), but the count is still a scheduling
quality metric.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch


class DevicePool:
    """Leasable pool of simulated heterogeneous nodes."""

    def __init__(self, n_nodes: int,
                 pst: Union[Sequence[float], Callable[[int], float], None] = None,
                 devices: Optional[Sequence] = None):
        if n_nodes <= 0:
            raise ValueError("n_nodes must be positive")
        self.n_nodes = int(n_nodes)
        if pst is None:
            self.pst = np.ones(n_nodes)
        elif callable(pst):
            self.pst = np.array([float(pst(i)) for i in range(n_nodes)])
        else:
            self.pst = np.asarray(list(pst), float)
            assert len(self.pst) == n_nodes
        if np.any(self.pst <= 0):
            raise ValueError("node per-sample times must be positive")
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DevicePool: CUDA is not available; pass devices=["
                    "torch.device('cpu')] to lease nodes on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        # node i is notionally hosted on devices[i % len(devices)]
        self.devices = [devices[i % len(devices)] if devices else None
                        for i in range(n_nodes)]
        self._owner: Dict[int, str] = {}  # node id -> job name
        self._last_owner: Dict[int, str] = {}  # node id -> last lessee ever
        self.migrations = 0  # grants of a node previously leased elsewhere
        # fault state: dead nodes never lease again; slow_node rescales a
        # node's pst relative to its construction-time baseline
        self._base_pst = self.pst.copy()
        self.dead: set = set()
        self.failures = 0

    # --- queries ----------------------------------------------------------
    def nodes_of(self, job: str) -> List[int]:
        return sorted(n for n, j in self._owner.items() if j == job)

    def free_nodes(self) -> List[int]:
        free = [n for n in range(self.n_nodes)
                if n not in self._owner and n not in self.dead]
        return sorted(free, key=lambda n: (self.pst[n], n))  # fastest first

    @property
    def n_alive(self) -> int:
        return self.n_nodes - len(self.dead)

    def psts_of(self, nodes: Sequence[int]) -> List[float]:
        return [float(self.pst[n]) for n in nodes]

    def n_leased(self) -> int:
        return len(self._owner)

    # --- faults -----------------------------------------------------------
    def fail_node(self, node: int) -> Optional[str]:
        """Abrupt permanent loss of one node (zero grace).  Returns the
        job that was leasing it (None if it was free or already dead) so
        the orchestrator can run that job's recovery path."""
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} out of range [0, {self.n_nodes})")
        if node in self.dead:
            return None
        self.dead.add(node)
        self.failures += 1
        return self._owner.pop(node, None)

    def slow_node(self, node: int, factor: float) -> None:
        """Straggler injection: node runs `factor`x its baseline per-sample
        time from now on (factor 1.0 restores full speed)."""
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} out of range [0, {self.n_nodes})")
        if factor <= 0:
            raise ValueError(f"slow factor must be > 0, got {factor}")
        self.pst[node] = self._base_pst[node] * factor

    # --- lease management -------------------------------------------------
    def release_all(self, job: str) -> None:
        for n in self.nodes_of(job):
            del self._owner[n]

    def reassign(self, alloc: Dict[str, int]) -> Dict[str, List[int]]:
        """Apply an allocator decision; returns job -> concrete node ids.

        Jobs keep currently-held nodes where possible (slowest nodes are
        surrendered first on shrink); grown jobs receive free nodes fastest-
        first, in dict order (callers pass priority-sorted dicts).
        """
        if sum(alloc.values()) > self.n_alive:
            raise ValueError("allocation exceeds live pool size")
        # drop leases of jobs absent from this allocation round
        for job in {j for j in self._owner.values()} - set(alloc):
            self.release_all(job)
        # phase 1: shrink (free the slowest nodes of over-provisioned jobs)
        for job, want in alloc.items():
            held = self.nodes_of(job)
            if len(held) > want:
                held_sorted = sorted(held, key=lambda n: (-self.pst[n], n))
                for n in held_sorted[: len(held) - want]:
                    del self._owner[n]
        # phase 2: grow from the free list, fastest nodes first; a grant
        # counts as a migration only when the node's state belonged to a
        # DIFFERENT job (first placements and re-grows of own nodes don't)
        for job, want in alloc.items():
            held = self.nodes_of(job)
            if len(held) < want:
                grant = self.free_nodes()[: want - len(held)]
                for n in grant:
                    if self._last_owner.get(n, job) != job:
                        self.migrations += 1
                    self._owner[n] = job
                    self._last_owner[n] = job
        return {job: self.nodes_of(job) for job in alloc}
