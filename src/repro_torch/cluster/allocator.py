"""Weighted fair-share node allocator with priorities and preemption.

DRF-style share accounting specialized to one resource (nodes): every
demanding job's entitlement is proportional to its *effective weight*
``weight * priority_boost ** priority``, capped by its demand, allocated by
progressive filling (`core.fairshare.weighted_max_min`) and integerized by
largest remainder.  Priorities therefore tilt shares rather than imposing
strict classes — a high-priority serve burst preempts (shrinks) low-priority
trainers, but positive-weight jobs are never starved outright:

invariants (property-tested in tests/test_cluster.py):
  - sum(alloc) <= pool_size
  - alloc[j] <= demand[j]
  - work conserving: sum(alloc) == min(pool_size, sum(demand))
  - no starvation: if pool_size >= #{j : demand[j] > 0}, every demanding
    job with positive weight receives >= 1 node.

Preemption itself is an *orchestrator* event (an allocation that shrinks a
job which still has demand); the allocator is a pure function of the
current demand vector, which is what makes the decisions replayable.

**Allocator lookahead** (`UsageLedger`): the base allocator is memoryless
per tick, so a bursty job that monopolized the pool while others were idle
pays nothing back.  The ledger keeps a time-decayed integral of each job's
leased nodes and of its weighted fair entitlement; `credit()` turns the gap
into a bounded multiplier on the effective weight — jobs that recently ran
over their share repay credit over subsequent ticks, jobs that waited are
boosted, and the exponential decay forgets ancient history so long-run
shares still converge to the configured weights.  The allocator stays a
pure function: the ledger's snapshot is just one more replayable input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from ..core.fairshare import integerize_shares, weighted_max_min


@dataclasses.dataclass
class JobDemand:
    """One job's resource request as seen by the allocator this tick."""

    name: str
    demand: int  # max useful nodes right now (0 = idle/suspended)
    weight: float = 1.0
    priority: int = 0  # higher preempts lower via the effective weight
    # rolling SLO attainment reported by serving jobs (None = not a serving
    # job / no targets): a job missing its SLOs gets a bounded weight boost
    attainment: Optional[float] = None


class UsageLedger:
    """Time-decayed per-job usage accounting (allocator lookahead).

    Both integrals decay with half-life `half_life` (in simulated seconds):

      usage[j]    <- usage[j] * 2^(-dt/hl) + alloc[j] * dt
      fairness[j] <- fairness[j] * 2^(-dt/hl) + fair_share[j] * dt

    where fair_share[j] is the weight-proportional slice of the nodes the
    demanding jobs consumed that tick.  `credit(name)` returns
    clamp((fairness+eps)/(usage+eps), 1/credit_cap, credit_cap): a job that
    recently over-consumed gets < 1 (repays its burst), one that waited
    gets > 1, and a job with no history gets exactly 1.
    """

    def __init__(self, half_life: float = 8.0, credit_cap: float = 4.0,
                 eps: float = 1e-3):
        if half_life <= 0:
            raise ValueError("half_life must be positive")
        if credit_cap <= 1.0:
            raise ValueError("credit_cap must be > 1")
        self.half_life = float(half_life)
        self.credit_cap = float(credit_cap)
        self.eps = float(eps)
        self._usage: Dict[str, float] = {}
        self._fair: Dict[str, float] = {}

    def update(self, alloc: Dict[str, int],
               demands: Sequence[JobDemand], dt: float) -> None:
        """Fold one tick's allocation into the decayed integrals.

        The fair entitlement is the DEMAND-CAPPED weighted max-min split of
        what the demanding set actually consumed: capacity a satisfied
        low-demand peer cannot use flows to the others as entitlement, not
        debt — scavenging otherwise-idle nodes must never be penalized."""
        decay = math.pow(2.0, -dt / self.half_life)
        for k in list(self._usage):
            self._usage[k] *= decay
            self._fair[k] *= decay
        demanding = [d for d in demands if d.demand > 0]
        consumed = sum(alloc.get(d.name, 0) for d in demanding)
        fairs = (weighted_max_min(consumed, [d.demand for d in demanding],
                                  [max(d.weight, 1e-12) for d in demanding])
                 if demanding and consumed else [0.0] * len(demanding))
        for d, fair in zip(demanding, fairs):
            self._usage[d.name] = self._usage.get(d.name, 0.0) \
                + alloc.get(d.name, 0) * dt
            self._fair[d.name] = self._fair.get(d.name, 0.0) + fair * dt

    def credit(self, name: str) -> float:
        u = self._usage.get(name, 0.0)
        f = self._fair.get(name, 0.0)
        c = (f + self.eps) / (u + self.eps)
        return min(max(c, 1.0 / self.credit_cap), self.credit_cap)

    def snapshot(self) -> Dict[str, float]:
        return {k: self.credit(k) for k in self._usage}

    def forget(self, name: str) -> None:
        self._usage.pop(name, None)
        self._fair.pop(name, None)


class FairShareAllocator:
    """Pure weighted max-min allocator over a single node pool.

    `slo_boost` is the SLO-feedback tilt: a serving job reporting
    attainment `a` has its effective weight scaled by
    ``1 + (slo_boost - 1) * (1 - a)`` — a job fully meeting its SLOs
    (a=1) is unboosted, one missing every target (a=0) gets the full
    `slo_boost` multiplier.  Like the ledger's credit it only rescales
    positive weights, so every allocator invariant is preserved, and the
    bound keeps a collapsed serve job from starving trainers outright."""

    def __init__(self, priority_boost: float = 4.0, slo_boost: float = 2.0):
        if priority_boost <= 1.0:
            raise ValueError("priority_boost must be > 1")
        if slo_boost < 1.0:
            raise ValueError("slo_boost must be >= 1")
        self.priority_boost = priority_boost
        self.slo_boost = float(slo_boost)

    def effective_weight(self, d: JobDemand,
                         credit: Optional[Dict[str, float]] = None) -> float:
        c = credit.get(d.name, 1.0) if credit else 1.0
        s = 1.0
        if d.attainment is not None and self.slo_boost > 1.0:
            a = min(max(float(d.attainment), 0.0), 1.0)
            s = 1.0 + (self.slo_boost - 1.0) * (1.0 - a)
        return d.weight * self.priority_boost ** d.priority * c * s

    def allocate(self, pool_size: int, demands: Sequence[JobDemand],
                 credit: Optional[Dict[str, float]] = None) -> Dict[str, int]:
        """Integer node allocation per job name (jobs with 0 demand get 0).

        credit: optional `UsageLedger.snapshot()` multipliers — bounded
        usage-history tilts that keep every invariant below intact (they
        only rescale positive weights)."""
        if pool_size < 0:
            raise ValueError("pool_size must be >= 0")
        for d in demands:
            if d.weight <= 0:
                raise ValueError(f"job {d.name!r}: weight must be positive")
            if d.demand < 0:
                raise ValueError(f"job {d.name!r}: demand must be >= 0")
        caps = [min(d.demand, pool_size) for d in demands]
        eff = [self.effective_weight(d, credit) for d in demands]
        shares = weighted_max_min(pool_size, caps, [max(w, 1e-12) for w in eff])
        alloc = integerize_shares(shares, caps, pool_size, prefer=eff)

        # anti-starvation fixup: when the pool is large enough to give every
        # demanding job one node, integer rounding must not zero anyone out
        demanding = [i for i, d in enumerate(demands) if caps[i] > 0]
        if len(demanding) <= pool_size:
            for i in demanding:
                if alloc[i] == 0:
                    donor = max(demanding, key=lambda j: alloc[j])
                    if alloc[donor] > 1:
                        alloc[donor] -= 1
                        alloc[i] = 1
        return {d.name: alloc[i] for i, d in enumerate(demands)}
