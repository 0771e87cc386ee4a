"""Weighted fair-sharing primitives shared by the cluster allocator and the
serving admission scheduler.

These are the textbook building blocks (progressive-filling max-min,
largest-remainder integerization, stride/WRR picking, Jain's index) kept
dependency-free so both `repro.cluster.allocator` (nodes -> jobs) and
`repro.serve.scheduler` (slots -> tenants) can share one weight semantics:
a positive float weight per principal, share proportional to weight, capped
by demand, work-conserving.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np

_EPS = 1e-9


def weighted_max_min(capacity: float, demands: Sequence[float],
                     weights: Sequence[float]) -> List[float]:
    """Weighted max-min fair shares via progressive filling.

    Each principal i receives at most demands[i]; unsatisfied principals
    split the remaining capacity proportionally to weights[i].  The result
    is work-conserving: sum(shares) == min(capacity, sum(demands)).
    """
    n = len(demands)
    assert len(weights) == n
    if any(w <= 0 for w in weights):
        raise ValueError("weights must be positive")
    alloc = [0.0] * n
    active = {i for i in range(n) if demands[i] > _EPS}
    remaining = float(capacity)
    while active and remaining > _EPS:
        wsum = sum(weights[i] for i in active)
        inc = {i: remaining * weights[i] / wsum for i in active}
        capped = [i for i in active if alloc[i] + inc[i] >= demands[i] - _EPS]
        if capped:
            for i in capped:
                remaining -= demands[i] - alloc[i]
                alloc[i] = float(demands[i])
                active.remove(i)
        else:
            for i in active:
                alloc[i] += inc[i]
            remaining = 0.0
    return alloc


def integerize_shares(shares: Sequence[float], demands: Sequence[int],
                      capacity: int,
                      prefer: Optional[Sequence[float]] = None) -> List[int]:
    """Largest-remainder rounding of fractional shares to integers.

    Keeps sum(out) == min(capacity, sum(demands)) and out[i] <= demands[i].
    `prefer` breaks remainder ties (higher value wins the spare unit).
    """
    n = len(shares)
    target = min(int(capacity), int(sum(demands)))
    out = [min(int(s), int(demands[i])) for i, s in enumerate(shares)]
    rem = [(shares[i] - int(shares[i]),
            prefer[i] if prefer is not None else 0.0, i) for i in range(n)]
    rem.sort(key=lambda t: (-t[0], -t[1], t[2]))
    deficit = target - sum(out)
    # hand out spare whole units by largest fractional remainder first,
    # skipping principals already at their demand cap
    k = 0
    while deficit > 0 and k < 4 * n + 4:
        progressed = False
        for _, _, i in rem:
            if deficit <= 0:
                break
            if out[i] < demands[i]:
                out[i] += 1
                deficit -= 1
                progressed = True
        if not progressed:
            break
        k += 1
    return out


def stride_pick(served: Dict[Hashable, float],
                weights: Dict[Hashable, float],
                eligible: Sequence[Hashable],
                tiebreak=None) -> Hashable:
    """Weighted round-robin pick: the eligible principal with the smallest
    virtual time served/weight goes next (stride scheduling).  `tiebreak`
    optionally maps a principal to a secondary sort key for exact vtime
    ties (e.g. head-of-line arrival time, keeping equal-weight principals
    FCFS).  With one principal this degrades to plain FCFS at the caller."""
    if not eligible:
        raise ValueError("no eligible principals")

    def vtime(t):
        w = float(weights.get(t, 1.0))
        if w <= 0:
            raise ValueError(f"weight for {t!r} must be positive")
        return served.get(t, 0.0) / w

    return min(eligible, key=lambda t: (vtime(t),
                                        tiebreak(t) if tiebreak else 0,
                                        str(t)))


def jain_index(xs: Sequence[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly fair, 1/n = maximally unfair."""
    x = np.asarray(list(xs), float)
    if len(x) == 0 or float(np.sum(x * x)) <= _EPS:
        return 1.0
    return float(np.sum(x) ** 2 / (len(x) * np.sum(x * x)))
