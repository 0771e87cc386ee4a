"""Deterministic fault injection on the tick clock.

A `FaultPlan` is a seeded schedule of fault events — scripted
(`worker_crash(at=5)`) or probabilistic (`p_crash=0.02` per tick, drawn
from the plan's own `numpy` generator so the same seed always yields the
same fault sequence).  A `FaultInjector` owns one plan and is polled once
per engine/orchestrator tick: `poll(tick)` returns the events due at that
tick, emits a `fault.inject` trace instant + counter for each, and keeps
the injected log for post-run inspection.

The events themselves are interpretation-free: each layer routes the
kinds it understands (the port's serving engine takes the two worker
kinds, see `ServeEngine.apply_fault`; the disagg and cluster kinds wait
for those layers).  The module is numpy only and takes its tracer as an
argument.  Kinds:

- ``worker_crash``: abrupt zero-grace loss of a logical worker; every KV
  page / slot resident on it is gone.  `target` picks the worker id
  (default: the highest-id live worker); `payload["pool"]` routes to a
  disagg half ("prefill" / "decode").
- ``worker_slow``: straggler — worker `target` runs `factor`x slower
  until a later ``worker_slow`` with factor 1.0 clears it.
- ``revoke_lease``: allocator-level zero-grace preemption of job
  `target` (cluster scope only).
- ``handoff_drop``: the next disagg park/inject transfer is dropped in
  flight and must retry from the source pool's parked copy.

Determinism contract: with scripted events and/or a fixed seed, the
sequence of (tick, kind, target, factor) tuples an injector yields is a
pure function of the plan — two runs over the same tick range see
bit-identical fault sequences, which is what makes chaos A/B runs and
the seeded-determinism tests possible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

KINDS = ("worker_crash", "worker_slow", "revoke_lease", "handoff_drop")


@dataclass
class FaultEvent:
    """One fault at one tick.  `target` is kind-dependent: a worker id
    (int) for crash/slow, a job name (str) for revoke_lease, unused for
    handoff_drop."""
    at: int
    kind: str
    target: Optional[object] = None
    factor: float = 1.0
    payload: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.at < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.at}")
        if self.kind == "worker_slow" and self.factor <= 0:
            raise ValueError(f"slow factor must be > 0, got {self.factor}")

    def to_dict(self) -> Dict:
        return {"at": self.at, "kind": self.kind, "target": self.target,
                "factor": self.factor, **({"payload": self.payload}
                                          if self.payload else {})}


def worker_crash(at: int, worker: Optional[int] = None, *,
                 pool: Optional[str] = None) -> FaultEvent:
    payload = {"pool": pool} if pool else {}
    return FaultEvent(at, "worker_crash", worker, payload=payload)


def worker_slow(at: int, worker: int, factor: float) -> FaultEvent:
    return FaultEvent(at, "worker_slow", worker, factor=factor)


def crash_storm(at: int, n: int = 3, every: int = 2, *,
                worker: Optional[int] = None,
                pool: Optional[str] = None) -> List[FaultEvent]:
    """`n` worker crashes starting at `at`, one every `every` ticks — the
    scripted crash storm the circuit-breaker tests and benchmarks trip on.
    Each crash targets the same (or default highest-id) worker, so the
    replacement itself keeps dying: exactly the correlated-failure pattern
    a breaker exists to stop retry-amplifying."""
    if n < 1:
        raise ValueError(f"crash_storm needs n >= 1, got {n}")
    if every < 1:
        raise ValueError(f"crash_storm needs every >= 1, got {every}")
    return [worker_crash(at + i * every, worker, pool=pool)
            for i in range(n)]


def revoke_lease(at: int, job: str) -> FaultEvent:
    return FaultEvent(at, "revoke_lease", job)


def handoff_drop(at: int) -> FaultEvent:
    return FaultEvent(at, "handoff_drop")


class FaultPlan:
    """Scripted and/or probabilistic fault schedule.

    Probabilistic mode draws one uniform sample per kind per polled tick
    from a private generator, so the fault sequence is a deterministic
    function of (seed, ticks polled in order) — the injector polls every
    tick, which keeps replays aligned.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), *, seed: int = 0,
                 p_crash: float = 0.0, p_slow: float = 0.0,
                 slow_factor: float = 2.0, max_random: int = 2):
        for p, name in ((p_crash, "p_crash"), (p_slow, "p_slow")):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.events = sorted(events, key=lambda e: e.at)
        self.seed = seed
        self.p_crash = p_crash
        self.p_slow = p_slow
        self.slow_factor = slow_factor
        self.max_random = max_random
        self._rng = np.random.default_rng(seed)
        self._drawn = 0
        self._cursor = 0

    def due(self, tick: int) -> List[FaultEvent]:
        """Events due at `tick`.  Must be called with non-decreasing
        ticks (the injector's per-tick poll)."""
        out: List[FaultEvent] = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].at <= tick):
            out.append(self.events[self._cursor])
            self._cursor += 1
        if self.p_crash > 0 or self.p_slow > 0:
            crash_u, slow_u = self._rng.random(2)
            if self._drawn < self.max_random:
                if self.p_crash > 0 and crash_u < self.p_crash:
                    out.append(FaultEvent(tick, "worker_crash"))
                    self._drawn += 1
                elif self.p_slow > 0 and slow_u < self.p_slow:
                    out.append(FaultEvent(tick, "worker_slow", 0,
                                          factor=self.slow_factor))
                    self._drawn += 1
        return out

    @property
    def exhausted(self) -> bool:
        return (self._cursor >= len(self.events)
                and (self.p_crash == 0 and self.p_slow == 0
                     or self._drawn >= self.max_random))


class FaultInjector:
    """Polls a FaultPlan on the tick clock and logs what fired."""

    def __init__(self, plan: FaultPlan, *, tracer=None):
        self.plan = plan
        self.tracer = tracer
        self.injected: List[FaultEvent] = []

    def poll(self, tick: int) -> List[FaultEvent]:
        events = self.plan.due(tick)
        for ev in events:
            self.injected.append(ev)
            if self.tracer is not None:
                self.tracer.instant(
                    "fault.inject", track="faults",
                    args={"tick": tick, "kind": ev.kind,
                          "target": ev.target, "factor": ev.factor})
                self.tracer.count(f"fault.{ev.kind}", 1)
        return events

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.injected:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out


def parse_chaos(spec: str) -> FaultPlan:
    """CLI chaos spec -> FaultPlan.

    Comma-separated events: ``crash@t=5``, ``crash@t=5:w1``,
    ``crash@t=5:prefill`` (disagg pool routing), ``slow@t=3:w0:2.5``,
    ``revoke@t=4:jobname``, ``drop@t=6``; or probabilistic
    ``p_crash=0.05`` / ``p_slow=0.1`` / ``seed=7`` terms.

    Example: ``--chaos "crash@t=5,slow@t=3:w0:2.0,drop@t=8"``.
    """
    events: List[FaultEvent] = []
    kw = {"seed": 0, "p_crash": 0.0, "p_slow": 0.0}
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        if "=" in term and "@" not in term:
            key, val = term.split("=", 1)
            key = key.strip()
            if key not in kw:
                raise ValueError(f"unknown chaos parameter {key!r} in "
                                 f"{term!r} (expected seed/p_crash/p_slow)")
            kw[key] = int(val) if key == "seed" else float(val)
            continue
        try:
            head, at_part = term.split("@", 1)
            fields = at_part.split(":")
            at = int(fields[0].lstrip("t="))
            rest = fields[1:]
        except (ValueError, IndexError):
            raise ValueError(f"bad chaos term {term!r}; expected e.g. "
                             f"'crash@t=5', 'slow@t=3:w0:2.0', "
                             f"'revoke@t=4:job', 'drop@t=6'")
        head = head.strip()
        if head == "crash":
            worker, pool = None, None
            if rest:
                if rest[0] in ("prefill", "decode"):
                    pool = rest[0]
                else:
                    worker = int(rest[0].lstrip("w"))
                if len(rest) > 1 and rest[1] in ("prefill", "decode"):
                    pool = rest[1]
            events.append(worker_crash(at, worker, pool=pool))
        elif head == "slow":
            if len(rest) < 2:
                raise ValueError(f"slow needs worker and factor: {term!r}")
            events.append(worker_slow(at, int(rest[0].lstrip("w")),
                                      float(rest[1])))
        elif head == "revoke":
            if not rest:
                raise ValueError(f"revoke needs a job name: {term!r}")
            events.append(revoke_lease(at, rest[0]))
        elif head == "drop":
            events.append(handoff_drop(at))
        else:
            raise ValueError(f"unknown chaos event {head!r} in {term!r}")
    return FaultPlan(events, **kw)
