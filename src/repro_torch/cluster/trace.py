"""Cluster traces: timed job arrival / departure / serve-burst events.

A trace is the external world as the orchestrator sees it — *what* shows up
and when; the *resize decisions* are made by the allocator, not the trace
(the single-job engines replay externally-scripted `ScaleEvent`s; here the
schedule is decided under contention).

Trace format (JSON, one object per event, sorted by `at`):

    {"at": 0.0,  "kind": "arrive", "job": "trainA"}
    {"at": 6.0,  "kind": "arrive", "job": "svc"}
    {"at": 9.0,  "kind": "burst",  "job": "svc",
     "n": 8, "rate": 0.0, "prompt_len": [6, 16],
     "max_new_tokens": [4, 8], "tenant": "burst", "seed": 1}
    {"at": 30.0, "kind": "depart", "job": "trainB"}

- `arrive`: the named (pre-registered) job joins the cluster and starts
  demanding nodes.
- `depart`: the job leaves (revocation; an elastic job's state is intact —
  chunk mobility means it could re-join later).
- `burst`: submit `n` extra requests to a serve job; `rate` <= 0 means an
  instantaneous burst at `at`, otherwise Poisson arrivals at `rate` req/s
  starting at `at`.  Optional fields default as in `ServeJob.make_requests`.
- `fail`: a FAULT, distinct from the graceful `depart`.  With a `node`
  payload it is an abrupt permanent node loss (zero grace — whatever job
  leased the node loses its in-flight state there and runs its recovery
  path); with only a `job` it is a zero-grace lease revocation (the job
  keeps its chunk/slot state — Chicle preemption — but holds no nodes
  until the allocator re-grants).
- `slow`: node `node` becomes a `factor`x straggler (factor 1.0 clears).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

KINDS = ("arrive", "depart", "burst", "fail", "slow")


@dataclasses.dataclass
class TraceEvent:
    at: float
    kind: str  # one of KINDS
    job: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown trace event kind {self.kind!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"at": self.at, "kind": self.kind, "job": self.job,
                **self.payload}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        d = dict(d)
        return cls(at=float(d.pop("at")), kind=str(d.pop("kind")),
                   job=str(d.pop("job")), payload=d)


class ClusterTrace:
    """Ordered event list with JSON round-trip and cursor-style consumption."""

    def __init__(self, events: Iterable[TraceEvent] = ()):
        self.events: List[TraceEvent] = sorted(events, key=lambda e: e.at)
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.events)

    def add(self, event: TraceEvent) -> "ClusterTrace":
        """Insert an event without disturbing already-consumed ones.  An
        event stamped earlier than the consumption point is placed at the
        cursor so it fires on the next `pop_due` instead of being replayed
        into (or lost behind) the consumed prefix."""
        idx = bisect.bisect_right([e.at for e in self.events], event.at)
        self.events.insert(max(idx, self._cursor), event)
        return self

    def pop_due(self, now: float) -> List[TraceEvent]:
        """Consume (in order) every event with at <= now."""
        due = []
        while self._cursor < len(self.events) \
                and self.events[self._cursor].at <= now:
            due.append(self.events[self._cursor])
            self._cursor += 1
        return due

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self.events)

    def last_event_time(self, job: str) -> float:
        times = [e.at for e in self.events if e.job == job]
        return max(times) if times else 0.0

    # --- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self.events], indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ClusterTrace":
        return cls(TraceEvent.from_dict(d) for d in json.loads(text))


# convenience constructors -------------------------------------------------


def arrive(at: float, job: str) -> TraceEvent:
    return TraceEvent(at, "arrive", job)


def depart(at: float, job: str) -> TraceEvent:
    return TraceEvent(at, "depart", job)


def burst(at: float, job: str, n: int, *, rate: float = 0.0,
          **payload: Any) -> TraceEvent:
    return TraceEvent(at, "burst", job, {"n": int(n), "rate": float(rate),
                                         **payload})


def fail(at: float, job: str = "", *, node: Optional[int] = None
         ) -> TraceEvent:
    """Node failure (`node=` given, `job` ignored for targeting — the pool
    knows the owner) or zero-grace lease revocation of `job` (no node)."""
    if node is None and not job:
        raise ValueError("fail event needs a node= or a job name")
    payload = {"node": int(node)} if node is not None else {}
    return TraceEvent(at, "fail", job, payload)


def slow(at: float, node: int, factor: float, *, job: str = "") -> TraceEvent:
    return TraceEvent(at, "slow", job, {"node": int(node),
                                        "factor": float(factor)})
