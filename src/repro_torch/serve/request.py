"""Request/sequence lifecycle + open-loop arrival traces.

A `Request` moves QUEUED -> PREFILL -> DECODING -> FINISHED.  Arrivals are
open-loop (the workload does not wait for completions): a Poisson process,
an explicit trace of arrival offsets, or a burst (all at t=0).  Per-request
timestamps feed the engine's TTFT / per-token latency metrics.

Two fault-path states branch off the happy path: a request whose KV died
with a crashed worker goes RETRYING (its stream resets and it re-queues
after an exponential backoff, up to `max_retries`), and a request that
blows its retry budget or its `deadline` goes EXPIRED — a terminal
load-shed state distinct from FINISHED.

Overload control adds a third terminal branch *before* the queue: a
request refused by token-bucket admission or a full bounded queue goes
REJECTED with a `retry_after` hint (explicit backpressure).  Rejections
are counted separately from EXPIRED sheds — a shed wasted queue/compute
time, a rejection by design did not.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODING = "decoding"
    PARKED = "parked"  # preempted mid-decode; KV parked host-side
    RETRYING = "retrying"  # lost to a worker crash; backing off to re-queue
    FINISHED = "finished"
    EXPIRED = "expired"  # shed: retry budget or deadline exhausted (terminal)
    REJECTED = "rejected"  # refused at admission (backpressure; terminal)


@dataclasses.dataclass
class Request:
    """One serving request and its measured lifecycle."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    arrival_time: float = 0.0  # seconds from workload start (open loop)
    tenant: str = "default"  # admission queue key (per-tenant fair sharing)
    priority: int = 0  # higher may preempt (park) lower in-flight decodes
    # fault tolerance: deadline is seconds-from-start past which a still-
    # unfinished request is shed (None = no deadline); max_retries bounds
    # crash re-executions before the request is shed instead
    deadline: Optional[float] = None
    max_retries: int = 3
    retries: int = 0
    # overload control: per-request SLO targets (None = engine defaults);
    # retry_after is stamped on REJECTED requests as a client backoff hint
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None
    retry_after: Optional[float] = None

    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    # measured timestamps (seconds from engine start)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    # park/handoff bookkeeping: t_parked is set while the request's KV sits
    # host-side (eviction park or disagg handoff queue); handoff_delay
    # accumulates park->re-admission waits, reported separately from the
    # arrival->first-admission queue delay
    t_parked: Optional[float] = None
    handoff_delay: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def done(self) -> bool:
        return self.n_generated >= self.max_new_tokens

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.t_finished is None or self.t_first_token is None \
                or self.n_generated < 2:
            return None
        return (self.t_finished - self.t_first_token) / (self.n_generated - 1)


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rate: float,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """n arrival offsets (seconds) of a Poisson process with `rate` req/s.
    rate <= 0 means an instantaneous burst (all arrive at t=0)."""
    if rate <= 0:
        return np.zeros(n)
    rng = rng or np.random.default_rng(0)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def trace_arrivals(offsets: Sequence[float]) -> np.ndarray:
    """Explicit arrival-offset trace (replayed verbatim, sorted)."""
    return np.sort(np.asarray(list(offsets), dtype=float))


def synthetic_requests(n: int, *, vocab_size: int, arrivals: np.ndarray,
                       prompt_len: tuple = (8, 32),
                       max_new_tokens: tuple = (4, 16),
                       rng: Optional[np.random.Generator] = None,
                       tenant: str = "default",
                       priority: int = 0,
                       shared_prefix: Optional[Sequence[int]] = None,
                       rid_base: int = 0) -> List[Request]:
    """Random-token requests with lengths drawn uniformly from the given
    inclusive ranges, stamped with the supplied arrival offsets.

    shared_prefix: optional common token header prepended to every prompt
    (few-shot / system-prompt workloads — the prefix-sharing fast path);
    prompt_len then sizes only the unique suffix."""
    rng = rng or np.random.default_rng(0)
    assert len(arrivals) == n
    head = (np.asarray(list(shared_prefix), np.int32)
            if shared_prefix is not None else np.zeros(0, np.int32))
    reqs = []
    for i in range(n):
        lp = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mn = int(rng.integers(max_new_tokens[0], max_new_tokens[1] + 1))
        prompt = rng.integers(0, vocab_size, size=lp).astype(np.int32)
        prompt = np.concatenate([head, prompt]) if len(head) else prompt
        reqs.append(Request(rid=rid_base + i, prompt=prompt,
                            max_new_tokens=mn, tenant=tenant,
                            priority=priority,
                            arrival_time=float(arrivals[i])))
    return reqs
