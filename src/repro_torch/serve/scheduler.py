"""Admission control + slot-chunk scheduling over an elastic worker pool.

Decode slots are grouped into SLOT-CHUNKS (the serving analogue of the
paper's data chunks) and `core.chunks.Assignment` maps slot-chunks onto
serving workers.  The scheduler obeys the exact ownership contract of the
training side: the assignment is mutated ONLY between iterations
(`Assignment._check` enforces it), and the unmodified `core.policies`
(elastic scaling, rebalancing, straggler mitigation) drive the worker pool
— `SlotScheduler` quacks like the `UniTaskEngine` they were written
against (assignment / store / rng / sim_time / on_worker_added hooks).
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.chunks import Assignment, ChunkStore
from ..core.fairshare import stride_pick
from ..core.policies import Policy
from ..obs import NULL_TRACER, Tracer
from .overload import AdmissionController
from .request import Request, RequestState
from .slots import SlotPool


class SlotScheduler:
    """Owns the per-tenant pending queues, the slot pool, and the slot-chunk
    assignment.  Admission is weighted round-robin across tenants (stride
    scheduling on admitted-count/weight, the same weight semantics as the
    cluster allocator's `JobDemand.weight`); within a tenant it is FCFS by
    arrival.  A single tenant degrades to the original global FCFS."""

    def __init__(self, capacity: int, *, n_workers: int = 1,
                 slots_per_chunk: int = 2,
                 policies: Sequence[Policy] = (),
                 max_admit_per_tick: int = 4,
                 seed: int = 0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 on_worker_added: Optional[Callable[[int], None]] = None,
                 on_worker_removed: Optional[Callable[[int], None]] = None,
                 admission: Optional[AdmissionController] = None,
                 tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # overload control: token buckets + bounded queue; None = unlimited
        # (the default, bit-identical to the pre-overload scheduler).  Only
        # `try_submit` consults it — internal re-queues (park, crash retry)
        # go through `submit` and are never re-charged or re-capped.
        self.admission = admission
        self.pool = SlotPool(capacity)
        # slot ids ARE the chunk store's samples: chunk c owns slots
        # [c*spc, (c+1)*spc) and moves between workers as one unit.
        self.store = ChunkStore({"slot": np.arange(capacity)},
                                chunk_size=slots_per_chunk)
        self.rng = np.random.default_rng(seed)
        self.assignment = Assignment(self.store.n_chunks, n_workers,
                                     np.random.default_rng(seed))
        self.policies = list(policies)
        self.max_admit_per_tick = max_admit_per_tick
        # optional ceiling on concurrently ACTIVE slots (cluster lease caps:
        # a shrunken lease parks slots and this stops admission from
        # immediately restoring them past what the lease can serve)
        self.active_cap: Optional[int] = None
        self.sim_time = 0.0  # tick index; policies key scale events on it
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        self._queues: Dict[str, List[Request]] = {}  # tenant -> FCFS queue
        self._admitted: Dict[str, float] = {}  # tenant -> admitted count
        self._hook_added = on_worker_added or (lambda w: None)
        self._hook_removed = on_worker_removed or (lambda w: None)

    # --- UniTaskEngine facade for core.policies ---------------------------
    def on_worker_added(self, w: int) -> None:
        self._hook_added(w)

    def on_worker_removed(self, w: int) -> None:
        self._hook_removed(w)

    # --- queries ----------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return self.assignment.n_workers

    def worker_of_slot(self, slot: int) -> int:
        cid = slot // self.store.chunk_size
        for w in range(self.assignment.n_workers):
            if cid in self.assignment.chunks_of(w):
                return w
        raise KeyError(f"chunk {cid} unassigned")

    def slots_of_worker(self, w: int) -> List[int]:
        spc = self.store.chunk_size
        out: List[int] = []
        for cid in self.assignment.chunks_of(w):
            out.extend(s for s in range(cid * spc,
                                        min((cid + 1) * spc,
                                            self.pool.capacity)))
        return out

    def active_per_worker(self) -> np.ndarray:
        """Active decode slots per worker (the serving load vector)."""
        mask = self.pool.active_mask()
        return np.array([int(mask[self.slots_of_worker(w)].sum())
                         for w in range(self.n_workers)])

    # --- scheduler phase (between iterations only) ------------------------
    @property
    def pending(self) -> List[Request]:
        """All queued requests, merged across tenants, sorted by arrival."""
        merged = [r for q in self._queues.values() for r in q]
        merged.sort(key=lambda r: r.arrival_time)
        return merged

    @property
    def has_pending(self) -> bool:
        """O(#tenants) emptiness check (the `pending` merge is O(N log N))."""
        return any(self._queues.values())

    def next_arrival(self) -> Optional[float]:
        """Earliest queued arrival time, min over per-tenant heads."""
        heads = [q[0].arrival_time for q in self._queues.values() if q]
        return min(heads) if heads else None

    def pending_of(self, tenant: str) -> List[Request]:
        return list(self._queues.get(tenant, []))

    def n_arrived(self, now: float) -> int:
        """Queued requests whose arrival time has passed (demand signal)."""
        return sum(1 for q in self._queues.values()
                   for r in q if r.arrival_time <= now)

    def queue_len(self) -> int:
        """Total queued requests across tenants (bounded-queue signal)."""
        return sum(len(q) for q in self._queues.values())

    def _vtime(self, tenant: str) -> float:
        return (self._admitted.get(tenant, 0.0)
                / self.tenant_weights.get(tenant, 1.0))

    def submit(self, req: Request) -> None:
        q = self._queues.setdefault(req.tenant, [])
        if not q:
            # (re)joining the backlog: floor the tenant's virtual time at
            # the least-served backlogged tenant so a newcomer competes for
            # its fair share going FORWARD rather than monopolizing
            # admissions until its historical count catches up
            vts = [self._vtime(t) for t, qq in self._queues.items() if qq]
            if vts:
                w = self.tenant_weights.get(req.tenant, 1.0)
                self._admitted[req.tenant] = max(
                    self._admitted.get(req.tenant, 0.0), min(vts) * w)
        # sorted insertion keeps FCFS-by-arrival within each tenant queue
        bisect.insort(q, req, key=lambda r: r.arrival_time)

    def try_submit(self, req: Request, now: Optional[float] = None):
        """Admission-controlled submit for FRESH arrivals.

        Returns ``(True, None)`` when the request was queued, or
        ``(False, Rejection)`` when the token bucket or the bounded
        queue refused it (the caller marks it REJECTED and stamps the
        retry-after hint).  The bucket clock is the request's arrival
        time by default, so replayed traces admit identically no matter
        when they are submitted.
        """
        if self.admission is not None and self.admission.enabled:
            t = req.arrival_time if now is None else now
            verdict = self.admission.check(req.tenant, t, self.queue_len())
            if verdict is not None:
                return False, verdict
        self.submit(req)
        return True, None

    def pop_older_than(self, now: float, age: float, *,
                       pred: Optional[Callable[[Request], bool]] = None
                       ) -> List[Request]:
        """Pop queued requests that have waited longer than `age` seconds
        (and match `pred`, when given).  The brownout ladder's top level
        uses this to shed work that can no longer meet its TTFT target;
        the engine marks the returned requests EXPIRED."""
        out: List[Request] = []
        for tenant in list(self._queues):
            keep: List[Request] = []
            for r in self._queues[tenant]:
                if now - r.arrival_time > age and (pred is None or pred(r)):
                    out.append(r)
                else:
                    keep.append(r)
            if keep:
                self._queues[tenant] = keep
            else:
                del self._queues[tenant]
        return out

    def admit(self, now: float, *,
              preempt: Optional[Callable[[Request], bool]] = None,
              limit: Optional[int] = None,
              allow: Optional[Callable[[Request], bool]] = None
              ) -> List[Request]:
        """Admit arrived requests into free slots: weighted round-robin over
        tenants with an arrived head-of-line request (stride pick on
        admitted/weight, exact ties broken by the earliest waiting head so
        equal-weight tenants stay FCFS-fair), FCFS within a tenant, bounded
        by free slots and `max_admit_per_tick`.

        preempt: optional engine hook enabling PRIORITY admission when the
        pool is full — called with the highest-priority waiting head; if it
        parks a strictly lower-priority in-flight slot (returning True) the
        freed slot admits that head this tick instead of queueing it.

        limit: optional per-call cap below `max_admit_per_tick` (the
        circuit breaker's half-open probe budget).  allow: optional
        admissibility filter — the open breaker passes only recovery
        traffic; matching requests BYPASS non-matching ones queued ahead
        of them (a retrying victim must not be head-of-line blocked by
        the paused fresh traffic the breaker is protecting it from)."""
        admitted: List[Request] = []
        budget = self.max_admit_per_tick if limit is None \
            else min(limit, self.max_admit_per_tick)
        while len(admitted) < budget:
            # per-tenant index of the first admissible request: the head
            # normally, or the first `allow` match (recovery bypass)
            heads: Dict[str, int] = {}
            for t, q in self._queues.items():
                for i, r in enumerate(q):
                    if r.arrival_time > now:
                        break  # sorted by arrival: nothing later has come
                    if allow is None or allow(r):
                        heads[t] = i
                        break
            eligible = list(heads)
            if not eligible:
                break
            room = self.pool.n_free and (self.active_cap is None
                                         or self.pool.n_used < self.active_cap)
            if room:
                tenant = stride_pick(
                    self._admitted, self.tenant_weights, eligible,
                    tiebreak=lambda t: self._queues[t][heads[t]].arrival_time)
                req = self._queues[tenant].pop(heads[tenant])
            else:
                if preempt is None:
                    break
                # full pool (or lease cap reached): only the highest-
                # priority waiting head may force its way in by evicting
                # (parking) a running victim
                tenant = max(
                    eligible,
                    key=lambda t: (self._queues[t][heads[t]].priority,
                                   -self._queues[t][heads[t]].arrival_time))
                req = self._queues[tenant][heads[tenant]]
                if not preempt(req):
                    break  # no strictly lower-priority victim to park
                # remove by IDENTITY: parking re-queued the victim, and in a
                # shared tenant its older arrival sorts AHEAD of this head —
                # pop(0) here would re-admit the victim we just parked
                q = self._queues[tenant]
                q.pop(next(i for i, r in enumerate(q) if r is req))
                self.tracer.count("serve.preempt_admits")
            if not self._queues[tenant]:
                del self._queues[tenant]
            self._admitted[tenant] = self._admitted.get(tenant, 0.0) + 1.0
            req.slot = self.pool.alloc(req.rid)
            req.state = RequestState.PREFILL
            if req.t_admitted is None:  # parked re-admissions keep the first
                req.t_admitted = now
            if req.t_parked is not None:
                # time spent parked / in a handoff queue is accounted apart
                # from the arrival->first-admission queue delay
                req.handoff_delay += max(now - req.t_parked, 0.0)
                req.t_parked = None
            admitted.append(req)
        return admitted

    def shed_expired(self, now: float) -> List[Request]:
        """Pop queued requests whose deadline has passed (deadline-based
        load shedding happens at admission, so in-flight decodes are never
        killed).  The engine marks the returned requests EXPIRED."""
        out: List[Request] = []
        for tenant in list(self._queues):
            keep: List[Request] = []
            for r in self._queues[tenant]:
                if r.deadline is not None \
                        and now - r.arrival_time > r.deadline:
                    out.append(r)
                else:
                    keep.append(r)
            if keep:
                self._queues[tenant] = keep
            else:
                del self._queues[tenant]
        return out

    def release(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.t_finished = now
        if req.slot is not None:
            self.pool.free(req.slot)
            req.slot = None

    def between_ticks(self, stats: Dict) -> None:
        """Run the attached policies (scheduler phase; may resize/rebalance
        the slot-chunk assignment through the ownership-checked mutators).
        Per-policy spans nest inside the engine's ``schedule`` span on the
        same track — detail rows in the trace viewer, no double-counting in
        the attribution report (it sums outermost spans per track)."""
        for p in self.policies:
            with self.tracer.span("schedule.policy", track="schedule",
                                  policy=type(p).__name__):
                p.between_iterations(self, stats)

    def set_workers(self, k: int) -> None:
        """Explicit elastic resize of the logical worker pool."""
        a = self.assignment
        while a.n_workers < k:
            w = a.add_worker()
            self.on_worker_added(w)
        while a.n_workers > k:
            w = a.n_workers - 1
            self.on_worker_removed(w)
            a.remove_worker(w, self.rng)
        a.rebalance_even(self.rng)

    # --- iteration phase delegation ---------------------------------------
    def begin_iteration(self) -> None:
        self.assignment.begin_iteration()

    def end_iteration(self) -> None:
        self.assignment.end_iteration()
        self.sim_time += 1.0
