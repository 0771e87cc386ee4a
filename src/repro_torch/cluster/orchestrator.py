"""Discrete-event cluster orchestrator: the resource-manager half of the
paper's YARN interface, co-scheduling elastic training and serving jobs.

Tick loop (fixed step `dt` of simulated seconds):

  1. apply due trace events (job arrivals/departures, serve bursts),
  2. collect per-job demands and run the weighted fair-share allocator,
  3. convert the decision into concrete node leases (minimal churn) and
     push resizes through each job's existing elastic path — shrinking a
     job that still has demand is counted as a *preemption* (cheap under
     Chicle: chunk/slot state just stops moving forward, nothing restarts),
  4. advance every leased job by `dt`, accumulating per-job node-time,
     presence-time, and queueing metrics.

The report carries the cluster-level quantities the benchmarks track:
makespan, aggregate utilization (leased node-time / pool node-time),
Jain fairness over weight-normalized service rates, preemption and
migration counts, plus per-job summaries and the full allocation timeline.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

from ..core.fairshare import jain_index
from ..obs import NULL_TRACER, Tracer
from .allocator import FairShareAllocator, JobDemand, UsageLedger
from .jobs import ClusterJob, JobState, ServeJob
from .pool import DevicePool
from .trace import ClusterTrace


@dataclasses.dataclass
class TickStats:
    t: float
    demand: Dict[str, int]
    alloc: Dict[str, int]
    nodes_used: int


@dataclasses.dataclass
class ClusterReport:
    makespan: float
    utilization: float
    fairness_jain: float
    preemptions: int
    migrations: int
    ticks: int
    jobs: Dict[str, Dict[str, Any]]
    timeline: List[TickStats]
    # KV bytes moved host<->device by serve-job preemptions (lease-shrink
    # AND priority-admission parks, plus their restores) — the cluster-level
    # cost of page-granular eviction, O(moved pages)
    kv_moved_bytes: int = 0
    # fault/recovery totals (summed over job summaries): node losses seen
    # by the pool, recovery events the jobs ran, serve-side crash retries
    # and deadline sheds, and total ticks of re-done work
    node_failures: int = 0
    recoveries: int = 0
    retries: int = 0
    shed_requests: int = 0
    recovery_ticks: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)  # deep-converts TickStats too


class ClusterOrchestrator:
    """Owns the device pool, the trace, and the job set."""

    def __init__(self, pool: DevicePool, jobs: Sequence[ClusterJob],
                 trace: ClusterTrace, *,
                 allocator: Optional[FairShareAllocator] = None,
                 usage_half_life: Optional[float] = None,
                 dt: float = 1.0, max_ticks: int = 10_000,
                 tracer: Optional[Tracer] = None,
                 trace_out: Optional[str] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # per-tick stats stream: one JSON line per TickStats, flushed as
        # written so a long run can be tailed / survives a crash
        self.trace_out = trace_out
        self._trace_fh = None
        self.pool = pool
        self.trace = trace
        self.jobs: Dict[str, ClusterJob] = {}
        for j in jobs:
            if j.spec.name in self.jobs:
                raise ValueError(f"duplicate job name {j.spec.name!r}")
            self.jobs[j.spec.name] = j
        for ev in trace.events:
            if ev.kind in ("fail", "slow") and not ev.job:
                continue  # node-scoped fault: no job to validate
            if ev.job not in self.jobs:
                raise ValueError(f"trace references unknown job {ev.job!r}")
        self.allocator = allocator or FairShareAllocator()
        # allocator lookahead: decayed usage accounting so bursty jobs repay
        # credit over subsequent ticks (None = memoryless, the default)
        self.ledger = (UsageLedger(usage_half_life)
                       if usage_half_life is not None else None)
        self.dt = float(dt)
        self.max_ticks = max_ticks
        self.now = 0.0
        self.timeline: List[TickStats] = []
        self._prev_alloc: Dict[str, int] = {}

    # --- context manager: `with ClusterOrchestrator(...) as orch` closes
    # the --trace-out stream even when the run raises mid-tick ------------
    def __enter__(self) -> "ClusterOrchestrator":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close_trace()
        return False

    # --- event application ------------------------------------------------
    def _apply_fault(self, ev) -> None:
        trc = self.tracer
        node = ev.payload.get("node")
        if node is None:
            # zero-grace lease revocation: the job keeps its chunk/slot
            # state (Chicle preemption) but holds no nodes until the
            # allocator re-grants on a later tick
            job = self.jobs[ev.job]
            job.preemptions += 1
            self.pool.release_all(ev.job)
            job.on_allocation([], [], self.now)
            trc.instant("fault.inject", track="faults",
                        args={"t": self.now, "kind": "revoke_lease",
                              "job": ev.job})
            trc.count("fault.revoke_lease")
            trc.count("cluster.preemptions")
            return
        owner = self.pool.fail_node(int(node))
        trc.instant("fault.inject", track="faults",
                    args={"t": self.now, "kind": "worker_crash",
                          "node": int(node), "owner": owner})
        trc.count("fault.worker_crash")
        if owner is None:
            return  # free (or already-dead) node: nobody to recover
        job = self.jobs[owner]
        with trc.span("recovery.crash", track="faults", job=owner,
                      node=int(node)):
            job.on_node_failure(self.now)
        # the dead node is out of the lease NOW; hand the job its shrunken
        # live view rather than letting it run a tick on a ghost node
        nodes = self.pool.nodes_of(owner)
        job.on_allocation(nodes, self.pool.psts_of(nodes), self.now)

    def _apply_events(self) -> None:
        for ev in self.trace.pop_due(self.now):
            if ev.kind == "fail":
                self._apply_fault(ev)
                continue
            if ev.kind == "slow":
                node = int(ev.payload["node"])
                factor = float(ev.payload.get("factor", 2.0))
                self.pool.slow_node(node, factor)
                self.tracer.instant("fault.inject", track="faults",
                                    args={"t": self.now, "kind":
                                          "worker_slow", "node": node,
                                          "factor": factor})
                self.tracer.count("fault.worker_slow")
                continue
            job = self.jobs[ev.job]
            if ev.kind == "arrive":
                job.arrive(self.now)
            elif ev.kind == "depart":
                job.depart(self.now)
                self.pool.release_all(ev.job)
            elif ev.kind == "burst":
                if not isinstance(job, ServeJob):
                    raise ValueError(
                        f"burst event targets non-serve job {ev.job!r}")
                payload = dict(ev.payload)
                n = int(payload.pop("n"))
                rate = float(payload.pop("rate", 0.0))
                job.submit_requests(
                    job.make_requests(ev.at, n, rate=rate, **payload))

    # --- one tick ---------------------------------------------------------
    def step(self) -> TickStats:
        self._apply_events()
        active = [j for j in self.jobs.values() if j.active]
        for j in active:
            if isinstance(j, ServeJob):
                j.no_more_arrivals = (
                    self.now >= self.trace.last_event_time(j.spec.name))

        trc = self.tracer
        demands = {j.spec.name: j.demand(self.now) for j in active}
        # priority-desc order so the pool grants fast free nodes to the
        # most entitled jobs first
        ordered = sorted(
            active, key=lambda j: (-j.spec.priority, -j.spec.weight,
                                   j.spec.name))
        migrations0 = self.pool.migrations
        with trc.span("allocator.decide", t=self.now,
                      demand=sum(demands.values())):
            # serving jobs report rolling SLO attainment; the allocator
            # boosts a job missing its targets (slo_boost), which closes
            # the loop between brownout pressure and cluster capacity
            jds = [JobDemand(j.spec.name, demands[j.spec.name],
                             j.spec.weight, j.spec.priority,
                             attainment=j.slo_attainment())
                   for j in ordered]
            alloc = self.allocator.allocate(
                self.pool.n_alive, jds,  # dead nodes never re-lease
                credit=self.ledger.snapshot() if self.ledger else None)
            if self.ledger is not None:
                self.ledger.update(alloc, jds, self.dt)
            leases = self.pool.reassign(
                {j.spec.name: alloc.get(j.spec.name, 0) for j in ordered})

        for j in ordered:
            name = j.spec.name
            a = alloc.get(name, 0)
            prev = self._prev_alloc.get(name, 0)
            if a != prev:
                j.resizes += 1
                trc.instant("lease_change", track=name, prev=prev, alloc=a)
            if a < prev and demands[name] > a:
                j.preemptions += 1
                trc.instant("preemption", track=name, prev=prev, alloc=a)
                trc.count("cluster.preemptions")
            j.on_allocation(leases.get(name, []),
                            self.pool.psts_of(leases.get(name, [])), self.now)

        for j in ordered:
            name = j.spec.name
            kv0 = getattr(j, "kv_moved_bytes", 0)
            with trc.span("advance", track=name, nodes=alloc.get(name, 0)):
                j.advance(self.dt, self.now)
            moved = getattr(j, "kv_moved_bytes", 0) - kv0
            if moved:
                # page-granular preemption cost, per job per tick
                trc.instant("kv_moved", track=name, bytes=moved)
                trc.count("cluster.kv_moved_bytes", moved)
            j.node_time += alloc.get(name, 0) * self.dt
            if demands[name] > 0:
                j.presence_time += self.dt
            if isinstance(j, ServeJob):
                j.maybe_finish(self.now + self.dt)

        rec = TickStats(t=self.now, demand=demands,
                        alloc={n: a for n, a in alloc.items() if a},
                        nodes_used=sum(alloc.values()))
        self.timeline.append(rec)
        if trc.enabled:
            trc.count("cluster.ticks")
            trc.count("cluster.migrations",
                      self.pool.migrations - migrations0)
            trc.gauge("cluster.nodes_used", rec.nodes_used)
            trc.observe("cluster.demand", sum(demands.values()))
        if self.trace_out is not None:
            if self._trace_fh is None:
                self._trace_fh = open(self.trace_out, "w")
            self._trace_fh.write(
                json.dumps(dataclasses.asdict(rec)) + "\n")
            self._trace_fh.flush()
        self._prev_alloc = alloc
        self.now += self.dt
        return rec

    # --- drive to completion ----------------------------------------------
    def _work_remains(self) -> bool:
        if not self.trace.exhausted:
            return True
        return any(j.active for j in self.jobs.values())

    def run(self) -> ClusterReport:
        while self._work_remains() and len(self.timeline) < self.max_ticks:
            self.step()
        self.close_trace()
        return self.report()

    def close_trace(self) -> None:
        """Flush and close the --trace-out JSONL stream (idempotent)."""
        if self._trace_fh is not None:
            self._trace_fh.close()
            self._trace_fh = None

    def report(self) -> ClusterReport:
        finish_times = [j.finish_time for j in self.jobs.values()
                        if j.finish_time is not None]
        makespan = max(finish_times) if finish_times else self.now
        span_ticks = [t for t in self.timeline if t.t < makespan]
        used = sum(t.nodes_used for t in span_ticks)
        total = self.pool.n_nodes * len(span_ticks)
        rates = [j.node_time / (j.spec.weight * j.presence_time)
                 for j in self.jobs.values() if j.presence_time > 0]
        # re-back the report's headline quantities onto the registry so
        # they export alongside the serve metrics (report shape unchanged)
        trc = self.tracer
        if trc.enabled:
            trc.gauge("cluster.makespan", makespan)
            trc.gauge("cluster.utilization",
                      used / total if total else 0.0)
            trc.gauge("cluster.fairness_jain", jain_index(rates))
        jobs_sum = {n: j.summary() for n, j in self.jobs.items()}
        return ClusterReport(
            makespan=makespan,
            utilization=used / total if total else 0.0,
            fairness_jain=jain_index(rates),
            preemptions=sum(j.preemptions for j in self.jobs.values()),
            migrations=self.pool.migrations,
            ticks=len(self.timeline),
            jobs=jobs_sum,
            timeline=self.timeline,
            kv_moved_bytes=sum(getattr(j, "kv_moved_bytes", 0)
                               for j in self.jobs.values()),
            node_failures=self.pool.failures,
            recoveries=sum(int(d.get("recoveries") or 0)
                           for d in jobs_sum.values()),
            retries=sum(int(d.get("retries") or 0)
                        for d in jobs_sum.values()),
            shed_requests=sum(int(d.get("shed_requests") or 0)
                              for d in jobs_sum.values()),
            recovery_ticks=sum(float(d.get("recovery_ticks") or 0.0)
                               for d in jobs_sum.values()),
        )
