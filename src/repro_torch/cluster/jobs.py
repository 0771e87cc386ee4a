"""Cluster jobs: elastic training and serving workloads under orchestration.

Both job kinds consume the orchestrator's allocation decisions through the
repo's *existing* elastic paths — that is the Chicle property the cluster
showcases (chunk/slot mobility makes preemption cheap, so a resize is just
a scheduler-phase decision, never a restart):

- `TrainJob` (mode="microtask", default): wraps `core.engine.
  MicroTaskEmulator` — the algorithm runs at FIXED logical data parallelism
  `k_tasks`, and the allocation only changes how those tasks waterfill onto
  the currently-leased nodes (the paper's §5.3 projection).  Convergence
  per epoch is therefore *bit-identical* to a solo run no matter how the
  cluster squeezes the job — elasticity is algorithmically free.
- `TrainJob` (mode="unitask"): wraps `core.engine.UniTaskEngine` with an
  `ElasticScalingPolicy` driven by a callable schedule that reads the
  current allocation — the worker count tracks the lease (K = nodes), which
  closes the loop between the policy and a real resource manager.  Chunk
  state still moves with the data, but per-epoch convergence now depends
  on K (documented paper trade-off).
- `LMTrainJob`: wraps `launch.elastic.ElasticTrainer` — every step is a
  REAL LM train step on the device; scale-to-zero parks params/optimizer
  state on host via the trainer's suspend/resume hooks, bit-exactly.
- `ServeJob`: wraps `serve.ServeEngine` with an injected simulation clock;
  allocation maps to `resize(k)` and 0 nodes maps to the engine's
  suspend/resume (scale-to-zero) hooks.  Modeled throughput scales
  linearly: a lease of n nodes runs `n * ticks_per_dt` engine ticks per
  simulated second.
- `DisaggServeJob`: wraps `serve.DisaggEngine` — the allocator sizes the
  prefill + decode pools as one job and the engine's split policy divides
  the lease internally; the page-granular handoff bytes land in the same
  `kv_moved_bytes` ledger as preemption parks.

Every job that builds an engine, solver or trainer takes `device=`
(default "cuda") and hands it on; without a card they raise unless the
caller passes device="cpu".  The pool's nodes are simulated: all of a
job's work runs on its one device, whatever nodes it leases.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from ..core.chunks import Assignment, ChunkStore
from ..core.cocoa import CoCoASolver
from ..core.engine import IterationRecord, MicroTaskEmulator, UniTaskEngine
from ..core.policies import ElasticScalingPolicy
from ..data.synthetic import make_svm_data
from ..serve.disagg import DisaggEngine, SplitPolicy
from ..serve.engine import ServeEngine
from ..serve.request import Request, poisson_arrivals, synthetic_requests


class JobState(enum.Enum):
    PENDING = "pending"      # registered, not yet arrived
    RUNNING = "running"      # arrived, leased > 0 nodes
    SUSPENDED = "suspended"  # arrived, currently squeezed to 0 nodes
    FINISHED = "finished"    # workload complete
    DEPARTED = "departed"    # revoked by a trace `depart` event


@dataclasses.dataclass
class JobSpec:
    """Scheduling contract between a job and the allocator."""

    name: str
    kind: str  # "train" | "serve"
    weight: float = 1.0
    priority: int = 0
    min_nodes: int = 0  # floor while the job has work (0 = fully elastic)
    max_nodes: int = 8  # demand cap (train: <= k_tasks is useful)


class ClusterJob:
    """Base class: lease bookkeeping + lifecycle shared by both kinds."""

    def __init__(self, spec: JobSpec):
        self.spec = spec
        self.state = JobState.PENDING
        self.nodes: List[int] = []
        self.psts: List[float] = []
        # orchestrator-maintained accounting
        self.arrival_time: Optional[float] = None
        self.first_service_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.node_time = 0.0      # integral of leased nodes over time
        self.presence_time = 0.0  # integral of time with demand > 0
        self.preemptions = 0      # lease shrunk while demand persisted
        self.resizes = 0
        # fault accounting: node_failures counts zero-grace losses of a
        # leased node; recoveries counts recovery actions actually run
        # (checkpoint rollback, serve crash_worker); recovery_ticks is the
        # simulated work re-done because of them
        self.node_failures = 0
        self.recoveries = 0
        self.recovery_ticks = 0.0

    # --- lifecycle --------------------------------------------------------
    def arrive(self, now: float) -> None:
        if self.state is not JobState.PENDING:
            raise RuntimeError(f"{self.spec.name}: duplicate arrival")
        self.state = JobState.SUSPENDED  # allocated on the next tick
        self.arrival_time = now

    def depart(self, now: float) -> None:
        if self.state in (JobState.RUNNING, JobState.SUSPENDED,
                          JobState.PENDING):
            self.state = JobState.DEPARTED
            self.finish_time = now

    @property
    def active(self) -> bool:
        return self.state in (JobState.RUNNING, JobState.SUSPENDED)

    # --- scheduling interface ---------------------------------------------
    def demand(self, now: float) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def on_allocation(self, nodes: Sequence[int], psts: Sequence[float],
                      now: float) -> None:
        self.nodes = list(nodes)
        self.psts = list(psts)
        if self.active:
            self.state = JobState.RUNNING if self.nodes else JobState.SUSPENDED
        if self.nodes and self.first_service_time is None:
            self.first_service_time = now

    def advance(self, dt: float, now: float) -> None:  # pragma: no cover
        raise NotImplementedError

    def on_node_failure(self, now: float) -> None:
        """Zero-grace loss of one leased node (the orchestrator routes
        `fail` trace events here).  The base class only counts it —
        subclasses that hold in-flight state on the node recover it
        (checkpoint rollback for trainers, `crash_worker` for servers)."""
        self.node_failures += 1

    def queueing_delay(self) -> Optional[float]:
        """Time from arrival to first node lease (cluster admission wait)."""
        if self.arrival_time is None or self.first_service_time is None:
            return None
        return self.first_service_time - self.arrival_time

    def slo_attainment(self) -> Optional[float]:
        """Rolling SLO attainment for jobs that track one (serving jobs
        with TTFT/TPOT targets); None for everything else.  The
        orchestrator threads this into `JobDemand` so the allocator can
        boost a job that is missing its SLOs."""
        return None

    def summary(self) -> Dict[str, Any]:
        return {
            "name": self.spec.name, "kind": self.spec.kind,
            "state": self.state.value, "weight": self.spec.weight,
            "priority": self.spec.priority,
            "arrival_time": self.arrival_time,
            "finish_time": self.finish_time,
            "queueing_delay": self.queueing_delay(),
            "node_time": self.node_time,
            "presence_time": self.presence_time,
            "normalized_share": (self.node_time
                                 / (self.spec.weight * self.presence_time)
                                 if self.presence_time > 0 else None),
            "preemptions": self.preemptions, "resizes": self.resizes,
            "node_failures": self.node_failures,
            "recoveries": self.recoveries,
            "retries": 0, "shed_requests": 0,
            "recovery_ticks": self.recovery_ticks,
        }


# ---------------------------------------------------------------------------
# Training jobs
# ---------------------------------------------------------------------------


class TrainJob(ClusterJob):
    """Elastic training job; see module docstring for the two modes."""

    def __init__(self, spec: JobSpec, store: ChunkStore,
                 solver_step: Callable[..., Dict],
                 metric_fn: Callable[[], float], *,
                 k_tasks: int, iterations: int, mode: str = "microtask",
                 sample_time: Optional[float] = None,
                 comm_overhead: float = 0.0, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_state_fn: Optional[Callable[[], Dict]] = None,
                 ckpt_restore_fn: Optional[Callable[[Dict], None]] = None):
        super().__init__(spec)
        if mode not in ("microtask", "unitask"):
            raise ValueError(f"unknown TrainJob mode {mode!r}")
        self.mode = mode
        self.k_tasks = k_tasks
        self.iterations = iterations
        self.iterations_done = 0
        self._solver_step = solver_step
        self._metric_fn = metric_fn
        self.store = store
        # crash consistency: every `ckpt_every` iterations snapshot the
        # per-sample chunk state (`store.state`, e.g. CoCoA's alphas) plus
        # whatever solver globals `ckpt_state_fn` exposes (e.g. the primal
        # w); a node failure rolls back to the last snapshot and re-does
        # the lost iterations (progress rollback, not bit-exact replay —
        # the engine's partition rng is deliberately not checkpointed)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self._ckpt_state_fn = ckpt_state_fn
        self._ckpt_restore_fn = ckpt_restore_fn
        self._budget = 0.0  # accumulated sim-time not yet spent on iterations
        # per-sample time scale: chosen so one full-allocation iteration
        # costs ~1 simulated second unless the caller overrides it
        if sample_time is None:
            sample_time = k_tasks / max(store.n_samples, 1)
        self.sample_time = sample_time

        def node_pst(i: int) -> float:
            rel = self.psts[i] if i < len(self.psts) else 1.0
            return rel * self.sample_time

        if mode == "microtask":
            self.engine: Any = MicroTaskEmulator(
                store, k_tasks,
                nodes_at=lambda t: max(1, len(self.nodes)),
                node_pst_pool=node_pst,
                comm_overhead=comm_overhead, seed=seed)
        else:
            assignment = Assignment(store.n_chunks, k_tasks,
                                    np.random.default_rng(seed))
            policy = ElasticScalingPolicy(
                lambda t: max(1, len(self.nodes)) if self.nodes else None)
            self.engine = UniTaskEngine(
                store, assignment, [policy], node_pst=node_pst,
                comm_overhead=comm_overhead, seed=seed)

    # --- scheduling -------------------------------------------------------
    def demand(self, now: float) -> int:
        if not self.active or self.iterations_done >= self.iterations:
            return 0
        return max(self.spec.min_nodes,
                   min(self.spec.max_nodes, self.k_tasks))

    def advance(self, dt: float, now: float) -> None:
        if not self.active:
            return
        if not self.nodes:
            return  # suspended: state parked in the chunks, no progress
        self._budget += dt
        while self._budget > 1e-9 and self.iterations_done < self.iterations:
            t0 = self.engine.sim_time
            self.engine.run(1, self._solver_step, self._metric_fn,
                            eval_every=1)
            self._budget -= self.engine.sim_time - t0
            self.iterations_done += 1
            self._maybe_checkpoint()
        if self.iterations_done >= self.iterations:
            self.state = JobState.FINISHED
            self.finish_time = now + dt

    # --- crash consistency ------------------------------------------------
    def _maybe_checkpoint(self) -> None:
        if not self.ckpt_dir or self.ckpt_every <= 0 \
                or self.iterations_done % self.ckpt_every:
            return
        from ..checkpoint.ckpt import save_checkpoint
        save_checkpoint(
            self.ckpt_dir, self.iterations_done,
            self._ckpt_state_fn() if self._ckpt_state_fn else {},
            chunk_state={k: np.asarray(v)
                         for k, v in self.store.state.items()})

    def recover(self, now: float) -> None:
        """Roll back to the last snapshot; the lost iterations re-run on
        subsequent `advance` ticks and are charged to `recovery_ticks`."""
        if not self.ckpt_dir or self.ckpt_every <= 0:
            return  # nothing persisted: chunk state survives in host memory
        from ..checkpoint.ckpt import latest_step, load_checkpoint
        step = latest_step(self.ckpt_dir)
        if step is None:
            return  # crashed before the first snapshot
        template = self._ckpt_state_fn() if self._ckpt_state_fn else {}
        state, _, meta = load_checkpoint(self.ckpt_dir, step, template)
        if self._ckpt_restore_fn is not None:
            self._ckpt_restore_fn(state)
        for k, v in meta["chunk_state"].items():
            self.store.state[k] = v
        self.recoveries += 1
        self.recovery_ticks += max(self.iterations_done - step, 0)
        del self.engine.history[step:]
        self.iterations_done = step

    def on_node_failure(self, now: float) -> None:
        super().on_node_failure(now)
        self.recover(now)

    # --- results ----------------------------------------------------------
    @property
    def history(self) -> List[IterationRecord]:
        return self.engine.history

    def loss_curve(self) -> List[float]:
        return [r.metric for r in self.history if r.metric is not None]

    def summary(self) -> Dict[str, Any]:
        s = super().summary()
        curve = self.loss_curve()
        s.update({"mode": self.mode, "k_tasks": self.k_tasks,
                  "iterations_done": self.iterations_done,
                  "final_metric": curve[-1] if curve else None})
        return s


def cocoa_train_job(name: str, *, iterations: int, k_tasks: int = 8,
                    weight: float = 1.0, priority: int = 0,
                    max_nodes: Optional[int] = None, mode: str = "microtask",
                    n: int = 4000, f: int = 64, chunk: int = 50,
                    lam: float = 1e-3, seed: int = 0,
                    sample_time: Optional[float] = None,
                    ckpt_dir: Optional[str] = None,
                    ckpt_every: int = 0, device="cuda") -> TrainJob:
    """A self-contained CoCoA/SVM training job (the paper's GLM workload);
    its per-sample dual state lives in the chunks, so cluster preemption and
    restoration never lose optimizer progress.  With `ckpt_dir` set, the
    duals (chunk state) and the primal w snapshot every `ckpt_every`
    iterations and a node failure rolls the job back to the last snapshot.
    The solver runs on `device`; the primal w is checkpointed as numpy and
    restored to the solver's device in fp32, exactly."""
    x, y = make_svm_data(n, f, seed=seed)
    store = ChunkStore({"x": x, "y": y}, chunk_size=chunk)
    solver = CoCoASolver(store, lam=lam, seed=seed, device=device)
    spec = JobSpec(name=name, kind="train", weight=weight, priority=priority,
                   max_nodes=max_nodes if max_nodes is not None else k_tasks)
    job = TrainJob(spec, store, lambda s, a, sh: solver.step(s, a, sh),
                   solver.metric, k_tasks=k_tasks, iterations=iterations,
                   mode=mode, seed=seed, sample_time=sample_time,
                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                   ckpt_state_fn=lambda: {"w": solver.w.cpu().numpy()},
                   ckpt_restore_fn=lambda s: setattr(
                       solver, "w", torch.from_numpy(
                           np.asarray(s["w"], np.float32)).to(
                               solver.device)))
    job.solver = solver  # exposed for state equality checks in tests
    return job


class LMTrainJob(ClusterJob):
    """Real-compute LM training job wrapping `launch.elastic.ElasticTrainer`.

    Unlike `TrainJob` (simulated solver timing), every step here runs the
    actual train step on `device`; the cluster models step *duration* as
    ``step_time * mean(pst) / n_nodes`` simulated seconds (linear data-
    parallel scaling over the lease).  Scale-to-zero uses the trainer's
    suspend/resume hooks: state is pulled to host on full revocation and
    placed back on the device on the next lease, bit-exactly.
    """

    def __init__(self, spec: JobSpec, cfg, tc, *,
                 batch_fn: Callable[[int], Dict], steps: int,
                 step_time: float = 1.0, seed: int = 0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 device="cuda"):
        super().__init__(spec)
        from ..launch.elastic import ElasticTrainer  # deferred: heavy import
        self.trainer = ElasticTrainer(cfg, tc, seed=seed, device=device)
        self.batch_fn = batch_fn
        self.steps = steps
        self.steps_done = 0
        self.step_time = step_time
        # crash consistency: params + optimizer state snapshot every
        # `ckpt_every` steps; a node failure rolls back to the newest
        # snapshot and re-runs the lost steps (batch_fn is a pure function
        # of the step index, so the replayed steps see identical batches)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self._budget = 0.0
        self.metrics_history: List[Dict] = []

    def demand(self, now: float) -> int:
        if not self.active or self.steps_done >= self.steps:
            return 0
        return max(self.spec.min_nodes, self.spec.max_nodes)

    def on_allocation(self, nodes: Sequence[int], psts: Sequence[float],
                      now: float) -> None:
        super().on_allocation(nodes, psts, now)
        if not self.active:
            return
        if not nodes:
            self.trainer.suspend()
        else:
            self.trainer.resume(len(nodes))

    def advance(self, dt: float, now: float) -> None:
        if not self.active or not self.nodes:
            return
        self._budget += dt
        it_time = (self.step_time * float(np.mean(self.psts))
                   / len(self.nodes))
        while self._budget > 1e-9 and self.steps_done < self.steps:
            m = self.trainer.train_step(self.batch_fn(self.steps_done))
            self.metrics_history.append(m)
            self.steps_done += 1
            self._budget -= it_time
            if self.ckpt_dir and self.ckpt_every > 0 \
                    and self.steps_done % self.ckpt_every == 0:
                from ..checkpoint.ckpt import save_checkpoint
                save_checkpoint(self.ckpt_dir, self.steps_done,
                                self.trainer.params, self.trainer.opt_state)
        if self.steps_done >= self.steps:
            self.state = JobState.FINISHED
            self.finish_time = now + dt

    # --- crash consistency ------------------------------------------------
    def recover(self, now: float) -> None:
        """Roll back params/opt state to the newest on-disk snapshot."""
        if not self.ckpt_dir:
            return
        from ..checkpoint.ckpt import latest_step, load_checkpoint
        step = latest_step(self.ckpt_dir)
        if step is None:
            return  # crashed before the first snapshot
        params, opt, _ = load_checkpoint(
            self.ckpt_dir, step, self.trainer.params, self.trainer.opt_state)
        self.trainer.params = params
        self.trainer.opt_state = opt
        # the restored module is a new one; marking the trainer suspended
        # makes resume() place it (and the optimizer state) on the device,
        # as it would state parked on the host
        self.trainer.suspended = True
        if self.nodes:
            self.trainer.resume(len(self.nodes))
        self.recoveries += 1
        self.recovery_ticks += max(self.steps_done - step, 0)
        del self.metrics_history[step:]
        self.steps_done = step

    def on_node_failure(self, now: float) -> None:
        super().on_node_failure(now)
        self.recover(now)

    def loss_curve(self) -> List[float]:
        return [m["loss"] for m in self.metrics_history]

    def summary(self) -> Dict[str, Any]:
        s = super().summary()
        curve = self.loss_curve()
        s.update({"steps_done": self.steps_done,
                  "final_loss": curve[-1] if curve else None})
        return s


# ---------------------------------------------------------------------------
# Serving jobs
# ---------------------------------------------------------------------------


class ServeJob(ClusterJob):
    """Serving job on the simulated clock; demand follows the backlog.

    With ``kv_layout="paged"`` a lease SHRINK parks the now-unservable
    decode slots (pages to host memory, O(moved pages), nothing
    re-prefilled) instead of letting them contend for the smaller lease;
    the bytes moved are charged to `kv_moved_bytes` and surface in the
    cluster report — the serving half of Chicle's cheap-preemption claim.
    """

    def __init__(self, spec: JobSpec, cfg, *, capacity: int = 8,
                 cache_len: int = 48, prefill_bucket: int = 8,
                 slots_per_node: int = 2, ticks_per_dt: float = 2.0,
                 max_admit_per_tick: int = 4,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 kv_layout: str = "flat", page_size: int = 8,
                 prefix_share: Optional[bool] = None,
                 evict: Optional[bool] = None,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 seed: int = 0, tracer=None, device="cuda"):
        super().__init__(spec)
        self._sim_now = 0.0
        self.slots_per_node = slots_per_node
        self.ticks_per_dt = ticks_per_dt
        # note: sharing one tracer across jobs merges their engine-phase
        # tracks; give each job its own tracer to keep traces separable
        self.engine = ServeEngine(
            cfg, capacity=capacity, cache_len=cache_len,
            prefill_bucket=prefill_bucket, n_workers=1,
            max_admit_per_tick=max_admit_per_tick,
            tenant_weights=tenant_weights, seed=seed,
            kv_layout=kv_layout, page_size=page_size,
            prefix_share=prefix_share, evict=evict,
            slo_ttft=slo_ttft, slo_tpot=slo_tpot,
            clock=lambda: self._sim_now, tracer=tracer, device=device)
        self._rid = 0
        self.expected_requests = 0
        self.no_more_arrivals = False  # set by the orchestrator from the trace

    @property
    def kv_moved_bytes(self) -> int:
        """All KV bytes moved host<->device by preemptions: lease-shrink
        parks, priority-admission parks, and the restores that bring both
        back — the engine's memory manager is the authoritative ledger."""
        if self.engine.mem is None:
            return 0
        s = self.engine.mem.stats()
        return int(s["park_bytes"] + s["restore_bytes"])

    # --- workload ---------------------------------------------------------
    def make_requests(self, at: float, n: int, *, rate: float = 0.0,
                      prompt_len: Sequence[int] = (6, 16),
                      max_new_tokens: Sequence[int] = (4, 8),
                      tenant: str = "default",
                      seed: int = 0) -> List[Request]:
        """Build `n` synthetic requests arriving at sim time `at` (burst) or
        as a Poisson stream of `rate` req/s starting at `at`."""
        rng = np.random.default_rng(seed)
        offsets = poisson_arrivals(n, rate, rng=rng)
        reqs = synthetic_requests(
            n, vocab_size=self.engine.cfg.vocab_size, arrivals=at + offsets,
            prompt_len=tuple(prompt_len),
            max_new_tokens=tuple(max_new_tokens),
            rng=rng, tenant=tenant, rid_base=self._rid)
        self._rid += n
        return reqs

    def submit_requests(self, requests: Sequence[Request]) -> None:
        self.expected_requests += len(requests)
        self.engine.submit(requests)

    # --- scheduling -------------------------------------------------------
    def backlog(self, now: float) -> int:
        # crash victims waiting out their retry backoff are still demand —
        # without them a post-crash lease could drop to zero and the engine
        # would never tick again to re-enqueue them
        return (self.engine.n_active_slots + len(self.engine._retrying)
                + self.engine.scheduler.n_arrived(now))

    def demand(self, now: float) -> int:
        if not self.active:
            return 0
        b = self.backlog(now)
        if b == 0:
            return self.spec.min_nodes
        want = math.ceil(b / self.slots_per_node)
        return max(self.spec.min_nodes, min(self.spec.max_nodes, want))

    def on_allocation(self, nodes: Sequence[int], psts: Sequence[float],
                      now: float) -> None:
        prev = len(self.nodes)
        super().on_allocation(nodes, psts, now)
        if not self.active:
            return
        if not nodes:
            self.engine.suspend()  # scale-to-zero: KV + queues kept intact
        else:
            self.engine.resume()
            if self.engine.evict:
                # cap concurrent decodes at what the lease can serve; on a
                # shrink, park the overhang (pages to host, charged below)
                # — parked slots stay parked until the lease grows again.
                # Mid-prefill slots count against the lease but cannot be
                # parked themselves (only decodes park), so park_excess
                # evicts that many more decoding slots instead.
                allowed = max(1, len(nodes) * self.slots_per_node)
                self.engine.scheduler.active_cap = allowed
                over = self.engine.n_active_slots - allowed
                if len(nodes) < prev and over > 0:
                    self.engine.park_excess(over)  # bytes land in mem.stats
            if self.engine.k != len(nodes):
                self.engine.resize(len(nodes))

    def advance(self, dt: float, now: float) -> None:
        if not self.active:
            return
        if not self.nodes:
            self._sim_now = now + dt  # time passes while parked
            return
        # modeled linear scaling: n nodes -> n * ticks_per_dt decode ticks
        nticks = max(1, int(round(len(self.nodes) * self.ticks_per_dt * dt)))
        for i in range(1, nticks + 1):
            self._sim_now = now + dt * i / nticks
            self.engine.tick()

    def on_node_failure(self, now: float) -> None:
        """A leased node died: the in-flight decodes it hosted are gone.
        Map the node loss onto the engine's crash path — victims re-queue
        through RETRYING and the engine shrinks by one logical worker (the
        orchestrator hands us the shrunken lease right after)."""
        super().on_node_failure(now)
        self._sim_now = max(self._sim_now, now)
        if self.engine.suspended:
            return  # scale-to-zero: no KV resident anywhere to lose
        self.engine.crash_worker()
        self.recoveries += 1

    def drained(self) -> bool:
        return (not self.engine._by_slot
                and not self.engine._prefilling
                and not self.engine.scheduler.has_pending
                and not self.engine._retrying)

    def service_time(self) -> float:
        """Simulated time in service (first lease -> now); throughput is
        measured over this window, not absolute cluster time."""
        if self.first_service_time is None:
            return 0.0
        return max(self._sim_now - self.first_service_time, 0.0)

    def slo_attainment(self) -> Optional[float]:
        """Windowed attainment from the engine's live tracker (None until
        targets are set and a finish lands in the window).  `DisaggEngine`
        exposes the same `slo` property, so `DisaggServeJob` inherits."""
        slo = self.engine.slo
        return slo.attainment() if slo is not None else None

    def maybe_finish(self, now: float) -> None:
        # no expected_requests floor: a server whose trace never delivers a
        # burst must still retire once its event horizon passes, or the
        # orchestrator would spin to max_ticks on an empty job
        if self.active and self.no_more_arrivals and self.drained():
            self.state = JobState.FINISHED
            self.finish_time = now
            self.engine.metrics.wall_s = self.service_time()

    def summary(self) -> Dict[str, Any]:
        s = super().summary()
        m = self.engine.metrics
        if m.wall_s == 0.0:  # mid-run snapshot: derive, don't mutate
            m = dataclasses.replace(m, wall_s=self.service_time())
        srv = m.summarize()
        s.update({"serve": srv,
                  "expected_requests": self.expected_requests,
                  "kv_moved_bytes": self.kv_moved_bytes,
                  "slo_attainment": self.slo_attainment(),
                  "goodput": srv.get("goodput"),
                  # the serve engine is the authoritative fault ledger here
                  "retries": srv.get("retries_total", 0),
                  "shed_requests": srv.get("shed_requests", 0),
                  "recovery_ticks": sum(
                      rt for _, rt, _ in srv.get("recovery_events", []))})
        return s


class DisaggServeJob(ServeJob):
    """Disaggregated serving job: the fair-share allocator sizes the
    prefill + decode pools as ONE job, and the engine's `SplitPolicy`
    divides the lease internally.  A lease change maps to
    `DisaggEngine.resize(total)` (ratio-preserving), scale-to-zero
    suspends both halves, and a shrink parks excess DECODE slots (prefill
    slots drain through the handoff within a tick).  Subclasses `ServeJob`
    so the orchestrator's serve-specific paths (burst routing, arrival
    horizons) apply unchanged."""

    def __init__(self, spec: JobSpec, cfg, *, capacity: int = 8,
                 cache_len: int = 48, prefill_bucket: int = 8,
                 slots_per_node: int = 2, ticks_per_dt: float = 2.0,
                 max_admit_per_tick: int = 4,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 page_size: int = 8,
                 prefix_share: Optional[bool] = None,
                 evict: Optional[bool] = None,
                 prefill_workers: Optional[int] = None,
                 split_policy: Optional["SplitPolicy"] = None,
                 spec_mode: str = "off", spec_k: int = 4,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 seed: int = 0, tracer=None, device="cuda"):
        ClusterJob.__init__(self, spec)
        self._sim_now = 0.0
        self.slots_per_node = slots_per_node
        self.ticks_per_dt = ticks_per_dt
        self.engine = DisaggEngine(
            cfg, capacity=capacity, cache_len=cache_len,
            prefill_bucket=prefill_bucket, n_workers=1,
            prefill_workers=prefill_workers, split_policy=split_policy,
            max_admit_per_tick=max_admit_per_tick,
            tenant_weights=tenant_weights, seed=seed,
            page_size=page_size, prefix_share=prefix_share, evict=evict,
            spec=spec_mode, spec_k=spec_k,
            slo_ttft=slo_ttft, slo_tpot=slo_tpot,
            clock=lambda: self._sim_now, tracer=tracer, device=device)
        self._rid = 0
        self.expected_requests = 0
        self.no_more_arrivals = False

    @property
    def kv_moved_bytes(self) -> int:
        """Both halves' ledgers: handoff parks land on the prefill side,
        handoff restores (plus any lease-shrink parks) on the decode side."""
        total = 0
        for half in (self.engine.prefill, self.engine.decode):
            if half.mem is not None:
                s = half.mem.stats()
                total += int(s["park_bytes"] + s["restore_bytes"])
        return total

    # --- scheduling -------------------------------------------------------
    def backlog(self, now: float) -> int:
        eng = self.engine
        return (eng.n_active_slots
                + len(eng.prefill._retrying) + len(eng.decode._retrying)
                + len(eng._handoff_retry)
                + eng.prefill.scheduler.n_arrived(now)
                + eng.decode.scheduler.n_arrived(now))

    def on_allocation(self, nodes: Sequence[int], psts: Sequence[float],
                      now: float) -> None:
        prev = len(self.nodes)
        ClusterJob.on_allocation(self, nodes, psts, now)
        if not self.active:
            return
        eng = self.engine
        if not nodes:
            eng.suspend()  # scale-to-zero: KV, queues, handoff kept intact
        else:
            eng.resume()
            if eng.decode.evict:
                allowed = max(1, len(nodes) * self.slots_per_node)
                eng.decode.scheduler.active_cap = allowed
                over = eng.n_active_slots - allowed
                if len(nodes) < prev and over > 0:
                    eng.park_excess(over)
            if eng.total_workers != len(nodes):
                eng.resize(len(nodes))

    def advance(self, dt: float, now: float) -> None:
        if not self.active:
            return
        if not self.nodes:
            self._sim_now = now + dt  # time passes while parked
            return
        nticks = max(1, int(round(len(self.nodes) * self.ticks_per_dt * dt)))
        for i in range(1, nticks + 1):
            self._sim_now = now + dt * i / nticks
            self.engine.tick()

    def drained(self) -> bool:
        return self.engine.drained

    def on_node_failure(self, now: float) -> None:
        """Node loss routed through the disagg fault path (default: the
        decode pool — losing its only worker collapses the engine to
        degraded monolithic serving rather than killing the job)."""
        ClusterJob.on_node_failure(self, now)
        self._sim_now = max(self._sim_now, now)
        if self.engine.suspended:
            return
        from ..faults import worker_crash
        self.engine.apply_fault(worker_crash(at=max(int(now), 0)))
        self.recoveries += 1

    def maybe_finish(self, now: float) -> None:
        if self.active and self.no_more_arrivals and self.drained():
            self.state = JobState.FINISHED
            self.finish_time = now
            self.engine.finalize(self.service_time())

    def summary(self) -> Dict[str, Any]:
        s = ClusterJob.summary(self)
        m = self.engine.metrics
        wall = m.wall_s if m.wall_s else self.service_time()
        srv = m.summarize(wall_s=wall)
        s.update({"serve": srv,
                  "expected_requests": self.expected_requests,
                  "kv_moved_bytes": self.kv_moved_bytes,
                  "slo_attainment": self.slo_attainment(),
                  "goodput": srv.get("goodput"),
                  "retries": srv.get("retries_total", 0),
                  "shed_requests": srv.get("shed_requests", 0),
                  "recovery_ticks": sum(
                      rt for _, rt, _ in srv.get("recovery_events", []))})
        return s
