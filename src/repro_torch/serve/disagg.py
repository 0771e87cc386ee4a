"""Disaggregated serving on PyTorch: a prefill pool and a decode pool as
two cooperating `ServeEngine` halves over disjoint worker subsets, with the
JAX package's names, order of work and accounting.

Monolithic continuous batching interleaves (chunked) prefill with decode
in one tick loop, so a burst of long prompts steals decode ticks from
in-flight streams.  `DisaggEngine` separates the two:

- Requests are admitted to the **prefill pool** (a `ServeEngine` with
  ``decode_enabled=False``): its ticks run admission and (chunked) prefill
  only, and freshly prefilled slots wait for handoff instead of decoding.
- After each prefill tick the engine **extracts** every prefilled slot:
  `ServeEngine.park` gathers the slot's live pages to host memory in one
  O(pages) device-to-host copy (the same primitive as eviction), the
  request leaves the prefill pool, and (request, payload) enters the
  handoff queue.
- The **decode pool** (a full `ServeEngine`, optionally speculative)
  **injects** each handoff: the payload is adopted into its memory manager
  and the request queued; admission then restores it with ONE scatter,
  re-matching the prompt against the decode-side prefix index first, so a
  handed-off few-shot stream regains its page dedup.  Nothing is
  prefilled twice, and the token stream is the monolithic run's.

A `SplitPolicy` rebalances the prefill:decode worker split every few
ticks from observed backlog tokens and per-pool host tick times, through
`resize(k)` on each half.  Workers are logical: both halves run on the one
device, share one `params` module (never copied) and one clock, and each
allocates its own KV pool.  Both pools run attention as `ServeEngine`
does by default, through the paged-attention kernel (``paged_impl=
"kernel"``).

The handoff goes through the host, as in the JAX package: `park` copies
the pages to the host with a blocking `.cpu()` and the decode pool's
restore copies them back.  With ``overlap=True`` the drain runs in the
decode pool's prep window (`overlap_hook`) while its step is in flight,
and that blocking copy waits for the step.

Tracing: each half gets a `ScopedTracer` ("prefill_pool." / "decode_pool."
tracks), and the handoff itself emits ``handoff.extract`` /
``handoff.inject`` spans on the shared parent tracer: one Chrome trace,
three families of rows.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..configs.base import ModelConfig
from ..faults import FaultEvent, FaultInjector
from ..models import model as M
from ..obs import NULL_TRACER, ScopedTracer, Tracer
from .engine import ServeEngine, ServeMetrics
from .memory import ParkedSeq
from .overload import AdmissionController, CircuitBreaker, DegradationLadder
from .pages import PageError
from .request import Request, RequestState


# ---------------------------------------------------------------------------
# Split policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SplitObs:
    """What a `SplitPolicy` sees each tick: queue depths in TOKENS (work,
    not request counts), per-pool host tick-time EMAs, and the handoff
    queue depth."""

    total_workers: int
    prefill_backlog_tokens: int
    decode_backlog_tokens: int
    prefill_tick_s: float
    decode_tick_s: float
    handoff_depth: int
    tick: int
    # rolling SLO attainment from the decode half's tracker (None when no
    # targets are configured or nothing has finished in the window); lets
    # a policy trade prefill vs decode workers on the metric users feel
    ttft_attainment: Optional[float] = None
    tpot_attainment: Optional[float] = None


class SplitPolicy:
    """Decides the prefill pool's worker count each tick (the decode pool
    gets the remainder).  The base policy never moves workers."""

    def decide(self, obs: SplitObs, *, current: int) -> int:
        return current


class QueueSplitPolicy(SplitPolicy):
    """Work-proportional split with hysteresis: every `interval` ticks,
    weight each pool's backlog tokens by its observed per-tick host time
    and move AT MOST one worker toward the proportional target — cheap,
    frequent, minimal-churn rebalancing in the Chicle spirit (a worker
    move re-assigns slots on each half, so the policy damps churn rather
    than chasing every queue wiggle).

    mode="slo" steers on SLO attainment instead of backlog: when TTFT
    attainment trails TPOT attainment by more than `slo_deadband`, new
    requests are the ones suffering — grow the prefill pool; when TPOT
    trails, in-flight streams are suffering — grow the decode pool.
    Inside the dead band (or before any finishes populate the window)
    it falls back to the backlog-proportional rule, so a cold engine
    behaves exactly like mode="backlog"."""

    def __init__(self, interval: int = 4, min_each: int = 1,
                 mode: str = "backlog", slo_deadband: float = 0.05):
        if mode not in ("backlog", "slo"):
            raise ValueError(
                f"mode must be 'backlog' or 'slo', got {mode!r}")
        self.interval = max(1, int(interval))
        self.min_each = max(1, int(min_each))
        self.mode = mode
        self.slo_deadband = float(slo_deadband)

    def decide(self, obs: SplitObs, *, current: int) -> int:
        if obs.tick % self.interval != 0:
            return current
        lo = self.min_each
        hi = max(obs.total_workers - self.min_each, lo)
        if self.mode == "slo" and obs.ttft_attainment is not None \
                and obs.tpot_attainment is not None:
            gap = obs.ttft_attainment - obs.tpot_attainment
            if gap < -self.slo_deadband:  # TTFT is the worse SLO
                return min(current + 1, hi)
            if gap > self.slo_deadband:  # TPOT is the worse SLO
                return max(current - 1, lo)
            return current
        # relative cost of a prefill-pool tick vs a decode-pool tick; the
        # clamp keeps one noisy EMA sample from slamming the split
        cost = 1.0
        if obs.prefill_tick_s > 0 and obs.decode_tick_s > 0:
            cost = min(max(obs.prefill_tick_s / obs.decode_tick_s, 0.25),
                       4.0)
        wp = obs.prefill_backlog_tokens * cost
        wd = float(obs.decode_backlog_tokens + obs.handoff_depth)
        if wp + wd <= 0:
            return current
        want = int(round(obs.total_workers * wp / (wp + wd)))
        want = min(max(want, lo), hi)
        if want > current:
            return current + 1
        if want < current:
            return current - 1
        return current


class ScheduledSplitPolicy(SplitPolicy):
    """Explicit (tick, prefill_workers) schedule — the disagg analogue of
    `core.policies.ElasticScalingPolicy`, used by tests and demos to force
    deterministic mid-run rebalances."""

    def __init__(self, events: Sequence[Tuple[int, int]]):
        self.events = sorted((int(t), int(k)) for t, k in events)

    def decide(self, obs: SplitObs, *, current: int) -> int:
        kp = current
        for at, k in self.events:
            if obs.tick >= at:
                kp = k
        return kp


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DisaggMetrics:
    """Per-pool `ServeMetrics` plus handoff/split accounting.  `combined`
    builds one ServeMetrics over both halves (each request counted once,
    tick records concatenated) so the standard summary keys — TTFT, queue
    delay, handoff delay, tokens/s — mean the same thing as monolithic."""

    prefill: ServeMetrics
    decode: ServeMetrics
    handoffs: int = 0
    handoff_bytes: int = 0
    handoff_drops: int = 0  # injected in-flight transfer losses
    handoff_retries: int = 0  # dropped payloads re-sent from the parked copy
    split_events: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)  # (tick, prefill_workers, decode_workers)
    degraded_events: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)  # (tick, "enter:<why>" | "exit")
    wall_s: float = 0.0

    @property
    def requests(self) -> List[Request]:
        """Union of both halves' requests, each exactly once (a handed-off
        request appears in both halves' lists; the objects are shared, so
        either copy carries the full lifecycle)."""
        seen: Dict[int, Request] = {}
        for r in self.prefill.requests:
            seen.setdefault(r.rid, r)
        for r in self.decode.requests:
            seen.setdefault(r.rid, r)
        return list(seen.values())

    def combined(self, wall_s: Optional[float] = None) -> ServeMetrics:
        return ServeMetrics(
            requests=self.requests,
            ticks=self.prefill.ticks + self.decode.ticks,
            fault_events=self.prefill.fault_events
            + self.decode.fault_events,
            recovery_events=self.prefill.recovery_events
            + self.decode.recovery_events,
            brownout_events=list(self.decode.brownout_events),
            breaker_events=list(self.decode.breaker_events),
            slo_ttft=self.decode.slo_ttft,
            slo_tpot=self.decode.slo_tpot,
            wall_s=self.wall_s if wall_s is None else wall_s)

    def summarize(self, wall_s: Optional[float] = None) -> Dict[str, Any]:
        w = self.wall_s if wall_s is None else wall_s
        out = self.combined(w).summarize()
        halves: Dict[str, Any] = {}
        for name, m in (("prefill_pool", self.prefill),
                        ("decode_pool", self.decode)):
            mm = m if m.wall_s or not w else dataclasses.replace(m, wall_s=w)
            halves[name] = mm.summarize()
        out["disagg"] = {
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "handoff_drops": self.handoff_drops,
            "handoff_retries": self.handoff_retries,
            "split_events": [list(e) for e in self.split_events],
            "degraded_events": [list(e) for e in self.degraded_events],
            **halves,
        }
        return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class DisaggEngine:
    """Prefill and decode pools over disjoint worker subsets with a
    page-granular handoff queue between them.

    One disagg tick = rebalance (maybe) -> prefill-pool tick -> extract
    every prefilled slot (park to host, O(pages) each) -> inject into the
    decode pool (adopt + queue) -> decode-pool tick (restores newly
    injected requests through admission, then one solver step).  A request
    handed off in tick t therefore emits its first decode token in tick
    t+? only as decode slots free up — its prefill never stole a decode
    tick, which is the whole point.

    Worker counts are LOGICAL (as everywhere in this repo): both halves
    run on `device`, and with total_workers == 1 each half runs one
    logical worker.  Both halves hold the same `params` module."""

    def __init__(self, cfg: ModelConfig, *, capacity: int = 8,
                 cache_len: int = 64, prefill_bucket: int = 16,
                 n_workers: int = 2, prefill_workers: Optional[int] = None,
                 prefill_capacity: Optional[int] = None,
                 split_policy: Optional[SplitPolicy] = None,
                 page_size: int = 8, paged_impl: str = "kernel",
                 prefix_share: Optional[bool] = None,
                 evict: Optional[bool] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 spec: str = "off", spec_k: int = 4,
                 drafter: Optional[Any] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Optional[Any] = None,
                 slots_per_chunk: int = 2, max_admit_per_tick: int = 4,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 seed: int = 0, params: Optional[M.Transformer] = None,
                 clock: Optional[Any] = None,
                 debug_checks: bool = False,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_backoff: int = 1, retry_jitter: bool = True,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 slo_window: int = 64,
                 tenant_rate: Optional[Any] = None,
                 tenant_burst: Optional[Any] = None,
                 queue_cap: Optional[int] = None,
                 brownout: str = "off",
                 ladder: Optional[DegradationLadder] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 overlap: bool = False,
                 tracer: Optional[Tracer] = None,
                 device="cuda"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.cfg = cfg
        self.overlap = bool(overlap)
        self.cache_len = cache_len
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.split_policy = split_policy
        self.debug_checks = debug_checks
        self.total_workers = int(n_workers)
        if prefill_workers is not None:
            kp = int(prefill_workers)
            hi = max(self.total_workers - 1, 1)
            if not 1 <= kp <= hi:
                raise ValueError(
                    f"prefill_workers must be in [1, {hi}] so the decode "
                    f"pool keeps at least one worker (n_workers="
                    f"{self.total_workers}); got {kp}")
        else:
            kp = max(1, self.total_workers // 2)
        kd = max(self.total_workers - kp, 1)

        # both halves share ONE clock so TTFT (stamped by the prefill half)
        # and TPOT (decode half) land on the same timebase
        self._clock_ext = clock
        self._t0: Optional[float] = None

        def scoped(scope: str) -> Optional[Tracer]:
            if self.tracer.enabled:
                return ScopedTracer(self.tracer, scope)
            return None

        # ONE admission controller shared by both halves: fresh arrivals
        # enter through whichever half currently takes submissions (prefill
        # normally, decode when degraded), and a shared token bucket means
        # the tenant's rate limit doesn't reset when the entry point moves
        admission = None
        if tenant_rate is not None or queue_cap is not None:
            admission = AdmissionController(
                tenant_rate=tenant_rate, tenant_burst=tenant_burst,
                queue_cap=queue_cap,
                drain_rate=float(max_admit_per_tick))

        self.prefill = ServeEngine(
            cfg, capacity=(prefill_capacity if prefill_capacity is not None
                           else capacity),
            cache_len=cache_len, prefill_bucket=prefill_bucket,
            n_workers=kp, slots_per_chunk=slots_per_chunk,
            max_admit_per_tick=max_admit_per_tick, seed=seed, params=params,
            tenant_weights=tenant_weights, clock=self._now,
            kv_layout="paged", page_size=page_size,
            chunked_prefill=chunked_prefill, prefill_chunk=prefill_chunk,
            paged_impl=paged_impl, prefix_share=prefix_share,
            # the prefill pool never decodes, so priority preemption there
            # would only churn mid-prefill state — keep handoff the one
            # park path on this half
            evict=False, spec="off", decode_enabled=False,
            debug_checks=debug_checks, retry_backoff=retry_backoff,
            retry_jitter=retry_jitter, admission=admission,
            slo_ttft=slo_ttft, slo_tpot=slo_tpot, slo_window=slo_window,
            overlap=overlap, tracer=scoped("prefill_pool"), device=device)
        self.decode = ServeEngine(
            cfg, capacity=capacity, cache_len=cache_len,
            prefill_bucket=prefill_bucket, n_workers=kd,
            slots_per_chunk=slots_per_chunk,
            max_admit_per_tick=max_admit_per_tick, seed=seed,
            # ONE params module for both halves: ServeEngine's .to(device)
            # returns the same module, nothing is copied or cast
            params=self.prefill.params,
            tenant_weights=tenant_weights, clock=self._now,
            kv_layout="paged", page_size=page_size, paged_impl=paged_impl,
            prefix_share=prefix_share, evict=evict,
            spec=spec, spec_k=spec_k, drafter=drafter, draft_cfg=draft_cfg,
            draft_params=draft_params, debug_checks=debug_checks,
            retry_backoff=retry_backoff, retry_jitter=retry_jitter,
            admission=admission,
            # the decode half hosts the control loop: it owns the SLO
            # tracker that scores finishes, and the brownout ladder /
            # breaker act where the levers live (spec, chunk width, parks)
            slo_ttft=slo_ttft, slo_tpot=slo_tpot, slo_window=slo_window,
            brownout=brownout, ladder=ladder, breaker=breaker,
            overlap=overlap, tracer=scoped("decode_pool"), device=device)
        if overlap:
            # overlapped handoff transfer: while the decode pool's solver
            # step is in flight, its prep window drains the prefill pool's
            # finished slots (park gathers) into the handoff queue — the
            # transfer cost hides behind decode compute instead of
            # serializing between the two pools' ticks
            self.decode.overlap_hook = self._drain_prefilled

        # the DISAGG engine owns the injector (the halves get none): pool
        # routing and handoff drops only make sense at this level
        self.fault_injector = fault_injector
        self.degraded = False
        self._drop_pending = 0  # armed handoff_drop faults
        self._handoff_retry: List[Tuple[Request, ParkedSeq]] = []
        self._handoff: Deque[Tuple[Request, ParkedSeq]] = deque()
        self.metrics = DisaggMetrics(prefill=self.prefill.metrics,
                                     decode=self.decode.metrics)
        self._tick = 0
        self._last_split: Tuple[int, int] = (0, 0)
        self._note_split(kp, kd)
        # per-pool host tick-time EMAs: the split policy's cost signal
        self._ema_p = 0.0
        self._ema_d = 0.0

    # --- clock ------------------------------------------------------------
    def _now(self) -> float:
        if self._clock_ext is not None:
            return float(self._clock_ext())
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    # --- elasticity -------------------------------------------------------
    def _note_split(self, kp: int, kd: int) -> None:
        if (kp, kd) != self._last_split:
            self._last_split = (kp, kd)
            self.metrics.split_events.append((self._tick, kp, kd))
            self.tracer.instant("split.apply", track="split",
                                prefill=kp, decode=kd)

    def _apply_split(self, kp: int) -> None:
        kp = max(1, kp)
        kd = max(self.total_workers - kp, 1)
        if self.prefill.k != kp:
            self.prefill.resize(kp)
        if self.decode.k != kd:
            self.decode.resize(kd)
        self._note_split(kp, kd)

    def resize(self, k: int) -> None:
        """Elastic resize of the TOTAL worker count (the cluster lease
        hook); the current prefill:decode ratio is preserved and the split
        policy re-optimizes from there.  A resize to k >= 2 while degraded
        (one pool had lost all its workers) re-splits the pools and exits
        degraded mode — capacity returned, disaggregation resumes."""
        if k < 1:
            raise ValueError(
                f"resize(k) needs at least one worker, got k={k}; to stop "
                f"serving use suspend(), not a zero-worker resize")
        k = int(k)
        if self.degraded:
            self.total_workers = k
            if k >= 2:
                self._exit_degraded()
            else:
                self.decode.resize(k)
            return
        frac = self.prefill.k / max(self.prefill.k + self.decode.k, 1)
        self.total_workers = k
        kp = 1 if k == 1 else min(max(int(round(frac * k)), 1), k - 1)
        self._apply_split(kp)

    @property
    def slo(self):
        """The live SLO tracker (decode half's — the one finishes score
        against); None when no targets are configured."""
        return self.decode.slo

    def _observe(self) -> SplitObs:
        now = self._now()
        p, d = self.prefill, self.decode
        ptoks = sum(r.prompt_len for r in p.scheduler.pending
                    if r.arrival_time <= now)
        ptoks += sum(req.prompt_len - off
                     for req, off in p._prefilling.values())
        ptoks += sum(r.prompt_len for r in p._by_slot.values())
        remaining = lambda r: max(r.max_new_tokens - r.n_generated, 0)  # noqa: E731
        dtoks = sum(remaining(r) for r in d._by_slot.values())
        dtoks += sum(remaining(r) for r, _ in self._handoff)
        dtoks += sum(remaining(r) for r in d.scheduler.pending)
        slo = self.decode.slo
        return SplitObs(total_workers=self.total_workers,
                        prefill_backlog_tokens=int(ptoks),
                        decode_backlog_tokens=int(dtoks),
                        prefill_tick_s=self._ema_p,
                        decode_tick_s=self._ema_d,
                        handoff_depth=len(self._handoff),
                        tick=self._tick,
                        ttft_attainment=(slo.ttft_attainment()
                                         if slo is not None else None),
                        tpot_attainment=(slo.tpot_attainment()
                                         if slo is not None else None))

    def _maybe_rebalance(self) -> None:
        pol = self.split_policy
        if pol is None or self.total_workers < 2:
            return
        obs = self._observe()
        kp = int(pol.decide(obs, current=self.prefill.k))
        kp = min(max(kp, 1), self.total_workers - 1)
        if kp != self.prefill.k:
            with self.tracer.span("split.rebalance", kp=kp,
                                  kd=self.total_workers - kp,
                                  prefill_backlog=obs.prefill_backlog_tokens,
                                  decode_backlog=obs.decode_backlog_tokens):
                self._apply_split(kp)

    # --- fault injection + degraded mode ----------------------------------
    def apply_fault(self, ev: FaultEvent) -> None:
        """Route one injected fault.  `payload["pool"]` picks the half for
        crash/slow ("prefill" / "decode"; default decode — the pool with
        long-lived state).  revoke_lease is cluster scope, ignored here."""
        pool = ev.payload.get("pool", "decode")
        if pool not in ("prefill", "decode"):
            raise ValueError(f"fault pool must be 'prefill' or 'decode', "
                             f"got {pool!r}")
        eng = self.prefill if pool == "prefill" else self.decode
        if ev.kind == "worker_crash":
            target = None if ev.target is None else int(ev.target)
            if self.degraded:
                # already monolithic: a further crash hits the one pool,
                # which cold-replaces at k=1 like a monolithic engine
                self.decode.crash_worker(target)
                self.total_workers = self.decode.k
            elif eng.k <= 1:
                # the pool just lost its LAST worker: collapse to
                # monolithic serving on the survivors
                self._pool_lost(pool, target)
            else:
                eng.crash_worker(target)
                self.total_workers = self.prefill.k + self.decode.k
        elif ev.kind == "worker_slow":
            w = eng.k - 1 if ev.target is None else int(ev.target)
            eng.set_worker_slow(w, ev.factor)
        elif ev.kind == "handoff_drop":
            self._drop_pending += 1

    def _restart_into_decode(self, reqs: Sequence[Request]) -> None:
        """Crash-restart a batch of requests into the decode half: streams
        reset (greedy re-execution is bit-equal), retry budgets charged,
        backoff on the decode tick clock."""
        d = self.decode
        now = self._now()
        for req in reqs:
            req.slot = None
            req.generated = []
            req.t_first_token = None
            req.retries += 1
            if req.retries > req.max_retries:
                d._shed(req, now, reason="retries")
            else:
                req.state = RequestState.RETRYING
                ready = d._tick + d._backoff_ticks(req.retries)
                d._retrying.append((ready, req))
                d._tick_faults["retries"] += 1
                d.tracer.count("serve.retries_total")

    def _pool_lost(self, pool: str, worker: Optional[int]) -> None:
        """One pool lost its last worker: collapse to MONOLITHIC serving on
        the decode engine (the full-featured half — it can prefill and
        decode).  Queued and retrying work re-routes there; a prefill-pool
        loss restarts its in-flight slots (their KV died), a decode-pool
        loss hands completed prefills off normally (their KV lives on the
        surviving prefill workers) and restarts only mid-prefill slots."""
        p, d = self.prefill, self.decode
        self.degraded = True
        self.metrics.degraded_events.append((self._tick, "enter:" + pool))
        self.tracer.instant("degraded.enter", track="faults", pool=pool,
                            tick=self._tick)
        self.tracer.count("serve.degraded_events")
        with self.tracer.span("recovery.degrade", track="faults", pool=pool):
            if pool == "prefill":
                # every slot resident on the dying pool is lost; the engine
                # books the crash, then its retry queue moves to decode
                p.crash_worker(worker)
                d._retrying.extend(
                    (d._tick + d.retry_backoff, r) for _, r in p._retrying)
                p._retrying = []
                survivors = d.k
            else:
                d.crash_worker(worker)  # cold drop of the decode residents
                # completed prefills survive on the prefill workers: one
                # last handoff preserves their KV bit-for-bit
                self._drain_prefilled()
                # mid-prefill slots can't hand off (pages partial): release
                # their pages and restart them in the monolithic pool
                lost = []
                for slot in sorted(p._prefilling):
                    req, _off = p._prefilling.pop(slot)
                    p.mem.release_slot(slot)
                    p.scheduler.pool.free(slot)
                    lost.append(req)
                self._restart_into_decode(lost)
                survivors = p.k
            # recovery windows ride along so they close when the victims
            # re-admit in the monolithic pool
            d._recovering.extend(p._recovering)
            p._recovering = []
            # queued admissions re-route to the monolithic half
            pending = p.scheduler.pending
            p.scheduler._queues.clear()
            for r in pending:
                d.scheduler.submit(r)
            # the monolithic pool re-forms over the surviving worker count
            if d.k != max(1, survivors):
                d.resize(max(1, survivors))
        self.total_workers = d.k
        self._note_split(0, d.k)

    def _exit_degraded(self) -> None:
        """Capacity returned (resize k >= 2): re-split the pools and route
        new admissions through the prefill half again.  Requests already in
        the decode half finish there."""
        self.degraded = False
        self.metrics.degraded_events.append((self._tick, "exit"))
        self.tracer.instant("degraded.exit", track="faults", tick=self._tick)
        kp = max(1, self.total_workers // 2)
        self._apply_split(kp)

    # --- handoff ----------------------------------------------------------
    def _drain_prefilled(self) -> int:
        """Extract every slot the prefill pool finished this tick: park its
        pages to host (one O(pages) gather each) and enqueue the payload
        for the decode pool."""
        moved = 0
        for slot in sorted(self.prefill._by_slot):
            req = self.prefill._by_slot[slot]
            with self.tracer.span("handoff.extract", rid=req.rid,
                                  slot=slot):
                req, seq = self.prefill.extract(slot)
            self._handoff.append((req, seq))
            self.metrics.handoffs += 1
            self.metrics.handoff_bytes += seq.nbytes
            self.tracer.count("serve.handoffs")
            self.tracer.count("serve.handoff_bytes", seq.nbytes)
            moved += 1
        return moved

    def _sweep_handoff(self, now: float) -> int:
        """Deadline sweep over the handoff queue: a request can blow its
        deadline while its parked KV sits between the pools (neither
        half's scheduler sees it there, so neither `_shed_expired` can).
        Dropping the pair frees the host payload with it — the decode
        half never adopts the pages of work it would immediately shed."""
        if not self._handoff:
            return 0
        now = float(now)
        keep: Deque[Tuple[Request, ParkedSeq]] = deque()
        shed = 0
        while self._handoff:
            req, seq = self._handoff.popleft()
            if req.deadline is not None \
                    and now - req.arrival_time > req.deadline:
                self.decode._shed(req, now, reason="deadline")
                shed += 1
            else:
                keep.append((req, seq))
        self._handoff = keep
        return shed

    def _inject_ready(self) -> int:
        """Move every queued handoff into the decode pool (adopt + queue);
        the decode scheduler's admission cap then paces the restores, and
        time spent waiting lands in the request's handoff_delay."""
        n = 0
        while self._handoff:
            req, seq = self._handoff.popleft()
            if self._drop_pending > 0:
                # injected transfer loss: the in-flight copy vanishes, but
                # the payload object IS the source pool's parked copy (host
                # memory, self-contained) — it re-sends next tick, so the
                # request is neither lost nor duplicated (exactly-once)
                self._drop_pending -= 1
                self.metrics.handoff_drops += 1
                self.tracer.instant("handoff.drop", track="handoff",
                                    rid=req.rid)
                self.tracer.count("serve.handoff_drops")
                self._handoff_retry.append((req, seq))
                continue
            with self.tracer.span("handoff.inject", rid=req.rid,
                                  nbytes=seq.nbytes):
                self.decode.inject(req, seq)
            n += 1
        return n

    # --- lifecycle facade (cluster job hooks) -----------------------------
    @property
    def suspended(self) -> bool:
        return self.prefill.suspended

    def suspend(self) -> None:
        self.prefill.suspend()
        self.decode.suspend()

    def resume(self) -> None:
        self.prefill.resume()
        self.decode.resume()

    @property
    def n_active_slots(self) -> int:
        return (self.prefill.n_active_slots + self.decode.n_active_slots
                + len(self._handoff))

    def park_excess(self, n: int) -> int:
        """Lease-shrink hook: parks decode-pool slots (prefill slots are
        transient — they drain through the handoff within a tick)."""
        return self.decode.park_excess(n)

    @property
    def drained(self) -> bool:
        p, d = self.prefill, self.decode
        return not (p.scheduler.has_pending or p._by_slot or p._prefilling
                    or p._retrying or self._handoff or self._handoff_retry
                    or d.scheduler.has_pending or d._by_slot
                    or d._prefilling or d._retrying)

    def submit(self, requests: Sequence[Request]) -> None:
        """All requests enter through the prefill pool — unless it lost
        its workers (degraded mode), in which case the decode half serves
        monolithically and admits directly."""
        if self.degraded:
            self.decode.submit(requests)
        else:
            self.prefill.submit(requests)

    def check(self) -> None:
        """Cross-boundary page-leak guard, on top of each half's own
        per-tick invariant checks: after a tick every extracted payload
        must have moved on (nothing parked on the prefill side, no
        request parked on both sides).  Payloads in `_handoff_retry` are
        exempt: an injected handoff_drop parks them for exactly one tick
        before the retry re-send."""
        if self.prefill.mem.n_parked:
            raise PageError("prefill pool retains parked payloads after "
                            "the handoff drain")
        if self._handoff:
            raise PageError("handoff queue not drained within the tick")

    # --- main loop --------------------------------------------------------
    def tick(self) -> None:
        if self.suspended:
            raise RuntimeError("DisaggEngine is suspended; call resume() "
                               "before ticking")
        # fault phase first (fixed order, same contract as ServeEngine)
        if self.fault_injector is not None:
            for ev in self.fault_injector.poll(self._tick):
                self.apply_fault(ev)
        if self._handoff_retry:
            # dropped transfers re-send from the parked copy, ahead of any
            # payload extracted this tick (FCFS preserved)
            self.metrics.handoff_retries += len(self._handoff_retry)
            self.tracer.count("serve.handoff_retries",
                              len(self._handoff_retry))
            self._handoff.extendleft(reversed(self._handoff_retry))
            self._handoff_retry = []
        if not self.degraded:
            self._maybe_rebalance()
        p, d = self.prefill, self.decode
        if p.scheduler.has_pending or p._by_slot or p._prefilling \
                or p._retrying:
            t0 = time.perf_counter()
            p.tick()
            dt = time.perf_counter() - t0
            self._ema_p = dt if self._ema_p == 0 else \
                0.5 * self._ema_p + 0.5 * dt
        if self.overlap:
            # overlapped order: inject LAST tick's drained payloads before
            # the decode tick; THIS tick's finished prefills drain inside
            # the decode tick's prep window (overlap_hook) while its solver
            # step is in flight — they inject after, admitting one decode
            # tick later than the synchronous order (timing-only; the
            # inline drain below is the idempotent safety net for ticks
            # where the decode half doesn't tick at all)
            self._sweep_handoff(self._now())
            self._inject_ready()
            if d.scheduler.has_pending or d._by_slot or d._prefilling \
                    or d._retrying:
                t0 = time.perf_counter()
                d.tick()
                dt = time.perf_counter() - t0
                self._ema_d = dt if self._ema_d == 0 else \
                    0.5 * self._ema_d + 0.5 * dt
            self._drain_prefilled()
            self._sweep_handoff(self._now())
            self._inject_ready()
        else:
            self._drain_prefilled()
            self._sweep_handoff(self._now())
            self._inject_ready()
            if d.scheduler.has_pending or d._by_slot or d._prefilling \
                    or d._retrying:
                t0 = time.perf_counter()
                d.tick()
                dt = time.perf_counter() - t0
                self._ema_d = dt if self._ema_d == 0 else \
                    0.5 * self._ema_d + 0.5 * dt
        if self.debug_checks:
            self.check()
        trc = self.tracer
        if trc.enabled:
            trc.count("serve.disagg_ticks")
            trc.gauge("serve.handoff_queue_depth", len(self._handoff))
            trc.gauge("serve.prefill_workers", self.prefill.k)
            trc.gauge("serve.decode_workers", self.decode.k)
            trc.gauge("serve.prefill_tick_ema_s", self._ema_p)
            trc.gauge("serve.decode_tick_ema_s", self._ema_d)
        self._tick += 1

    def finalize(self, wall_s: float) -> None:
        """Stamp the run's wall time onto the combined and per-pool
        metrics (tokens/s denominators)."""
        self.metrics.wall_s = wall_s
        self.prefill.metrics.wall_s = wall_s
        self.decode.metrics.wall_s = wall_s

    def run(self, requests: Sequence[Request], *,
            max_ticks: int = 100_000) -> DisaggMetrics:
        """Drive the open-loop workload to completion."""
        if self._clock_ext is not None:
            raise ValueError("run() paces on the wall clock; with an "
                             "injected clock drive tick() externally")
        self.submit(requests)
        self._now()  # start the shared clock
        while not self.drained and self._tick < max_ticks:
            busy = (self.prefill._by_slot or self.prefill._prefilling
                    or self.decode._by_slot or self._handoff
                    or self._handoff_retry or self.prefill._retrying
                    or self.decode._retrying)
            if not busy:
                nxts = [t for t in (self.prefill.scheduler.next_arrival(),
                                    self.decode.scheduler.next_arrival())
                        if t is not None]
                if nxts:
                    wait = min(nxts) - self._now()
                    if wait > 0:  # idle until the next open-loop arrival
                        time.sleep(min(wait, 0.05))
            self.tick()
        self.finalize(self._now())
        return self.metrics
