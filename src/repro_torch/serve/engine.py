"""ServeEngine: continuous-batching decode over a slotted KV pool, elastic
across `resize(k)` events (PyTorch).

One engine tick =
  scheduler phase : policies (scale/rebalance/straggler) -> admission ->
                    prefill (whole-prompt bucketed, or page-sized CHUNKS
                    for long prompts) + KV insert
  solver phase    : ONE decode (or speculative verify) step over the whole
                    pool (every active slot advances at its own position;
                    empty slots are inert rows), bracketed by the
                    assignment's begin/end_iteration ownership contract.

The tick runs synchronously by default, or overlapped (below), with the
JAX package's two KV layouts:

- ``flat`` (the default, the reference oracle): one (capacity, cache_len)
  row per slot with a per-row key-position vector.  Admission writes the
  prefilled rows of the admitted slots and decode attends over all
  cache_len positions.
- ``paged``: fixed-size token pages with per-slot block tables
  (`serve.pages.PageAllocator` via `serve.memory.KVMemoryManager`), prefix
  sharing with copy-on-write breaks fused into the decode step, admission
  that writes only the admitted request's pages, decode that reads only
  the pages live in this batch (table width bucketed to a power of two),
  and long prompts prefilled in chunks interleaved with decode.
  `paged_impl="kernel"` (alias "pallas") runs attention through the
  paged-attention kernel, `"gather"` (alias "xla") through a gather and
  plain attention.  With `evict` (on by default on this layout) a
  higher-priority arrival that finds the pool full parks a strictly
  lower-priority decode: its live pages go to host memory in one gather
  and come back through admission in one scatter, with no re-prefill.

With ``spec="ngram"|"draft"`` (see `serve.spec`) the solver phase turns
speculative: every slot proposes up to `spec_k` draft tokens a tick and
ONE (B, Q=spec_k+1) verify dispatch scores them all; the longest matching
draft prefix plus the model's own token is emitted, the same stream as
sequential greedy decode at up to k+1 tokens per dispatch.  Rejected tails
roll back on the host (positions; pages allocated only for rejected drafts
return to the free list).

With ``overlap=True`` the tick is OVERLAPPED: the decode or verify step
of tick t launches first (restores of parked slots bind before it and join
it), and while the device runs it the host does the rest of the tick:
fresh prefills, chunked-prefill chunks and `overlap_hook`.  Then it
blocks once, on a CUDA event recorded behind the step's device-to-host
copy of its tokens into pinned memory.  Every dispatch stays on the
engine's one stream, so prefill writes to the KV pools stay ordered after
the in-flight step's reads; only the order of host work within a tick
moves, and the streams are the synchronous loop's.  Unlike the JAX
engine, the window stages no block table for tick t+1: each launch
builds its table at bind.  The JAX engine stages it because its launch
is one jitted dispatch; an eager launch here issues hundreds of ops, so
a table build of a few slots is no share of it worth a second path.

The KV pools live on `device` (CUDA unless the caller asks for the CPU) and
are updated in place.  `resize(k)` changes the logical worker count on the
one device: the scheduler's slot-chunk assignment and the page-granular
move accounting follow the JAX engine; nothing is re-laid-out.  Every
dispatch's inputs (tokens, positions, block table, lengths, COW pairs)
go to the device as ONE non_blocking copy of a packed int32 staging
tensor (`_MetaPacker`), counted per tick as `meta_transfers`.

Faults and overload control follow the JAX engine.  A `FaultInjector`
is polled at the top of every tick: `crash_worker` drops every slot and
page of the lost worker and restarts its requests from the prompt after a
jittered exponential backoff (greedy re-execution gives the fault-free
stream), or sheds them once their retry budget is spent; `worker_slow`
scales the worker's modeled task time.  Token-bucket and bounded-queue
admission reject with a retry-after hint, an `SLOTracker` scores every
finish, the brownout `DegradationLadder` shrinks then drops speculation,
caps the prefill chunk, parks and sheds, and a `CircuitBreaker` holds
fresh admissions through a crash storm.  With an external `clock` the
engine runs on simulated time (one tick, one second, in the tests).

The engine serves the JAX engine's two families, dense and moe.  A moe
row's output depends on the other rows of its dispatch (expert capacity
drops, `models.moe`), so every byte a dispatch is given for padding rows,
bucket padding and free slots is the JAX engine's.

With ``decode_enabled=False`` (paged layout only) the engine is the
prefill pool of a `serve.disagg.DisaggEngine`: its ticks admit and
prefill, never decode, and prefilled slots wait in `_by_slot` until the
disaggregated engine `extract`s them (park without re-queueing) and the
decode pool `inject`s them (adopt the host payload, queue the request;
admission restores it with one scatter).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..faults import FaultEvent, FaultInjector
from ..models import model as M
from ..obs import MetricsRegistry, NULL_TRACER, SLOTracker, Tracer, meets_slo
from .memory import KVMemoryManager
from .overload import AdmissionController, CircuitBreaker, DegradationLadder
from .pages import PageAllocator, next_pow2
from .request import Request, RequestState
from .scheduler import SlotScheduler
from .spec import DraftModelDrafter, NgramDrafter, greedy_accept


@dataclasses.dataclass
class TickRecord:
    tick: int
    now: float
    n_active: int
    n_workers: int
    occupancy: float
    decode_s: float
    admitted: int
    tokens_emitted: int
    admission_bytes: int = 0  # modeled device bytes written by admission
    prefill_chunks: int = 0  # chunked-prefill chunks advanced this tick
    prefill_dispatches: int = 0  # batched chunk forwards issued this tick
    page_occupancy: float = 0.0  # live fraction of the KV page pool
    spec_drafted: int = 0  # draft tokens proposed this tick
    spec_accepted: int = 0  # draft tokens verification accepted this tick
    draft_dispatches: int = 0  # device dispatches spent DRAFTING this tick
    # KV memory manager (prefix sharing / COW / eviction) deltas this tick
    shared_page_hits: int = 0  # admission pages mapped onto existing pages
    cow_breaks: int = 0  # copy-on-write share breaks fused into dispatches
    parked: int = 0  # slots preempted to host this tick
    restored: int = 0  # parked slots restored this tick
    kv_moved_bytes: int = 0  # park + restore bytes moved (host <-> device)
    shared_extra_pages: int = 0  # pages saved by sharing, end of tick
    # fault/recovery accounting (crash_worker + deadline shedding)
    crashes: int = 0  # worker-crash faults applied this tick
    retries: int = 0  # victim requests re-queued for re-execution this tick
    shed: int = 0  # requests expired this tick (retry budget / deadline)
    brownout_level: int = 0  # degradation-ladder level this tick (0 = full)
    meta_transfers: int = 0  # packed host->device metadata transfers


@dataclasses.dataclass
class ServeMetrics:
    requests: List[Request] = dataclasses.field(default_factory=list)
    ticks: List[TickRecord] = dataclasses.field(default_factory=list)
    scale_events: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)  # (tick, k_before, k_after)
    suspend_events: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)  # (tick, "suspend" | "resume")
    resize_moves: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list)  # (tick, k_after, slots_moved, bytes_moved)
    jit_cache_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    kv_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fault_events: List[Tuple[int, str, Any]] = dataclasses.field(
        default_factory=list)  # (tick, kind, target)
    recovery_events: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)  # (crash_tick, recovery_ticks, n_victims)
    brownout_events: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list)
    breaker_events: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None
    wall_s: float = 0.0

    def to_registry(self, registry: Optional[MetricsRegistry] = None
                    ) -> MetricsRegistry:
        """Re-back the serve telemetry onto an `obs.MetricsRegistry`: every
        quantity `summarize()` reports becomes a typed counter / gauge /
        histogram under ``serve.*``.  `summarize()` itself reads from this
        registry."""
        reg = registry if registry is not None else MetricsRegistry()
        done = [r for r in self.requests if r.state is RequestState.FINISHED]
        reg.gauge("serve.requests_total").set(len(self.requests))
        reg.gauge("serve.requests_finished").set(len(done))
        h_ttft = reg.histogram("serve.ttft_s")
        h_tpot = reg.histogram("serve.tpot_s")
        # queue delay is arrival -> FIRST admission only; park/handoff
        # waits accumulate in the separate handoff-delay histogram
        h_qdel = reg.histogram("serve.queue_delay_s")
        h_hoff = reg.histogram("serve.handoff_delay_s")
        requeued = 0
        for r in done:
            if r.ttft() is not None:
                h_ttft.observe(r.ttft())
            if r.tpot() is not None:
                h_tpot.observe(r.tpot())
            if r.t_admitted is not None:
                h_qdel.observe(r.t_admitted - r.arrival_time)
            if r.handoff_delay > 0:
                h_hoff.observe(r.handoff_delay)
                requeued += 1
        reg.gauge("serve.requeued").set(requeued)
        reg.gauge("serve.requests_rejected").set(
            sum(1 for r in self.requests
                if r.state is RequestState.REJECTED))
        if self.slo_ttft is not None or self.slo_tpot is not None:
            met = sum(1 for r in done if meets_slo(
                r.ttft(), r.tpot(),
                self.slo_ttft if r.slo_ttft is None else r.slo_ttft,
                self.slo_tpot if r.slo_tpot is None else r.slo_tpot))
            reg.gauge("serve.slo_met").set(met)
            reg.gauge("serve.goodput").set(met / len(done) if done else 0.0)
        reg.counter("serve.tokens_generated").inc(
            sum(r.n_generated for r in done))
        per_tick = {
            "serve.tokens_emitted": "tokens_emitted",
            "serve.admission_bytes": "admission_bytes",
            "serve.prefill_chunks": "prefill_chunks",
            "serve.prefill_dispatches": "prefill_dispatches",
            "serve.draft_dispatches": "draft_dispatches",
            "serve.spec_drafted": "spec_drafted",
            "serve.spec_accepted": "spec_accepted",
            "serve.shared_page_hits": "shared_page_hits",
            "serve.cow_breaks": "cow_breaks",
            "serve.parked": "parked",
            "serve.restored": "restored",
            "serve.kv_moved_bytes": "kv_moved_bytes",
            "serve.retries_total": "retries",
            "serve.shed_requests": "shed",
            "serve.crashes": "crashes",
            "serve.meta_transfers": "meta_transfers",
        }
        for metric, field in per_tick.items():
            reg.counter(metric).inc(
                sum(getattr(t, field) for t in self.ticks))
        reg.counter("serve.solver_dispatches").inc(
            sum(1 for t in self.ticks if t.tokens_emitted))
        reg.counter("serve.resize_moved_bytes").inc(
            sum(m[3] for m in self.resize_moves))
        reg.counter("serve.recoveries").inc(len(self.recovery_events))
        h_rec = reg.histogram("serve.recovery_ticks")
        for _, rticks, _ in self.recovery_events:
            h_rec.observe(rticks)
        h_occ = reg.histogram("serve.occupancy")
        h_pocc = reg.histogram("serve.page_occupancy")
        h_shx = reg.histogram("serve.shared_extra_pages")
        h_dec = reg.histogram("serve.decode_s")
        for t in self.ticks:
            h_occ.observe(t.occupancy)
            h_pocc.observe(t.page_occupancy)
            h_shx.observe(t.shared_extra_pages)
            if t.decode_s > 0:
                h_dec.observe(t.decode_s)
        reg.gauge("serve.n_ticks").set(len(self.ticks))
        reg.gauge("serve.wall_s").set(self.wall_s)
        return reg

    def summarize(self) -> Dict[str, Any]:
        reg = self.to_registry()
        cnt = lambda n: int(reg.counter(n).value)  # noqa: E731
        hist = lambda n: reg.histogram(n)  # noqa: E731
        pct = (lambda h, q: float(np.percentile(h.values, q))
               if h.values else None)
        done = int(reg.gauge("serve.requests_finished").value)
        toks = cnt("serve.tokens_generated")
        emitted = cnt("serve.tokens_emitted")
        draft_disp = cnt("serve.draft_dispatches")
        dispatches = cnt("serve.solver_dispatches") + draft_disp
        drafted = cnt("serve.spec_drafted")
        accepted = cnt("serve.spec_accepted")
        mean = lambda n: hist(n).mean or 0.0  # noqa: E731
        return {
            "requests_finished": done,
            "requests_total": int(reg.gauge("serve.requests_total").value),
            "tokens_generated": toks,
            "tokens_per_s": toks / self.wall_s if self.wall_s else 0.0,
            "ttft_p50_s": pct(hist("serve.ttft_s"), 50),
            "ttft_p99_s": pct(hist("serve.ttft_s"), 99),
            "tpot_p50_s": pct(hist("serve.tpot_s"), 50),
            "tpot_p99_s": pct(hist("serve.tpot_s"), 99),
            "queue_delay_p50_s": pct(hist("serve.queue_delay_s"), 50),
            "queue_delay_p99_s": pct(hist("serve.queue_delay_s"), 99),
            "handoff_delay_p50_s": pct(hist("serve.handoff_delay_s"), 50),
            "handoff_delay_p99_s": pct(hist("serve.handoff_delay_s"), 99),
            "requeued_total": int(reg.gauge("serve.requeued").value),
            "occupancy_mean": mean("serve.occupancy"),
            "page_occupancy_mean": mean("serve.page_occupancy"),
            "admission_bytes_total": cnt("serve.admission_bytes"),
            "prefill_chunks_total": cnt("serve.prefill_chunks"),
            "prefill_dispatches_total": cnt("serve.prefill_dispatches"),
            "meta_transfers_total": cnt("serve.meta_transfers"),
            "decode_dispatches": int(dispatches),
            "draft_dispatches": int(draft_disp),
            "tokens_per_dispatch": (emitted / dispatches if dispatches
                                    else 0.0),
            "spec_drafted_total": drafted,
            "spec_accepted_total": accepted,
            "spec_acceptance_rate": (accepted / drafted if drafted else None),
            "shared_page_hits_total": cnt("serve.shared_page_hits"),
            "cow_breaks_total": cnt("serve.cow_breaks"),
            "parked_total": cnt("serve.parked"),
            "restored_total": cnt("serve.restored"),
            "kv_moved_bytes_total": cnt("serve.kv_moved_bytes"),
            "shared_extra_pages_mean": mean("serve.shared_extra_pages"),
            "resize_moved_bytes_total": cnt("serve.resize_moved_bytes"),
            "recoveries": cnt("serve.recoveries"),
            "retries_total": cnt("serve.retries_total"),
            "shed_requests": cnt("serve.shed_requests"),
            "crashes_total": cnt("serve.crashes"),
            "recovery_ticks_mean": hist("serve.recovery_ticks").mean,
            "recovery_events": [list(e) for e in self.recovery_events],
            "rejected_requests": int(
                reg.gauge("serve.requests_rejected").value),
            "slo_ttft_target": self.slo_ttft,
            "slo_tpot_target": self.slo_tpot,
            "slo_met": (int(reg.gauge("serve.slo_met").value)
                        if (self.slo_ttft is not None
                            or self.slo_tpot is not None) else None),
            "goodput": (float(reg.gauge("serve.goodput").value)
                        if (self.slo_ttft is not None
                            or self.slo_tpot is not None) else None),
            "brownout_events": [list(e) for e in self.brownout_events],
            "breaker_events": [list(e) for e in self.breaker_events],
            "brownout_level_max": max(
                (t.brownout_level for t in self.ticks), default=0),
            "kv_stats": dict(self.kv_stats),
            "jit_cache_sizes": dict(self.jit_cache_sizes),
            "n_ticks": len(self.ticks),
            "scale_events": [list(e) for e in self.scale_events],
            "suspend_events": [list(e) for e in self.suspend_events],
            "wall_s": self.wall_s,
        }


class _MetaPacker:
    """Host staging for per-dispatch inputs: every small int input of a
    dispatch (tokens, positions, block tables, lengths, COW pairs, chunk
    offsets, write ids) is copied into ONE contiguous int32 staging
    tensor, pinned on a CUDA engine, and sent as ONE non_blocking
    host->device copy; the step slices its views back out on the device.
    Buffers rotate through a small ring.  A non_blocking copy runs when
    the stream reaches it, which may be long after `pack` returns (behind
    an in-flight step, or a window's prefills), so on a CUDA engine an
    event is recorded behind each buffer's copy and `pack` waits on it
    before it rewrites that buffer: the host never overwrites bytes the
    device has yet to read.  On the CPU the packed tensor is a clone."""

    RING = 8
    __slots__ = ("_bufs", "_events", "_i", "_device", "_cuda")

    def __init__(self, device: torch.device):
        self._device = device
        self._cuda = device.type == "cuda"
        self._bufs = [self._alloc(256) for _ in range(self.RING)]
        # an event not yet recorded synchronizes at once
        self._events = ([torch.cuda.Event() for _ in range(self.RING)]
                        if self._cuda else None)
        self._i = 0

    def _alloc(self, n: int) -> torch.Tensor:
        return torch.empty(n, dtype=torch.int32, pin_memory=self._cuda)

    def pack(self, arrays) -> torch.Tensor:
        total = sum(a.size for a in arrays)
        self._i = (self._i + 1) % self.RING
        if self._cuda:
            self._events[self._i].synchronize()  # its last copy has run
        buf = self._bufs[self._i]
        if buf.numel() < total:
            buf = self._bufs[self._i] = self._alloc(next_pow2(total))
        host = buf.numpy()
        off = 0
        for a in arrays:
            host[off:off + a.size] = np.ravel(a)
            off += a.size
        if not self._cuda:
            return buf[:total].clone()  # the ring buffer is reused
        out = buf[:total].to(self._device, non_blocking=True)
        self._events[self._i].record(torch.cuda.current_stream(self._device))
        return out


def _to_host(t: torch.Tensor):
    """Start the copy of a step's output `t` to the host -> (host tensor,
    event or None).  On a CUDA device the copy goes non_blocking into
    pinned memory and an event is recorded behind it, so waiting for the
    value waits for this step and the work queued before it, never for
    work queued after (a blocking `.cpu()` would also wait for the
    prefills an overlapped tick enqueues after its step).  A CPU tensor
    is its own value."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host_value(host: torch.Tensor, ev) -> np.ndarray:
    """Wait for a `_to_host` copy and read it."""
    if ev is not None:
        ev.synchronize()
    return host.numpy()


# the families the engine serves, as the JAX package's engine: the other
# families' recurrent state and memory stream have no slot/page layout
SUPPORTED_FAMILIES = ("dense", "moe")

# the JAX package's names for the two paged attention implementations
_PAGED_IMPLS = {"kernel": "kernel", "gather": "gather", "pallas": "kernel",
                "xla": "gather"}


class ServeEngine:
    """Continuous-batching serving engine with Chicle-style elasticity
    (flat or paged KV layout, synchronous or overlapped tick).

    Takes every keyword of the JAX package's `ServeEngine`.
    `max_cached_meshes` and `max_cached_fns` size the JAX engine's jit
    caches; eager PyTorch keeps no such cache, so any value is accepted
    and ignored.  A model family the port has no blocks for raises
    NotImplementedError naming its ROADMAP item."""

    def __init__(self, cfg: ModelConfig, *, capacity: int = 8,
                 cache_len: int = 64, prefill_bucket: int = 16,
                 n_workers: int = 1, policies: Sequence = (),
                 slots_per_chunk: int = 2, max_admit_per_tick: int = 4,
                 seed: int = 0, params: Optional[M.Transformer] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 clock: Optional[Any] = None,
                 kv_layout: str = "flat", page_size: int = 8,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 paged_impl: str = "kernel",
                 prefix_share: Optional[bool] = None,
                 evict: Optional[bool] = None,
                 spec: str = "off", spec_k: int = 4,
                 drafter: Optional[Any] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Optional[Any] = None,
                 debug_checks: bool = False,
                 decode_enabled: bool = True,
                 overlap: bool = False,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_backoff: int = 1,
                 retry_jitter: bool = True,
                 slo_ttft: Optional[float] = None,
                 slo_tpot: Optional[float] = None,
                 slo_window: int = 64,
                 tenant_rate: Optional[Any] = None,
                 tenant_burst: Optional[Any] = None,
                 queue_cap: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 brownout: str = "off",
                 ladder: Optional[DegradationLadder] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 tracer: Optional[Tracer] = None,
                 max_cached_meshes: int = 2, max_cached_fns: int = 16,
                 device="cuda"):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine supports flat-KV families "
                f"{SUPPORTED_FAMILIES}; got {cfg.family!r} (recurrent-state "
                f"and cross-attention serving are not in the JAX package's "
                f"engine either)")
        if kv_layout not in ("flat", "paged"):
            raise ValueError(f"kv_layout must be 'flat' or 'paged', "
                             f"got {kv_layout!r}")
        if paged_impl not in _PAGED_IMPLS:
            raise ValueError(f"paged_impl must be 'kernel' or 'gather' "
                             f"(or the JAX names 'pallas', 'xla'), got "
                             f"{paged_impl!r}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 decode slot, "
                             f"got {capacity}")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if cache_len < 1:
            raise ValueError(f"cache_len must be >= 1 token, got {cache_len}")
        if spec not in ("off", "ngram", "draft"):
            raise ValueError(f"spec must be 'off', 'ngram' or 'draft', "
                             f"got {spec!r}")
        if brownout not in ("off", "auto"):
            raise ValueError(f"brownout must be 'off' or 'auto', "
                             f"got {brownout!r}")
        paged = kv_layout == "paged"
        if not paged:
            if prefix_share:
                raise ValueError("prefix_share requires kv_layout='paged' "
                                 "(sharing maps block-table pages)")
            if evict:
                raise ValueError("evict requires kv_layout='paged' "
                                 "(parking moves pages, not rows)")
            if chunked_prefill:
                raise ValueError("chunked_prefill requires kv_layout="
                                 "'paged' (chunks append to pages in place)")
        self.prefill_chunk = prefill_chunk or prefill_bucket
        if paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if cache_len < page_size:
                raise ValueError(
                    f"zero-page budget: cache_len {cache_len} < page_size "
                    f"{page_size} gives every slot 0 KV pages")
            if cache_len % page_size or prefill_bucket % page_size:
                raise ValueError("cache_len and prefill_bucket must be "
                                 "multiples of page_size")
            if self.prefill_chunk % page_size:
                raise ValueError("prefill_chunk must be a multiple of "
                                 "page_size")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine: CUDA is not available; pass device='cpu' to "
                "run the plain versions on the CPU")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cfg = cfg
        self.capacity = capacity
        self.cache_len = cache_len
        self.prefill_bucket = prefill_bucket
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.paged_impl = _PAGED_IMPLS[paged_impl]
        # KV memory manager defaults: on for the paged layout only (sharing
        # and eviction never change token streams, only bytes moved)
        self.prefix_share = (paged if prefix_share is None
                             else bool(prefix_share))
        self.evict = paged if evict is None else bool(evict)
        self.chunked_prefill = (paged if chunked_prefill is None
                                else bool(chunked_prefill))
        # the jittered retry backoff's draws (the JAX engine's generator)
        self.rng = np.random.default_rng(seed)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen, self.device)
        self.params = params.to(self.device)
        # overload control (all off by default, and then the engine is the
        # same as one without these knobs): token-bucket and bounded-queue
        # admission live in the scheduler; the SLO tracker scores finishes;
        # the degradation ladder and the circuit breaker act in tick
        if admission is None and (tenant_rate is not None
                                  or queue_cap is not None):
            admission = AdmissionController(
                tenant_rate=tenant_rate, tenant_burst=tenant_burst,
                queue_cap=queue_cap,
                drain_rate=float(max_admit_per_tick))
        self.slo = (SLOTracker(ttft_target=slo_ttft, tpot_target=slo_tpot,
                               window=slo_window, tracer=self.tracer)
                    if (slo_ttft is not None or slo_tpot is not None)
                    else None)
        self.ladder = (ladder if ladder is not None
                       else DegradationLadder() if brownout == "auto"
                       else None)
        self.breaker = breaker
        self.scheduler = SlotScheduler(
            capacity, n_workers=n_workers, slots_per_chunk=slots_per_chunk,
            policies=policies, max_admit_per_tick=max_admit_per_tick,
            seed=seed, tenant_weights=tenant_weights, admission=admission,
            tracer=self.tracer)
        # external simulation clock; None = wall clock
        self._clock = clock
        self.suspended = False
        self.debug_checks = debug_checks
        # decode_enabled=False makes this a PREFILL-ONLY pool half: the
        # solver phase never runs, and prefilled slots wait in _by_slot
        # until a DisaggEngine extract()s them for the decode pool
        self.decode_enabled = bool(decode_enabled)
        if not self.decode_enabled and not paged:
            raise ValueError("decode_enabled=False (a disagg prefill pool) "
                             "requires kv_layout='paged' — the handoff "
                             "moves pages")

        # speculative decode: each slot proposes spec_k drafts a tick and
        # ONE (B, Q=spec_k+1) verify dispatch scores them all; the drafter
        # never changes the token stream, only the acceptance rate
        self.spec_k = int(spec_k) if (spec != "off" or drafter is not None) \
            else 0
        if self.spec_k <= 0:
            self.drafter = None
            self.spec_k = 0
        elif drafter is not None:
            self.drafter = drafter
        elif spec == "draft":
            if draft_params is None:
                # a random draft model shares nothing with the target: the
                # plumbing runs end to end but acceptance is ~0
                warnings.warn(
                    "spec='draft' without draft_params uses a randomly "
                    "initialized draft model — acceptance will be ~0 and "
                    "speculation slower than spec='off'; pass draft_params "
                    "(a trained/distilled draft model) or use spec='ngram'",
                    stacklevel=2)
                if draft_cfg is None:
                    draft_cfg = dataclasses.replace(
                        cfg, name=cfg.name + "-draft",
                        num_layers=max(1, cfg.num_layers // 2))
            self.drafter = DraftModelDrafter(draft_cfg or cfg, draft_params,
                                             seed=seed, device=self.device)
        else:  # spec == "ngram"
            self.drafter = NgramDrafter()

        self.max_pages_per_slot = cache_len // page_size
        if paged:
            n_pages = capacity * self.max_pages_per_slot + 1  # +1: null page
            self.mem: Optional[KVMemoryManager] = KVMemoryManager(
                n_pages, page_size, prefix_share=self.prefix_share,
                tracer=self.tracer)
            self.pages: Optional[PageAllocator] = self.mem.pages
            self.blocks = M.init_paged_cache(cfg, n_pages, page_size,
                                             self.device)["blocks"]
            self.k_pos = None
        else:
            self.mem = None
            self.pages = None
            cache = M.init_cache(cfg, capacity, cache_len, self.device,
                                 per_slot=True)
            self.blocks = cache["blocks"]
            self.k_pos = cache["k_pos"]
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for t in self.blocks.values())
        # host-side per-slot stream state
        self.next_tok = np.zeros((capacity, 1), np.int32)
        # overlapped tick: launch the decode/verify step first, do the rest
        # of the tick's host work while it runs, block once at the end
        self.overlap = bool(overlap)
        # host work to run INSIDE the overlap window (the disaggregated
        # engine drains its handoffs here)
        self.overlap_hook: Optional[Callable[[], Any]] = None
        self._meta = _MetaPacker(self.device)
        self._tick_meta = 0  # packed metadata transfers this tick
        # rolling KV-stats snapshot: tick deltas are measured against the
        # previous tick's end
        self._kv_prev = self.mem.stats() if self.mem is not None else None
        self._by_slot: Dict[int, Request] = {}
        self._prefilling: Dict[int, Tuple[Request, int]] = {}  # slot->(req,off)
        # fault tolerance: the injector is polled at the top of every tick;
        # crash victims wait on the host in _retrying (ready_tick, req)
        # until their exponential backoff expires, then re-queue
        self.fault_injector = fault_injector
        self.retry_backoff = max(1, int(retry_backoff))
        # jitter spreads one crash's victims over distinct ticks; drawn
        # from the engine rng, so it is deterministic per seed and changes
        # timing only, never a stream
        self.retry_jitter = bool(retry_jitter)
        self._retrying: List[Tuple[int, Request]] = []
        self._slow_factors: Dict[int, float] = {}
        self._recovering: List[Dict[str, Any]] = []
        self._tick_faults = {"crashes": 0, "retries": 0, "shed": 0}
        self.metrics = ServeMetrics()
        self.metrics.slo_ttft = slo_ttft
        self.metrics.slo_tpot = slo_tpot
        # the ladder degrades and restores these; the base values are the
        # level-0 configuration it walks back to
        self._base_spec_k = self.spec_k
        self._base_drafter = self.drafter
        self._base_prefill_chunk = self.prefill_chunk
        self._tick = 0
        self._t0: Optional[float] = None
        self._last_stats: Dict = {}
        self.k = 0
        self.resize(n_workers)

    # --- elasticity -------------------------------------------------------
    @property
    def n_active_slots(self) -> int:
        """Slots currently consuming KV: decoding + mid-prefill."""
        return len(self._by_slot) + len(self._prefilling)

    def _slot_workers(self) -> Tuple[List[int], Dict[int, int]]:
        """Snapshot the live slots and their current worker assignment."""
        live = sorted(set(self._by_slot) | set(self._prefilling))
        return live, {s: self.scheduler.worker_of_slot(s) for s in live}

    def _record_resize_moves(self, k: int, live: List[int],
                             before: Dict[int, int]) -> None:
        """Page-granular migration accounting for one scale event: only the
        pages of slots whose worker changed count as moved state."""
        moved = [s for s in live
                 if self.scheduler.worker_of_slot(s) != before[s]]
        if self.pages is not None:
            nbytes = sum(self.pages.n_pages_of(s) for s in moved) \
                * self._page_bytes
        else:  # flat rows: a moved slot drags its whole cache row
            nbytes = len(moved) * (self._pool_bytes // self.capacity)
        self.metrics.resize_moves.append(
            (self._tick, k, len(moved), int(nbytes)))

    def resize(self, k: int) -> None:
        """Elastic scale event: k logical workers on the engine's device.
        KV state and in-flight requests carry over untouched; the slot-chunk
        assignment rebalances with minimal churn and the pages of slots
        whose worker changed are recorded as moved state
        (`metrics.resize_moves`), the cost a per-worker page pool would
        pay.  Speculation state follows the pool (`drafter.on_resize`)."""
        if k < 1:
            raise ValueError(
                f"resize(k) needs at least one worker, got k={k}")
        if self.scheduler.n_workers != k:
            live, before = self._slot_workers()
            self.scheduler.set_workers(k)
            self._record_resize_moves(k, live, before)
        if self.drafter is not None:
            self.drafter.on_resize(self.device)
        self.k = k

    # --- device steps -----------------------------------------------------
    @property
    def _page_bytes(self) -> int:
        """Device bytes of one K+V page across the block stack."""
        leaf = self.blocks["k"]  # (nb, N, ps, kv, hd)
        nb, _, ps, kv, hd = leaf.shape
        return 2 * nb * ps * kv * hd * leaf.element_size()

    def _pack_meta(self, *arrays) -> torch.Tensor:
        """ONE host->device transfer for a dispatch's metadata inputs
        (counted per tick as `meta_transfers`)."""
        self._tick_meta += 1
        return self._meta.pack(arrays)

    def _prefill_step(self, tokens: torch.Tensor, true_len: torch.Tensor):
        """Whole-prompt prefill of right-padded rows (device tensors, cut
        from a packed transfer) -> (first tokens, cache): rows (nb, n, L,
        KV, hd) at L = the bucket length (paged: the insert chops them
        into pages) or cache_len (flat), and their per-row k_pos."""
        logits, cache = M.prefill(
            self.cfg, self.params, tokens,
            cache_len=(tokens.shape[1] if self.pages is not None
                       else self.cache_len), true_len=true_len)
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    def _insert_rows(self, slots: torch.Tensor, cache: Dict[str, Any]
                     ) -> None:
        """Flat admission: write the prefilled rows and their k_pos rows
        into the pool at `slots`, in place."""
        idx = slots.long()
        for name, rows in cache["blocks"].items():
            self.blocks[name][:, idx] = rows
        self.k_pos[idx] = cache["k_pos"]

    def _insert(self, rows_k: torch.Tensor, rows_v: torch.Tensor,
                page_ids: torch.Tensor) -> None:
        """Paged admission scatter: chop the prefilled rows into pages and
        write ONLY those pages into the pools, in place.  Ids of 0 route
        shared and padding pages to the null page."""
        ps = self.page_size
        ids = page_ids.long()
        for name, rows in (("k", rows_k), ("v", rows_v)):
            nb, n, bucket = rows.shape[:3]
            self.blocks[name][:, ids] = rows.reshape(
                nb, n * (bucket // ps), ps, *rows.shape[3:])

    def _chunk_step(self, meta: torch.Tensor, nb: int, C: int
                    ) -> torch.Tensor:
        """One batched chunk forward from packed metadata: offsets, chunk
        ends, the (nb, C) tokens, then the block table -> the last
        token's greedy next token per row."""
        offset = meta[:nb]
        chunk_end = meta[nb: 2 * nb]
        tokens = meta[2 * nb: nb * (2 + C)].reshape(nb, C)
        table = meta[nb * (2 + C):].reshape(nb, -1)
        last, _ = M.paged_prefill_chunk(
            self.cfg, self.params, {"blocks": self.blocks}, tokens, offset,
            chunk_end, table, impl=self.paged_impl)
        return last[:, -1].argmax(-1).to(torch.int32)

    def _unpack_paged(self, meta: torch.Tensor, q: int):
        """(tokens (cap, q), pos, table, lengths, cow) from a paged step's
        packed metadata: tokens, pos, table, lengths, cow_src, cow_dst."""
        cap = self.capacity
        w = meta.shape[0] // cap - q - 4  # table width
        tok = meta[:cap * q].reshape(cap, q)
        pos = meta[cap * q: cap * (q + 1)]
        table = meta[cap * (q + 1): cap * (q + 1 + w)].reshape(cap, w)
        lengths = meta[cap * (q + 1 + w): cap * (q + 2 + w)]
        cow_src = meta[cap * (q + 2 + w): cap * (q + 3 + w)]
        cow_dst = meta[cap * (q + 3 + w):]
        # without prefix sharing no page can reach refcount 2: skip the copy
        cow = (cow_src, cow_dst) if self.prefix_share else None
        return tok, pos, table, lengths, cow

    def _flat_cache(self) -> Dict[str, Any]:
        return {"blocks": self.blocks, "k_pos": self.k_pos}

    def _decode_step(self, meta: torch.Tensor) -> torch.Tensor:
        """One decode step from packed metadata -> next tokens (cap,)."""
        if self.pages is None:
            cap = self.capacity
            logits, _ = M.decode_step(self.cfg, self.params,
                                      self._flat_cache(),
                                      meta[:cap].reshape(cap, 1), meta[cap:])
        else:
            tok, pos, table, lengths, cow = self._unpack_paged(meta, 1)
            logits, _ = M.paged_decode_step(
                self.cfg, self.params, {"blocks": self.blocks}, tok, pos,
                table, lengths, impl=self.paged_impl, cow=cow)
        return logits[:, -1].argmax(-1).to(torch.int32)

    def _verify_step(self, meta: torch.Tensor, q: int) -> torch.Tensor:
        """One verify step over spans of q tokens from packed metadata ->
        the model's greedy token at every span position (cap, q)."""
        if self.pages is None:
            cap = self.capacity
            logits, _ = M.verify_step(
                self.cfg, self.params, self._flat_cache(),
                meta[:cap * q].reshape(cap, q),
                meta[cap * q: cap * (q + 1)], meta[cap * (q + 1):])
        else:
            tok, pos, table, lengths, cow = self._unpack_paged(meta, q)
            logits, _ = M.paged_verify_step(
                self.cfg, self.params, {"blocks": self.blocks}, tok, pos,
                table, lengths, impl=self.paged_impl, cow=cow)
        return logits.argmax(-1).to(torch.int32)

    def _drain(self) -> None:
        """Wait for all the work queued on the engine's stream so far."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()

    # --- prefill ----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket
        return min(((n + b - 1) // b) * b, self.cache_len)

    def _page_bucket(self, n_pages: int) -> int:
        """Block-table width bucket: next power of two."""
        return min(next_pow2(max(n_pages, 1)), self.max_pages_per_slot)

    def _n_bucket(self, n: int) -> int:
        """Batch-size bucket for grouped chunk forwards: next power of two
        (capped at capacity)."""
        return min(next_pow2(max(n, 1)), self.capacity)

    def _release(self, req: Request, now: float) -> None:
        """Finish a request: return its pages (paged) and its slot."""
        if self.mem is not None and req.slot is not None:
            self.mem.release_slot(req.slot)
        self.scheduler.release(req, now)
        if self.slo is not None:
            # score the finish against its targets (per-request overrides
            # win); the tracker traces slo.miss and feeds the ladder
            self.slo.observe(rid=req.rid, tenant=req.tenant,
                             ttft=req.ttft(), tpot=req.tpot(),
                             ttft_target=req.slo_ttft,
                             tpot_target=req.slo_tpot)

    # --- eviction: park / restore (page-granular preemption) --------------
    def park(self, slot: int, *, requeue: bool = True) -> int:
        """Preempt the decoding request in `slot`: gather ONLY its live
        pages to host memory (one O(pages) device->host copy, no re-prefill
        on return), free its pages and slot, and re-queue the request
        (state PARKED) for a later restore through admission.
        requeue=False leaves the request out of the queue: the disagg
        handoff (`extract`) moves it to another engine instead.  Returns
        the bytes moved."""
        if self.mem is None:
            raise RuntimeError("park requires kv_layout='paged'")
        req = self._by_slot.pop(slot, None)
        if req is None:
            raise KeyError(f"slot {slot} has no decoding request")
        with self.tracer.span("park", rid=req.rid, slot=slot):
            idx = torch.as_tensor(self.pages.table(slot), dtype=torch.long,
                                  device=self.device)
            # host copies stay torch tensors: numpy has no bfloat16
            host = {name: arr[:, idx].cpu()
                    for name, arr in self.blocks.items()}
            seq = self.mem.park(req.rid, slot, host,
                                int(self.scheduler.pool.pos[slot]),
                                int(self.next_tok[slot, 0]),
                                prompt=req.prompt)
            self.scheduler.pool.free(slot)
            req.slot = None
            req.state = RequestState.PARKED
            req.t_parked = self._now()  # handoff-delay clock starts
            if requeue:
                self.scheduler.submit(req)  # rejoins its tenant queue
        return seq.nbytes

    def extract(self, slot: int) -> Tuple[Request, Any]:
        """Disaggregation handoff, prefill side: park `slot`'s request
        WITHOUT re-queueing it and pop the parked payload.  The caller
        moves (request, ParkedSeq) to the decode pool's `inject`."""
        req = self._by_slot[slot]
        self.park(slot, requeue=False)
        return req, self.mem.take_parked(req.rid)

    def inject(self, req: Request, seq: Any) -> None:
        """Disaggregation handoff, decode side: adopt a foreign parked
        sequence (another engine's `extract`) and queue its request; the
        next admission restores it through the parked-restore path (one
        scatter, no re-prefill, the same stream)."""
        if self.mem is None:
            raise RuntimeError("inject requires kv_layout='paged'")
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new_tokens} exceeds cache_len {self.cache_len}")
        self.mem.adopt(seq)
        self.scheduler.submit(req)
        self.metrics.requests.append(req)

    def park_excess(self, n: int) -> int:
        """Park up to `n` decoding slots, lowest priority first (latest
        admitted within a priority) — the cluster lease-shrink hook.
        Returns total bytes moved to host."""
        moved = 0
        for _ in range(max(0, n)):
            victim = self._pick_victim()
            if victim is None:
                break
            moved += self.park(victim)
        return moved

    def _pick_victim(self) -> Optional[int]:
        """Lowest-priority, most-recently-admitted decoding slot."""
        cands = [(req.priority, -(req.t_admitted or 0.0), slot)
                 for slot, req in self._by_slot.items()]
        return min(cands)[2] if cands else None

    def _preempt_for(self, incoming: Request) -> bool:
        """Scheduler hook: admit `incoming` over a STRICTLY lower-priority
        in-flight decode by parking the victim (KV to host, no work lost).
        Returns True when a slot was freed."""
        victim = self._pick_victim()
        if victim is None \
                or self._by_slot[victim].priority >= incoming.priority:
            return False
        self.park(victim)
        return True

    def _restore_slot(self, req: Request) -> int:
        """Re-admit a parked request: pages re-matched against the prefix
        index where possible, ONE scatter of the unshared payload, decode
        state restored — the stream continues bit for bit with zero prefill
        compute.  Returns bytes moved."""
        with self.tracer.span("restore", rid=req.rid, slot=req.slot):
            plan = self.mem.restore(req.rid, req.slot)
            seq = plan.seq
            # re-shared pages carry write id 0: their rows land in the null
            # page and nothing live is overwritten (AdmitPlan's trick)
            ids = self._pack_meta(np.asarray(plan.write_ids,
                                             np.int32)).long()
            for name, rows in seq.pages.items():
                self.blocks[name][:, ids] = rows.to(self.device)
            req.state = RequestState.DECODING
            self.next_tok[req.slot, 0] = seq.next_tok
            self.scheduler.pool.pos[req.slot] = seq.live_tokens
            self._by_slot[req.slot] = req
        return plan.moved_bytes

    # --- fault injection + crash recovery ---------------------------------
    def _backoff_ticks(self, retries: int) -> int:
        """Exponential crash-retry backoff, jittered by uniform(0.5, 1.5)
        from the engine rng: one crash's victims spread their re-admission
        over distinct ticks instead of stampeding back as one cohort.
        Deterministic per seed; at least one tick either way."""
        base = self.retry_backoff * (1 << (retries - 1))
        if self.retry_jitter:
            return max(1, int(round(base * float(self.rng.uniform(0.5,
                                                                  1.5)))))
        return base

    def apply_fault(self, ev: FaultEvent) -> None:
        """Route one injected fault.  Serve-level kinds only: revoke_lease
        (cluster scope) and handoff_drop (disagg scope) are ignored here,
        so one FaultPlan can span every layer."""
        if ev.kind == "worker_crash":
            self.crash_worker(ev.target if ev.target is None
                              else int(ev.target))
        elif ev.kind == "worker_slow":
            w = self.k - 1 if ev.target is None else int(ev.target)
            self.set_worker_slow(w, ev.factor)

    def set_worker_slow(self, worker: int, factor: float) -> None:
        """Straggler injection: `worker`'s modeled task time scales by
        `factor` until cleared with factor 1.0; feeds the same per-worker
        timing stats `StragglerMitigationPolicy` watches."""
        if factor == 1.0:
            self._slow_factors.pop(worker, None)
        else:
            self._slow_factors[worker] = float(factor)
        self.metrics.fault_events.append((self._tick, "worker_slow", worker))

    def crash_worker(self, worker: Optional[int] = None) -> List[Request]:
        """Abrupt loss of one logical worker (default: the highest-id live
        worker): every slot and KV page on it is gone.  Its requests,
        mid-prefill and mid-decode alike, restart from the prompt (greedy
        decode re-executes the fault-free stream) through RETRYING with
        exponential backoff, or are shed to EXPIRED once their retry budget
        is spent.  The pool shrinks to the survivors through `resize` (a
        k=1 crash cold-starts a replacement worker).  Returns the
        victims."""
        sched = self.scheduler
        if worker is None:
            worker = sched.n_workers - 1
        if not 0 <= worker < sched.n_workers:
            raise ValueError(f"crash_worker: worker {worker} not in live "
                             f"set 0..{sched.n_workers - 1}")
        now = self._now()
        self.metrics.fault_events.append((self._tick, "worker_crash", worker))
        self._tick_faults["crashes"] += 1
        with self.tracer.span("recovery.crash", track="faults",
                              worker=worker):
            victims: List[Request] = []
            for slot in sched.slots_of_worker(worker):
                req = self._by_slot.pop(slot, None)
                if req is None:
                    ent = self._prefilling.pop(slot, None)
                    req = ent[0] if ent is not None else None
                if req is None:
                    continue
                # the dead worker's pages are unreachable: free them and
                # drop the prefix-index entries that pointed at them
                # (host-parked payloads are copies and survive)
                if self.mem is not None:
                    self.mem.release_slot(slot)
                sched.pool.free(slot)
                req.slot = None
                victims.append(req)
            for req in victims:
                req.generated = []
                req.t_first_token = None
                req.retries += 1
                if req.retries > req.max_retries:
                    self._shed(req, now, reason="retries")
                else:
                    req.state = RequestState.RETRYING
                    ready = self._tick + self._backoff_ticks(req.retries)
                    self._retrying.append((ready, req))
                    self._tick_faults["retries"] += 1
                    self.tracer.count("serve.retries_total")
            if victims:
                self._recovering.append(
                    {"tick": self._tick, "n": len(victims),
                     "pending": {r.rid: r for r in victims}})
            self.resize(max(1, self.k - 1))
            # logical workers renumber on shrink: factors past the new k
            # die with their worker ids
            self._slow_factors = {w: f for w, f in self._slow_factors.items()
                                  if w < self.k}
        return victims

    def _shed(self, req: Request, now: float, *, reason: str) -> None:
        """Terminal load shed: EXPIRED, never re-queued.  A parked host
        payload is dropped, a held slot and its pages released."""
        if self.mem is not None and self.mem.has_parked(req.rid):
            self.mem.take_parked(req.rid)
        if req.slot is not None:
            if self.mem is not None:
                self.mem.release_slot(req.slot)
            self.scheduler.pool.free(req.slot)
            req.slot = None
        req.state = RequestState.EXPIRED
        req.t_finished = now
        self._tick_faults["shed"] += 1
        self.tracer.instant("shed", track="faults", rid=req.rid,
                            reason=reason)
        self.tracer.count("serve.shed_requests")

    def _requeue_retries(self) -> None:
        """Move backoff-expired crash victims back into the admission
        queue; their original arrival time keeps them near the front of
        their tenant's queue."""
        due = [ent for ent in self._retrying if ent[0] <= self._tick]
        if not due:
            return
        self._retrying = [ent for ent in self._retrying
                          if ent[0] > self._tick]
        with self.tracer.span("recovery.requeue", track="faults",
                              n=len(due)):
            for _, req in due:
                req.state = RequestState.QUEUED
                self.scheduler.submit(req)

    def _shed_expired(self, now: float) -> None:
        """Deadline shedding: queued or retrying requests past their
        deadline are EXPIRED instead of (re-)admitted.  In-flight decodes
        run to completion; admission is the shedding point."""
        for req in self.scheduler.shed_expired(now):
            self._shed(req, now, reason="deadline")
        keep: List[Tuple[int, Request]] = []
        for rdy, req in self._retrying:
            if req.deadline is not None \
                    and now - req.arrival_time > req.deadline:
                self._shed(req, now, reason="deadline")
            else:
                keep.append((rdy, req))
        self._retrying = keep

    # --- graceful degradation (brownout ladder) ---------------------------
    def _apply_degradation(self, level: int) -> None:
        """Reconfigure for a ladder level, as a function of (base
        configuration, level) alone, so walking back down restores level 0
        exactly.  Every action trades quality (latency, batching), never
        content: greedy decode at any level gives the streams of an engine
        configured that way from the start."""
        k = self._base_spec_k
        drafter = self._base_drafter
        chunk = self._base_prefill_chunk
        if level >= 1:  # spec_shrink: halve the draft depth
            k = max(1, k // 2) if k else 0
        if level >= 2:  # spec_off: no speculative drafting at all
            drafter = None
        if level >= 3 and self.chunked_prefill:
            chunk = self.page_size  # chunk_cap: the narrowest legal chunk
        restored = drafter is not None and self.drafter is None
        self.drafter = drafter
        self.spec_k = k if drafter is not None else 0
        self.prefill_chunk = chunk
        if restored:
            # resize() skips a detached drafter: follow the pool's device
            # on the way back up
            drafter.on_resize(self.device)

    def _brownout_actions(self, now: float) -> None:
        """Per-tick work of the ladder's top levels (the lower levels are
        reconfiguration, applied once per transition)."""
        lvl = self.ladder.level
        sched = self.scheduler
        if lvl >= 4 and self.mem is not None and self.evict:
            # park_low: free a slot for a strictly higher-priority waiter
            # before the pool is full (admission's preempt hook waits for a
            # full pool)
            heads = [q[0] for q in sched._queues.values()
                     if q and q[0].arrival_time <= now]
            if heads:
                top = max(h.priority for h in heads)
                victim = self._pick_victim()
                if victim is not None \
                        and self._by_slot[victim].priority < top:
                    self.park(victim)
                    self.tracer.instant("degrade.park", track="overload",
                                        slot=victim)
        if lvl >= 5 and self.slo is not None \
                and self.slo.ttft_target is not None:
            # shed_late: a queued request already past its TTFT target is a
            # certain miss; shed it.  Parked and retrying work is exempt (it
            # holds restorable state)
            late = sched.pop_older_than(
                now, self.slo.ttft_target,
                pred=lambda r: (r.state is RequestState.QUEUED
                                and r.retries == 0))
            for r in late:
                self._shed(r, now, reason="brownout")

    def _settle_recoveries(self) -> None:
        """Close recovery windows: a crash's victims are recovered when
        each has emitted its first token again or been shed; the window's
        tick count is the recovery latency."""
        still: List[Dict[str, Any]] = []
        for rec in self._recovering:
            rec["pending"] = {
                rid: r for rid, r in rec["pending"].items()
                if not (r.state is RequestState.EXPIRED
                        or (r.n_generated > 0
                            and r.state in (RequestState.DECODING,
                                            RequestState.FINISHED)))}
            if rec["pending"]:
                still.append(rec)
            else:
                rticks = self._tick - rec["tick"]
                self.metrics.recovery_events.append(
                    (rec["tick"], rticks, rec["n"]))
                self.tracer.instant("recovery.done", track="faults",
                                    crash_tick=rec["tick"], ticks=rticks)
        self._recovering = still

    def _start_decoding(self, req: Request, nxt: int, now: float) -> None:
        """PREFILL -> DECODING (or immediate finish) once the first token
        exists."""
        req.generated.append(nxt)
        req.t_first_token = now
        if req.done():  # max_new_tokens == 1: prefill's token ends it
            self._release(req, now)
            return
        req.state = RequestState.DECODING
        self.next_tok[req.slot, 0] = nxt
        self.scheduler.pool.pos[req.slot] = req.prompt_len
        self._by_slot[req.slot] = req

    def _do_prefill(self, admitted: Sequence[Request],
                    defer: Optional[List] = None) -> int:
        """Prefill this tick's admissions, one batched forward per shared
        bucket length, and insert their KV into the pool.  PARKED requests
        restore their host-parked pages instead (no model forward at all);
        fresh admissions map their longest indexed prompt prefix onto
        existing physical pages and write only the rest.  Long prompts defer
        to `_advance_prefills`.  Returns modeled admission bytes written to
        the device KV pool.

        With `defer` (the overlapped tick's prep window) each group's first
        tokens are only copied towards the host, and (host tensor, [(row,
        request), ...]) goes onto `defer` for `_settle_prefills` to finish
        after the window closes."""
        direct: List[Request] = []
        nbytes = 0
        for r in admitted:
            if self.mem is not None and self.mem.has_parked(r.rid):
                nbytes += self._restore_slot(r)
            # submit() already rejected prompt+max_new > cache_len, so the
            # chunked table can never outgrow max_pages_per_slot
            elif self.chunked_prefill and r.prompt_len > self.prefill_chunk:
                with self.tracer.span("prefix_index", rid=r.rid):
                    off = self.mem.admit_chunked(r.slot, r.prompt)
                self._prefilling[r.slot] = (r, off)
            else:
                direct.append(r)
        groups: Dict[int, List[Request]] = {}
        for r in direct:
            groups.setdefault(self._bucket(r.prompt_len), []).append(r)
        trc = self.tracer
        for bucket, group in sorted(groups.items()):
            n = len(group)
            toks = np.zeros((n, bucket), np.int32)
            lens = np.zeros(n, np.int32)
            for i, r in enumerate(group):
                toks[i, : r.prompt_len] = r.prompt
                lens[i] = r.prompt_len
            if self.pages is None:
                with trc.span("prefill.dispatch", bucket=bucket, n=n):
                    # one transfer: the lengths, the admitted slots, then
                    # the tokens
                    meta = self._pack_meta(
                        lens, np.asarray([r.slot for r in group], np.int32),
                        toks)
                    nxt, cache = self._prefill_step(
                        meta[2 * n:].reshape(n, bucket), meta[:n])
                    self._insert_rows(meta[n: 2 * n], cache)
                # the JAX engine's counter: its at[].set rebuilds the whole
                # pool (here only the admitted rows are written)
                nbytes += self._pool_bytes
            else:
                with trc.span("prefill.dispatch", bucket=bucket, n=n):
                    meta = self._pack_meta(lens, toks)
                    nxt, cache = self._prefill_step(
                        meta[n:].reshape(n, bucket), meta[:n])
                bpp = bucket // self.page_size
                page_ids = np.zeros(n * bpp, np.int32)  # 0 -> null page
                real = 0
                with trc.span("prefix_index", n=n):
                    for i, r in enumerate(group):
                        # shared prefix pages keep id 0 in write_ids:
                        # nothing is written, the block table points at
                        # the existing pages
                        plan = self.mem.admit_slot(r.slot, r.prompt)
                        page_ids[i * bpp: i * bpp + len(plan.write_ids)] = \
                            plan.write_ids
                        real += len(plan.table) - plan.shared_pages
                with trc.span("prefill.insert", track="prefill"):
                    self._insert(cache["blocks"]["k"], cache["blocks"]["v"],
                                 self._pack_meta(page_ids))
                nbytes += real * self._page_bytes
            # the copy is queued behind the insert, so its event covers both
            host, ev = _to_host(nxt)
            if defer is not None:
                defer.append((host, list(enumerate(group))))
                continue
            # settle at prefill's own sync point, so prefill device time
            # lands on the prefill track, not in the next decode's wait
            with trc.span("prefill.device_wait", cat="device",
                          track="prefill"):
                nxt_np = _host_value(host, ev)
            now = self._now()
            for i, r in enumerate(group):
                self._start_decoding(r, int(nxt_np[i]), now)
        return nbytes

    def _advance_prefills(self, defer: Optional[List] = None
                          ) -> Tuple[int, int, int]:
        """Advance every mid-prefill request by ONE page-aligned chunk.
        Slots sharing a table-width bucket are BATCHED into one forward,
        padded to a power-of-two batch bucket (rows with chunk_end 0 are
        inert: their writes route to the null page).  With `defer` (the
        overlap window) the completing slots' settles go onto it as (host
        tensor, [(row, request), ...]) for `_settle_prefills` instead of
        blocking here.
        Returns (chunks processed, modeled KV bytes written, dispatches)."""
        nbytes = 0
        tok_bytes = self._page_bytes // self.page_size
        C = self.prefill_chunk
        plan: List[Tuple[int, Request, int, int]] = []
        for slot in sorted(self._prefilling):
            req, off = self._prefilling[slot]
            end = off + min(C, req.prompt_len - off)
            self.pages.ensure(slot, end)
            nbytes += (end - off) * tok_bytes
            plan.append((slot, req, off, end))
        groups: Dict[int, List[Tuple[int, Request, int, int]]] = {}
        for item in plan:
            width = self._page_bucket(self.pages.n_pages_of(item[0]))
            groups.setdefault(width, []).append(item)
        n_chunks = 0
        n_dispatch = 0
        finished: List[int] = []
        for width, group in sorted(groups.items()):
            n = len(group)
            nb = self._n_bucket(n)
            toks = np.zeros((nb, C), np.int32)
            offs = np.zeros(nb, np.int32)
            ends = np.zeros(nb, np.int32)  # 0 marks an inert pad row
            tbl = np.full((nb, width), -1, np.int32)
            full = self.pages.table_array(self.capacity, width,
                                          only=[s for s, *_ in group])
            for i, (slot, req, off, end) in enumerate(group):
                toks[i, : end - off] = req.prompt[off:end]
                offs[i], ends[i] = off, end
                tbl[i] = full[slot]
            with self.tracer.span("prefill.chunk", width=width, n=n):
                nxt = self._chunk_step(
                    self._pack_meta(offs, ends, toks, tbl), nb, C)
            n_chunks += n
            n_dispatch += 1
            nxt_np: Optional[np.ndarray] = None
            done_group: List[Tuple[int, Request]] = []
            for i, (slot, req, off, end) in enumerate(group):
                # index the pages this chunk just WROTE (never ahead of the
                # writes, so a sharer can only ever map written pages)
                self.mem.register_prefix(slot, req.prompt, upto=end)
                if end >= req.prompt_len:
                    finished.append(slot)
                    if defer is not None:
                        done_group.append((i, req))
                        continue
                    if nxt_np is None:
                        with self.tracer.span("prefill.device_wait",
                                              cat="device", track="prefill"):
                            nxt_np = _host_value(*_to_host(nxt))
                    self._start_decoding(req, int(nxt_np[i]), self._now())
                else:
                    self._prefilling[slot] = (req, end)
            if done_group:
                defer.append((_to_host(nxt)[0], done_group))
        for slot in finished:
            del self._prefilling[slot]
        return n_chunks, nbytes, n_dispatch

    # --- suspend / resume (cluster scale-to-zero) -------------------------
    def suspend(self) -> None:
        """Scale-to-zero: stop ticking; the KV pool, the queues and every
        in-flight request stay as they are, so resume continues the same
        token streams."""
        if not self.suspended:
            self.suspended = True
            self.metrics.suspend_events.append((self._tick, "suspend"))

    def resume(self) -> None:
        if self.suspended:
            self.suspended = False
            self.metrics.suspend_events.append((self._tick, "resume"))

    # --- defrag -----------------------------------------------------------
    def defrag(self) -> bool:
        """Compact live pages to the low physical ids: one gather of every
        KV leaf along its page axis (axis 1 of (nb, N, ps, kv, hd)), on the
        leaf's device; the block tables and the prefix index are remapped
        and token streams are unchanged.  Returns True if pages moved.
        Call it between ticks."""
        if self.mem is None:
            return False
        src = self.mem.defrag()  # also remaps the prefix index
        if src is None:
            return False
        idx = torch.from_numpy(src).long()
        for name, leaf in self.blocks.items():
            self.blocks[name] = leaf.index_select(1, idx.to(leaf.device))
        return True

    # --- main loop --------------------------------------------------------
    def _now(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def submit(self, requests: Sequence[Request]) -> None:
        for r in sorted(requests, key=lambda r: r.arrival_time):
            # reject up front: a mid-run failure would abort in-flight
            # requests and leak the already-allocated slot
            if r.prompt_len + r.max_new_tokens > self.cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + max_new "
                    f"{r.max_new_tokens} exceeds cache_len {self.cache_len}")
            ok, verdict = self.scheduler.try_submit(r)
            if not ok:
                # backpressure: terminal REJECTED with a retry-after hint,
                # never queued, counted apart from sheds
                r.state = RequestState.REJECTED
                r.retry_after = verdict.retry_after
                r.t_finished = r.arrival_time
                self.tracer.instant("admission.reject", track="overload",
                                    rid=r.rid, tenant=r.tenant,
                                    reason=verdict.reason,
                                    retry_after=verdict.retry_after)
                self.tracer.count("serve.rejected")
            self.metrics.requests.append(r)

    def _paged_batch_inputs(self, active: List[int], n_new: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
        """Grow each active slot's block table to cover its `n_new[slot]`
        pending writes and build the width-bucketed (table, lengths,
        cow_src, cow_dst) dispatch inputs.  A slot whose first write lands
        in a SHARED page breaks the share here (fresh private page in the
        table) and carries the (old, new) pair so the dispatch copies the
        payload in place; rows without a break copy the null page onto
        itself."""
        with self.tracer.span("cow_plan", n=len(active)):
            pos = self.scheduler.pool.pos
            cow_src = np.zeros(self.capacity, np.int32)
            cow_dst = np.zeros(self.capacity, np.int32)
            for slot in active:
                plan = self.mem.cow_plan(slot, int(pos[slot]))
                if plan is not None:
                    cow_src[slot], cow_dst[slot] = plan
                self.pages.ensure(slot, int(pos[slot]) + int(n_new[slot]))
            width = self._page_bucket(
                max(self.pages.n_pages_of(s) for s in active))
            table = self.pages.table_array(self.capacity, width,
                                           only=active)
            lengths = np.zeros(self.capacity, np.int32)
            for slot in active:
                lengths[slot] = pos[slot] + n_new[slot]
            return table, lengths, cow_src, cow_dst

    def _decode_launch(self, active: List[int]
                       ) -> Callable[[], Tuple[int, float, int, int, int]]:
        """Launch one plain greedy decode step over the pool and return its
        SETTLE closure: COW/table planning + ONE packed metadata transfer +
        the dispatch and its tokens' copy to the host here; the closure
        waits for them, emits and releases finished requests, and returns
        (tokens emitted, step seconds, 0, 0, 0)."""
        sched = self.scheduler
        pos_np = sched.pool.pos
        # t0 BEFORE the COW/table planning: decode_s is plan + dispatch +
        # device completion, as in the JAX engine
        t0 = time.perf_counter()
        with self.tracer.span("decode.dispatch", n=len(active)):
            pos = np.asarray(pos_np, np.int32)
            if self.pages is None:
                nxt = self._decode_step(self._pack_meta(self.next_tok, pos))
            else:
                table, lengths, cow_src, cow_dst = self._paged_batch_inputs(
                    active, np.ones(self.capacity, np.int32))
                nxt = self._decode_step(self._pack_meta(
                    self.next_tok, pos, table, lengths, cow_src, cow_dst))
            fetch = _to_host(nxt)

        def settle() -> Tuple[int, float, int, int, int]:
            with self.tracer.span("device_wait", cat="device",
                                  track="decode"):
                nxt_np = _host_value(*fetch)
            t_step = time.perf_counter() - t0
            sched.end_iteration()
            now = self._now()
            emitted = 0
            for slot in active:
                req = self._by_slot[slot]
                req.generated.append(int(nxt_np[slot]))
                self.next_tok[slot, 0] = int(nxt_np[slot])
                sched.pool.pos[slot] += 1
                emitted += 1
                if req.done():
                    del self._by_slot[slot]
                    self._release(req, now)
            return emitted, t_step, 0, 0, 0

        return settle

    def _spec_launch(self, active: List[int]
                     ) -> Callable[[], Tuple[int, float, int, int, int]]:
        """Launch one speculative solver phase and return its SETTLE
        closure: propose up to `spec_k` drafts per active slot and launch
        ONE (B, Q) verify dispatch over all k+1 positions here; the closure
        waits for it, emits the greedy prefix and rolls the rejected tail
        back (pages allocated only for rejected drafts go back to the free
        list).  The closure returns (tokens emitted, step seconds, drafted,
        accepted, drafter device dispatches); the stream equals sequential
        greedy decode."""
        k = self.spec_k
        Q = k + 1
        sched = self.scheduler
        pos_np = sched.pool.pos
        # drafting is part of the solver phase: the step time that feeds
        # decode_s and the per-worker policy feedback starts here
        t0 = time.perf_counter()
        with self.tracer.span("draft", n=len(active), k=k):
            contexts = [np.concatenate(
                [np.asarray(self._by_slot[s].prompt, np.int64),
                 np.asarray(self._by_slot[s].generated, np.int64)])
                for s in active]
            proposals = self.drafter.propose(contexts, k)
            toks = np.zeros((self.capacity, Q), np.int32)
            n_new = np.zeros(self.capacity, np.int32)
            drafts: Dict[int, np.ndarray] = {}
            for i, slot in enumerate(active):
                r = self._by_slot[slot]
                # draft budget: never past the KV capacity or the request's
                # remaining tokens (wasted verification positions)
                budget = min(k, self.cache_len - 1 - int(pos_np[slot]),
                             r.max_new_tokens - r.n_generated - 1)
                d = np.asarray(proposals[i], np.int64)[: max(budget, 0)]
                drafts[slot] = d
                toks[slot, 0] = self.next_tok[slot, 0]
                toks[slot, 1: 1 + len(d)] = d
                n_new[slot] = 1 + len(d)
        with self.tracer.span("verify.dispatch", n=len(active)):
            pos = np.asarray(pos_np, np.int32)
            if self.pages is None:
                vtok = self._verify_step(self._pack_meta(toks, pos, n_new), Q)
            else:
                table, lengths, cow_src, cow_dst = self._paged_batch_inputs(
                    active, n_new)
                vtok = self._verify_step(self._pack_meta(
                    toks, pos, table, lengths, cow_src, cow_dst), Q)
            fetch = _to_host(vtok)
        draft_disp = getattr(self.drafter, "dispatches_per_propose", 0)

        def settle() -> Tuple[int, float, int, int, int]:
            with self.tracer.span("device_wait", cat="device",
                                  track="verify"):
                vtok_np = _host_value(*fetch)
            t_step = time.perf_counter() - t0
            sched.end_iteration()
            now = self._now()
            emitted = drafted = accepted = 0
            with self.tracer.span("rollback", n=len(active)):
                for slot in active:
                    req = self._by_slot[slot]
                    d = drafts[slot]
                    m = greedy_accept(d, vtok_np[slot])
                    drafted += len(d)
                    accepted += m
                    for j in range(m + 1):
                        tok = int(vtok_np[slot, j])
                        req.generated.append(tok)
                        self.next_tok[slot, 0] = tok
                        sched.pool.pos[slot] += 1
                        emitted += 1
                        if req.done():
                            break
                    if req.done():
                        del self._by_slot[slot]
                        self._release(req, now)
                    elif self.mem is not None:
                        # rollback: pages allocated only for rejected drafts
                        self.mem.trim(slot, int(sched.pool.pos[slot]))
            return emitted, t_step, drafted, accepted, draft_disp

        return settle

    def _finish_at_capacity(self) -> None:
        """A slot whose next write position is past the cache can't store
        another KV row: finish its request instead of overwriting."""
        sched = self.scheduler
        full = [s for s in self._by_slot
                if sched.pool.pos[s] >= self.cache_len]
        if full:
            now = self._now()
            for slot in full:
                self._release(self._by_slot.pop(slot), now)

    def _solver_launch(self, active: List[int]
                       ) -> Callable[[], Tuple[int, float, int, int, int]]:
        """Launch this tick's decode or verify step; -> its settle."""
        self.scheduler.begin_iteration()
        if self.drafter is not None:
            return self._spec_launch(active)
        return self._decode_launch(active)

    def _settle_prefills(self, pending: List) -> None:
        """Finish the prefill dispatches the overlap window deferred: ONE
        wait, on an event recorded behind everything the window queued
        (first tokens, inserts, chunks), then the PREFILL -> DECODING
        transitions in dispatch order, the order the synchronous tick runs
        them in."""
        if not pending:
            return
        with self.tracer.span("prefill.device_wait", cat="device",
                              track="prefill"):
            self._drain()
        now = self._now()
        for host, group in pending:
            nxt_np = host.numpy()
            for i, req in group:
                self._start_decoding(req, int(nxt_np[i]), now)

    def _overlapped_phase(self, admitted: Sequence[Request]
                          ) -> Tuple[int, int, int, int, float, int, int,
                                     int]:
        """The overlapped tick's middle: launch this tick's solver step
        FIRST, then do the host's prep (fresh-admission prefills, chunk
        advancement, `overlap_hook`) while the device computes, and block once, on the step alone.  Restores
        of parked or crash-retried slots bind BEFORE the launch, so they
        join this tick's step as in the synchronous tick.  The streams are
        the synchronous tick's: greedy decode conditions only on settled
        tokens, and every prep mutation the launch could observe happens
        at bind.  Returns (admission_bytes, n_chunks, n_chunk_dispatch,
        emitted, t_step, drafted, accepted, draft_disp)."""
        trc = self.tracer
        restores: List[Request] = []
        fresh: List[Request] = []
        for r in admitted:
            if self.mem is not None and self.mem.has_parked(r.rid):
                restores.append(r)
            else:
                fresh.append(r)
        admission_bytes = 0
        for r in restores:
            admission_bytes += self._restore_slot(r)
        self._finish_at_capacity()

        emitted = 0
        t_step = 0.0
        drafted = accepted = draft_disp = 0
        settle = None
        launch_t = 0.0
        # a prefill-only pool never decodes (its slots wait for handoff)
        active = sorted(self._by_slot) if self.decode_enabled else []
        if active:
            with trc.span("overlap.bind", track="overlap", n=len(active)):
                settle = self._solver_launch(active)
            launch_t = trc.clock() if trc.enabled else 0.0

        pending: List = []
        n_chunks = n_chunk_dispatch = 0
        with trc.span("overlap.prep", track="overlap", n_fresh=len(fresh)):
            if fresh:
                admission_bytes += self._do_prefill(fresh, defer=pending)
            if self._prefilling:
                n_chunks, chunk_bytes, n_chunk_dispatch = \
                    self._advance_prefills(defer=pending)
                admission_bytes += chunk_bytes
            if self.overlap_hook is not None:
                # disagg: drain the other pool's finished prefills into the
                # handoff queue while this pool's step is in flight
                self.overlap_hook()

        if settle is not None:
            emitted, t_step, drafted, accepted, draft_disp = settle()
            if trc.enabled:
                # the device's in-flight envelope [launch, ready], recorded
                # after the fact on the solver's track, so attribution (and
                # host_overlap_ratio) sees the window's host spans as hidden
                # behind it
                trc.complete("overlap.inflight", launch_t, trc.clock(),
                             cat="device",
                             track=("verify" if self.drafter is not None
                                    else "decode"), n=len(active))
        else:
            self.scheduler.sim_time += 1.0  # idle ticks still advance time
        self._settle_prefills(pending)
        if settle is None and not pending and (fresh or n_chunks
                                               or restores):
            # a prefill-only tick with nothing deferred (all admissions
            # chunked, or restores only): settle the KV writes so the
            # wall-clock metrics charge the tick that issued them
            with trc.span("prefill.device_wait", cat="device",
                          track="prefill"):
                self._drain()
        return (admission_bytes, n_chunks, n_chunk_dispatch, emitted,
                t_step, drafted, accepted, draft_disp)

    @torch.inference_mode()
    def tick(self) -> TickRecord:
        if self.suspended:
            raise RuntimeError("ServeEngine is suspended; call resume() "
                               "before ticking")
        now = self._now()
        sched = self.scheduler
        kv0 = self._kv_prev
        trc = self.tracer
        tick_t0 = time.perf_counter() if trc.enabled else 0.0
        self._tick_meta = 0  # packed host->device transfers this tick

        # ---- fault phase: injected faults land BEFORE the scheduler, so a
        # crash on the tick of a scale event has a fixed order (crash ->
        # retry requeue -> deadline shed -> policies) ----
        if self.fault_injector is not None:
            for ev in self.fault_injector.poll(self._tick):
                self.apply_fault(ev)
        if self._retrying and not (self.breaker is not None
                                   and self.breaker.state == "open"):
            # an OPEN breaker holds crash victims in backoff too: re-
            # admitting them mid-storm only feeds the next crash; they
            # drain at half-open, when the probe window watches for a
            # re-fault
            self._requeue_retries()
        self._shed_expired(now)

        # ---- overload-control phase: the breaker watches the fault counts
        # since the last tick (injected and external crash_worker calls
        # alike); the ladder re-evaluates its level from rolling SLO
        # attainment and queue pressure ----
        if self.breaker is not None:
            tr = self.breaker.update(
                self._tick,
                self._tick_faults["crashes"] + self._tick_faults["retries"])
            if tr is not None:
                self.metrics.breaker_events.append((self._tick, tr))
                trc.instant(f"breaker.{tr}", track="overload",
                            tick=self._tick)
                trc.count("serve.breaker_transitions")
        if self.ladder is not None:
            prev = self.ladder.level
            att = self.slo.attainment() if self.slo is not None else None
            lvl = self.ladder.update(att, sched.n_arrived(now),
                                     self.capacity)
            if lvl != prev:
                name = DegradationLadder.LEVELS[lvl]
                self.metrics.brownout_events.append((self._tick, lvl, name))
                trc.instant("degrade.enter" if lvl > prev
                            else "degrade.exit", track="overload",
                            level=lvl, label=name)
                trc.count("serve.degrade_transitions")
                trc.gauge("serve.brownout_level", lvl)
                self._apply_degradation(lvl)
            self._brownout_actions(now)

        # ---- scheduler phase: policies may rescale/rebalance the pool ----
        with trc.span("schedule", k=sched.n_workers):
            stats: Dict = dict(self._last_stats)
            k_before = sched.n_workers
            live, before = (self._slot_workers() if sched.policies
                            else ([], {}))
            sched.between_ticks(stats)
            if sched.n_workers != k_before:
                self.metrics.scale_events.append(
                    (self._tick, k_before, sched.n_workers))
                # policies resized the assignment in between_ticks, so
                # record the slot moves here; resize() only adopts k
                self._record_resize_moves(sched.n_workers, live, before)
                self.resize(sched.n_workers)
        # priority admission: a full pool parks a strictly lower-priority
        # in-flight decode (pages to host) instead of queueing the arrival
        with trc.span("admit"):
            limit = allow = None
            if self.breaker is not None:
                lim = self.breaker.admit_limit()
                if lim == 0:
                    # open: recovery traffic only; crash victims re-admit
                    # so recovery drains, fresh load waits out the storm
                    allow = lambda r: r.retries > 0  # noqa: E731
                elif lim is not None:
                    limit = lim  # half-open probe budget
            admitted = sched.admit(
                now, preempt=self._preempt_for if self.evict else None,
                limit=limit, allow=allow)
        if self.overlap:
            # ---- overlapped middle: launch the solver step first, prep
            # the rest of the tick while the device computes ----
            (admission_bytes, n_chunks, n_chunk_dispatch, emitted, t_step,
             drafted, accepted, draft_disp) = self._overlapped_phase(
                admitted)
        else:
            admission_bytes = self._do_prefill(admitted) if admitted else 0
            n_chunks = n_chunk_dispatch = 0
            if self._prefilling:
                n_chunks, chunk_bytes, n_chunk_dispatch = \
                    self._advance_prefills()
                admission_bytes += chunk_bytes
            self._finish_at_capacity()

            # ---- solver phase: one pool-wide decode (or spec-verify)
            # step, settled at once ----
            emitted = 0
            t_step = 0.0
            drafted = accepted = draft_disp = 0
            # a prefill-only pool half never decodes: prefilled slots wait
            # in _by_slot for the disagg handoff (the else branch still
            # advances schedule time and settles the prefill scatters)
            active = sorted(self._by_slot) if self.decode_enabled else []
            if active:
                emitted, t_step, drafted, accepted, draft_disp = \
                    self._solver_launch(active)()
            else:
                sched.sim_time += 1.0  # idle ticks still advance time
                if admitted or n_chunks:
                    # prefill-only tick: settle the outstanding KV scatters
                    # so wall-clock metrics charge the work to the issuing
                    # tick
                    with trc.span("prefill.device_wait", cat="device",
                                  track="prefill"):
                        self._drain()

        if self.debug_checks:
            # page-leak guard: every live slot holds EXACTLY the pages its
            # live tokens need, refcounts equal true reader counts, and the
            # prefix index points only at live pages
            sched.pool.check_invariants()
            if self.mem is not None:
                live = {s: int(sched.pool.pos[s]) for s in self._by_slot}
                live.update({s: off for s, (_, off)
                             in self._prefilling.items()})
                self.mem.check(live)

        # modeled per-worker timing attribution feeds the policy feedback
        # loop (load-proportional split of the step)
        loads = sched.active_per_worker()
        total = max(int(loads.sum()), 1)
        # injected stragglers inflate their worker's modeled share, so the
        # mitigation policy sees them as it would an organic slow worker
        slow = self._slow_factors
        self._last_stats = {
            "task_times": {w: t_step * loads[w] / total * slow.get(w, 1.0)
                           for w in range(sched.n_workers)},
            "per_sample_times": {w: t_step / total * slow.get(w, 1.0)
                                 for w in range(sched.n_workers)},
        }
        self._settle_recoveries()
        kv = {}
        if kv0 is not None:
            kv1 = self.mem.stats()
            self.metrics.kv_stats = kv1
            self._kv_prev = kv1
            delta = lambda k: kv1[k] - kv0[k]  # noqa: E731
            kv = dict(shared_page_hits=delta("shared_page_hits"),
                      cow_breaks=delta("cow_breaks"),
                      parked=delta("parked_total"),
                      restored=delta("restored_total"),
                      kv_moved_bytes=(delta("park_bytes")
                                      + delta("restore_bytes")),
                      shared_extra_pages=kv1["shared_extra"])
        rec = TickRecord(tick=self._tick, now=self._now(),
                         n_active=len(self._by_slot),
                         n_workers=sched.n_workers,
                         occupancy=sched.pool.occupancy(),
                         decode_s=t_step, admitted=len(admitted),
                         tokens_emitted=emitted,
                         admission_bytes=admission_bytes,
                         prefill_chunks=n_chunks,
                         prefill_dispatches=n_chunk_dispatch,
                         page_occupancy=(self.pages.occupancy()
                                         if self.pages is not None else 0.0),
                         spec_drafted=drafted, spec_accepted=accepted,
                         draft_dispatches=draft_disp,
                         crashes=self._tick_faults["crashes"],
                         retries=self._tick_faults["retries"],
                         shed=self._tick_faults["shed"],
                         brownout_level=(self.ladder.level
                                         if self.ladder is not None else 0),
                         meta_transfers=self._tick_meta, **kv)
        self._tick_faults = {"crashes": 0, "retries": 0, "shed": 0}
        self.metrics.ticks.append(rec)
        if trc.enabled:
            trc.count("serve.ticks")
            trc.count("serve.tokens_emitted", emitted)
            trc.observe("serve.tick_s", time.perf_counter() - tick_t0)
            if t_step > 0.0:
                trc.observe("serve.decode_s", t_step)
        self._tick += 1
        return rec

    def run(self, requests: Sequence[Request], *,
            max_ticks: int = 100_000) -> ServeMetrics:
        """Drive the open-loop workload to completion."""
        if self._clock is not None:
            raise ValueError("run() paces on the wall clock; with an "
                             "injected clock drive tick() externally")
        self.submit(requests)
        self._now()  # start the clock
        sched = self.scheduler
        while ((sched.has_pending or self._by_slot or self._prefilling
                or self._retrying)
               and self._tick < max_ticks):
            if not self._by_slot and not self._prefilling \
                    and sched.has_pending:
                wait = sched.next_arrival() - self._now()
                if wait > 0:  # idle until the next open-loop arrival
                    time.sleep(min(wait, 0.05))
            self.tick()
        self.metrics.wall_s = self._now()
        return self.metrics
