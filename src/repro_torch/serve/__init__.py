"""Elastic continuous-batching serving on PyTorch (`repro_torch.serve`).

- `request`   — request lifecycle + Poisson/trace/burst arrival traces
- `slots`     — fixed-capacity slot pool
- `scheduler` — per-tenant weighted admission over an elastic worker pool
                (`core.chunks.Assignment` + `core.policies`)
- `pages`     — paged KV bookkeeping: block tables, refcounts, null page 0
- `memory`    — `KVMemoryManager`: prefix index, copy-on-write plans
- `overload`  — SLO-aware overload control: per-tenant `TokenBucket`
                admission and bounded-queue backpressure
                (`AdmissionController`, REJECTED with a retry-after hint),
                the brownout `DegradationLadder` (spec shrink -> spec off
                -> chunk cap -> park low priority -> shed late, with
                hysteresis) and the crash-storm `CircuitBreaker`
- `spec`      — speculative decoding: n-gram and draft-model drafters,
                greedy accept
- `engine`    — `ServeEngine`: the serving loop (flat or paged KV
                layout, optional speculative decoding, a synchronous or
                an overlapped tick) on a CUDA (or CPU) device, elastic
                across `resize(k)`, with fault injection, crash recovery
                and overload control
- `disagg`    — `DisaggEngine`: prefill and decode pools as two engine
                halves over disjoint worker subsets with a page-granular
                handoff (park on the prefill side, adopt + restore on the
                decode side, no re-prefill) and a `SplitPolicy`
                rebalancing the prefill:decode worker split

The fault plans (`repro_torch.faults`) are re-exported here, as the JAX
package's `serve` does.
"""
from ..faults import (FaultEvent, FaultInjector, FaultPlan, crash_storm,
                      handoff_drop, parse_chaos, worker_crash, worker_slow)
from .disagg import (DisaggEngine, DisaggMetrics, QueueSplitPolicy,
                     ScheduledSplitPolicy, SplitObs, SplitPolicy)
from .engine import ServeEngine, ServeMetrics, TickRecord
from .overload import (AdmissionController, CircuitBreaker,
                       DegradationLadder, Rejection, TokenBucket)
from .memory import KVMemoryManager, ParkedSeq, RestorePlan
from .pages import PageAllocator, PageError
from .request import (Request, RequestState, poisson_arrivals,
                      synthetic_requests, trace_arrivals)
from .scheduler import SlotScheduler
from .slots import SlotPool
from .spec import DraftModelDrafter, NgramDrafter, greedy_accept

__all__ = [
    "AdmissionController", "CircuitBreaker", "DegradationLadder",
    "DisaggEngine", "DisaggMetrics", "DraftModelDrafter", "FaultEvent",
    "FaultInjector", "FaultPlan", "KVMemoryManager", "NgramDrafter",
    "PageAllocator", "PageError", "ParkedSeq", "QueueSplitPolicy",
    "Rejection", "Request", "RequestState", "RestorePlan",
    "ScheduledSplitPolicy", "ServeEngine", "ServeMetrics", "SlotPool",
    "SlotScheduler", "SplitObs", "SplitPolicy", "TickRecord", "TokenBucket",
    "crash_storm", "greedy_accept", "handoff_drop", "parse_chaos",
    "poisson_arrivals", "synthetic_requests", "trace_arrivals",
    "worker_crash", "worker_slow",
]
