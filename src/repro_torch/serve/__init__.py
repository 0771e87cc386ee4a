"""Elastic continuous-batching serving on PyTorch (`repro_torch.serve`).

- `request`   — request lifecycle + Poisson/trace/burst arrival traces
- `slots`     — fixed-capacity slot pool
- `scheduler` — per-tenant weighted admission over an elastic worker pool
                (`core.chunks.Assignment` + `core.policies`)
- `pages`     — paged KV bookkeeping: block tables, refcounts, null page 0
- `memory`    — `KVMemoryManager`: prefix index, copy-on-write plans
- `overload`  — admission / brownout / breaker policies (host-only; the
                engine does not wire them in yet)
- `spec`      — speculative decoding: n-gram and draft-model drafters,
                greedy accept
- `engine`    — `ServeEngine`: the synchronous serving loop (flat or paged
                KV layout, optional speculative decoding) on a CUDA (or
                CPU) device, elastic across `resize(k)`
"""
from .engine import ServeEngine, ServeMetrics, TickRecord
from .memory import KVMemoryManager
from .pages import PageAllocator, PageError
from .request import (Request, RequestState, poisson_arrivals,
                      synthetic_requests, trace_arrivals)
from .scheduler import SlotScheduler
from .slots import SlotPool
from .spec import DraftModelDrafter, NgramDrafter, greedy_accept

__all__ = [
    "DraftModelDrafter", "KVMemoryManager", "NgramDrafter", "PageAllocator",
    "PageError", "Request", "RequestState", "ServeEngine", "ServeMetrics",
    "SlotPool", "SlotScheduler", "TickRecord", "greedy_accept",
    "poisson_arrivals", "synthetic_requests", "trace_arrivals",
]
