"""Observability substrate of the port (`repro_torch.obs`): tracing +
metrics.

- `trace`   — `Tracer` with nestable exception-safe spans, explicit
              device-sync attribution (``cat="device"`` spans around
              torch's blocking reads: ``.cpu()``, ``.item()``,
              ``float()``), device-timed spans (CUDA events), instant
              events, Chrome trace-event JSON export (Perfetto-loadable),
              and a disabled fast path that is one attribute check
              (`NULL_TRACER` is the serving path's shared default, so
              un-traced runs stay bit-identical and unslowed); while a
              `torch.profiler` session records, each span is also a
              ``record_function`` range in the profiler's timeline.
              `PROGRAM_TRACER` is the training path's default: it records
              exactly while a profiler does
- `metrics` — `MetricsRegistry` of counters / gauges / histograms;
              `percentile` matches numpy's linear interpolation exactly
- `report`  — `phase_attribution`: per-phase host-vs-device tick-time
              breakdown from spans; `dominant_host_phase` names the
              serialized host phase an async tick loop should overlap
              first (ROADMAP open item 1's measurement)
- `slo`     — `SLOTracker`: rolling TTFT/TPOT attainment windows, the
              control signal for overload brownouts and split/allocator
              feedback; traced `slo.miss` instants

The serving engine and cluster orchestrator thread a `Tracer` through;
the training path (the uni-task engine, the CoCoA solver, the LM
trainer's scheduler and step) records into `PROGRAM_TRACER`.  `trace`
imports torch (the profiler mirror, CUDA events); nothing here imports jax
or numpy.
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .report import (dominant_host_phase, format_attribution,
                     host_overlap_ratio, overload_timeline,
                     phase_attribution)
from .slo import SLOTracker, meets_slo
from .trace import (NOOP_SPAN, NULL_TRACER, PROGRAM_TRACER, ProgramTracer,
                    ScopedTracer, TraceEvent, Tracer, validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NOOP_SPAN",
    "NULL_TRACER", "PROGRAM_TRACER", "ProgramTracer", "SLOTracker",
    "ScopedTracer", "TraceEvent", "Tracer",
    "dominant_host_phase", "format_attribution", "host_overlap_ratio",
    "meets_slo", "overload_timeline", "percentile", "phase_attribution",
    "validate_chrome_trace",
]
