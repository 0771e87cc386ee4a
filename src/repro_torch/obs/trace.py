"""Tracer: nestable spans with host/device attribution and Chrome export.

Design constraints, in priority order:

1. **Disabled is free.** `Tracer.span()` on a disabled tracer is a single
   attribute check returning a shared no-op context manager — no object
   allocation, no clock read, no event append.  The serving engine keeps
   its tracer calls inline on the hot path because of this.
2. **Device time is attributed explicitly.** CUDA launches return before
   the card has run them, and whichever host phase first reads a result
   (``.cpu()``, ``.item()``, ``float()``) pays the wait.  Callers wrap such
   a blocking read in a span with ``cat="device"`` (placed on the *owning
   phase's* track) so the attribution report can split host ms from
   device ms per phase instead of blaming a random host phase for device
   latency; `Tracer.device_span` times a stretch of work on the card
   itself, by a pair of CUDA events resolved only when events are read.
3. **Loadable traces.** `to_chrome()` emits Chrome trace-event JSON
   (``{"traceEvents": [...]}`` with complete "X" and instant "i" events
   plus process/thread-name metadata), viewable in Perfetto or
   ``chrome://tracing``; tracks (tids) are interned per span ``track``,
   which defaults to the span name's first dot-segment — so
   ``decode.dispatch`` and its ``device_wait`` share the ``decode`` track.

Spans are exception-safe: a span whose body raises is still recorded (with
``error=True``) and the exception propagates.  The tracer also fronts a
`MetricsRegistry` via `count`/`gauge`/`observe` helpers that no-op when
disabled, so callers never branch on ``tracer.enabled`` themselves.

While a `torch.profiler` session records, every span an enabled tracer
opens is also a ``record_function`` range of the same name, so spans stand
in the profiler's own timeline, on the clock of its kernels.
`PROGRAM_TRACER` is the process-wide tracer of the training path: it
records exactly while a profiler records, keeps the newest session's
events only, and adds ``python.gc`` spans for the collector's passes.

Imports torch only for the profiler mirror and CUDA events; single-threaded
by design (one tracer per engine/orchestrator tick loop).

CLI: ``python -m repro_torch.obs.trace --validate trace.json --require a,b``
validates an exported file (used by scripts/smoke.sh and CI).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

from .metrics import MetricsRegistry


@dataclasses.dataclass
class TraceEvent:
    """One finished span ("X") or instant ("i") on a named track."""

    name: str
    ph: str            # "X" complete span | "i" instant
    track: str         # one row in the trace viewer (engine phase / job)
    cat: str           # "host" | "device" (attribution class)
    ts: float          # seconds since tracer epoch
    dur: float = 0.0   # seconds ("X" only)
    depth: int = 0     # nesting depth at emission (tests / debugging)
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    error: bool = False
    parent: Optional[int] = None  # index in `events` of the enclosing span


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """An open span.  It sits on its tracer's stack of open spans from
    enter to exit and keeps its finished children's event indices: events
    are appended as spans finish, so a parent's index is known only after
    its children's."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0",
                 "_depth", "_stack", "_up", "_kids", "_rf")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self._t0 = tr._clock()
        self._rf = (_profiler.record_function(self._name).__enter__()
                    if _profiler._is_profiler_enabled else None)
        stack = self._stack = tr._open
        self._depth = len(stack)
        self._up = stack[-1] if stack else None
        self._kids = []
        stack.append(self)
        return self

    def _finish(self, t1: float) -> float:
        """The span's duration, its end read at `t1`."""
        return t1 - self._t0

    def __exit__(self, etype, evalue, tb) -> bool:
        tr = self._tracer
        if self._rf is not None:  # inside the span, as its enter is
            self._rf.__exit__(None, None, None)
        dur = self._finish(tr._clock())
        self._stack.pop()
        if self._stack is tr._open:  # else clear() or a new session dropped it
            ev = TraceEvent(
                name=self._name, ph="X", track=self._track, cat=self._cat,
                ts=self._t0 - tr._epoch, dur=dur, depth=self._depth,
                args=self._args, error=etype is not None)
            tr._append(ev, self)
            self._recorded(ev)
        return False  # never swallow the exception

    def _recorded(self, ev: TraceEvent) -> None:
        pass


class _DeviceSpan(_Span):
    """A span timed on the card: a CUDA event on the device's current
    stream at enter and at exit, read (``elapsed_time``) only when the
    tracer's events are; without a CUDA device, the host clock."""

    __slots__ = ("_device", "_start", "_end")

    def __init__(self, tracer, name, cat, track, args, device):
        super().__init__(tracer, name, cat, track, args)
        self._device = device

    def __enter__(self) -> "_DeviceSpan":
        super().__enter__()
        self._start = None
        if self._device is not None and self._device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        return self

    def _finish(self, t1: float) -> float:
        if self._start is None:
            return t1 - self._t0
        self._end = torch.cuda.Event(enable_timing=True)
        self._end.record(torch.cuda.current_stream(self._device))
        return 0.0  # read from the events with the tracer's events

    def _recorded(self, ev: TraceEvent) -> None:
        if self._start is not None:
            self._tracer._pending.append((ev, self._start, self._end))


class Tracer:
    """Span recorder + metrics front.  ``enabled=False`` (the default for
    `NULL_TRACER`) turns every call into a near-free no-op."""

    def __init__(self, enabled: bool = True, *, name: str = "repro",
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.name = name
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock
        self._epoch = clock()
        self._open: List[_Span] = []
        self._events: List[TraceEvent] = []
        self._pending: List = []  # (event, start, end) of device spans

    @property
    def events(self) -> List[TraceEvent]:
        """Finished spans and instants in the order they finished.  Device
        spans' durations are read from their CUDA events here, which waits
        for the card to reach each one's end."""
        if self._pending:
            for ev, start, end in self._pending:
                end.synchronize()
                ev.dur = start.elapsed_time(end) / 1e3
            self._pending.clear()
        return self._events

    @property
    def _depth(self) -> int:
        return len(self._open)

    def _append(self, ev: TraceEvent, span: Optional[_Span] = None) -> None:
        """Append a finished event: the parent of `span`'s finished
        children, and a child of the span enclosing it."""
        events = self._events
        i = len(events)
        events.append(ev)
        if span is None:
            up = self._open[-1] if self._open else None
        else:
            for k in span._kids:
                events[k].parent = i
            up = span._up
        if up is not None:
            up._kids.append(i)

    # --- spans ------------------------------------------------------------
    @staticmethod
    def default_track(name: str) -> str:
        return name.split(".", 1)[0]

    def span(self, name: str, cat: str = "host",
             track: Optional[str] = None, **args):
        """Open a span; use as ``with tracer.span("decode.dispatch"): ...``.
        `track` defaults to the name's first dot-segment.  Disabled tracers
        return a shared no-op (one attribute check, zero allocation)."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat,
                     track if track is not None else self.default_track(name),
                     args)

    def device_span(self, name: str, cat: str = "device",
                    track: Optional[str] = None, *, device=None, **args):
        """A span whose duration is the card's time from its enter to its
        exit: CUDA events on `device`'s current stream (the host clock
        where `device` is None or not a CUDA device).  Its start, ``ts``,
        is the host's; it never synchronises."""
        if not self.enabled:
            return NOOP_SPAN
        return _DeviceSpan(
            self, name, cat,
            track if track is not None else self.default_track(name), args,
            None if device is None else torch.device(device))

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        """Point event (e.g. a jit-cache miss, a lease change)."""
        if not self.enabled:
            return
        self._append(TraceEvent(
            name=name, ph="i",
            track=track if track is not None else self.default_track(name),
            cat="host", ts=self._clock() - self._epoch, depth=self._depth,
            args=args))

    def clock(self) -> float:
        """Raw tracer-clock reading; pair two of these with `complete()` to
        record a span whose endpoints were observed out of line."""
        return self._clock()

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "host", track: Optional[str] = None,
                 **args) -> None:
        """Record an already-finished span from explicit `clock()` readings.
        The overlapped engine loop uses this to emit the device in-flight
        envelope [dispatch, ready] after the fact — a live ``with`` span
        cannot bracket it because the host is busy preparing the next tick
        while the device computes."""
        if not self.enabled:
            return
        self._append(TraceEvent(
            name=name, ph="X",
            track=track if track is not None else self.default_track(name),
            cat=cat, ts=t0 - self._epoch, dur=max(t1 - t0, 0.0),
            depth=self._depth, args=args))

    # --- metrics front (no-ops when disabled) -----------------------------
    def count(self, name: str, n=1) -> None:
        if self.enabled:
            self.registry.counter(name).inc(n)

    def gauge(self, name: str, v) -> None:
        if self.enabled:
            self.registry.gauge(name).set(v)

    def observe(self, name: str, v) -> None:
        if self.enabled:
            self.registry.histogram(name).observe(v)

    # --- queries ----------------------------------------------------------
    def spans(self, name: Optional[str] = None,
              track: Optional[str] = None) -> List[TraceEvent]:
        return [e for e in self.events if e.ph == "X"
                and (name is None or e.name == name)
                and (track is None or e.track == track)]

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.track)
        return list(seen)

    def clear(self) -> None:
        """Drop every event, and the spans still open (they record nothing
        when they close)."""
        self._events.clear()
        self._pending.clear()
        self._open = []
        self._epoch = self._clock()

    # --- export -----------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        pid = 1
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": self.name},
        }]
        for e in self.events:
            if e.track not in tids:
                tids[e.track] = len(tids) + 1
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tids[e.track], "ts": 0,
                    "args": {"name": e.track},
                })
            ev: Dict[str, Any] = {
                "name": e.name, "ph": e.ph, "cat": e.cat, "pid": pid,
                "tid": tids[e.track], "ts": e.ts * 1e6,
                "args": dict(e.args),
            }
            if e.ph == "X":
                ev["dur"] = e.dur * 1e6
            else:
                ev["s"] = "t"  # instant scope: thread
            if e.error:
                ev["args"]["error"] = True
            if e.parent is not None:
                ev["args"]["parent"] = e.parent
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path


class ScopedTracer(Tracer):
    """A scoped view over a parent tracer: spans and instants keep their
    NAMES but land on ``<scope>.<track>`` tracks, and metric names gain the
    same ``<scope>.`` prefix.  Events share the parent's list, clock, epoch,
    nesting depth, and registry, so one export interleaves every scope on
    distinguishable rows — this is how the disaggregated serving engine
    gives its prefill and decode halves separate per-pool tracks (and
    non-colliding ``serve.*`` metrics) on ONE trace."""

    def __init__(self, parent: Tracer, scope: str):
        # deliberately skip Tracer.__init__: all storage belongs to `parent`
        self.parent = parent
        self.scope = scope
        self.enabled = parent.enabled
        self.name = parent.name
        self.registry = parent.registry
        self._clock = parent._clock

    # shared mutable state lives on the parent (clear() resets epoch there)
    @property
    def _events(self) -> List[TraceEvent]:
        return self.parent._events

    @property
    def _pending(self) -> List:
        return self.parent._pending

    @property
    def _open(self) -> List[_Span]:
        return self.parent._open

    @property
    def _epoch(self) -> float:
        return self.parent._epoch

    def span(self, name: str, cat: str = "host",
             track: Optional[str] = None, **args):
        if not self.enabled:
            return NOOP_SPAN
        base = track if track is not None else self.default_track(name)
        return _Span(self, name, cat, f"{self.scope}.{base}", args)

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        if not self.enabled:
            return
        base = track if track is not None else self.default_track(name)
        self.parent.instant(name, track=f"{self.scope}.{base}", **args)

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "host", track: Optional[str] = None,
                 **args) -> None:
        if not self.enabled:
            return
        base = track if track is not None else self.default_track(name)
        Tracer.complete(self, name, t0, t1, cat=cat,
                        track=f"{self.scope}.{base}", **args)

    def count(self, name: str, n=1) -> None:
        if self.enabled:
            self.registry.counter(f"{self.scope}.{name}").inc(n)

    def gauge(self, name: str, v) -> None:
        if self.enabled:
            self.registry.gauge(f"{self.scope}.{name}").set(v)

    def observe(self, name: str, v) -> None:
        if self.enabled:
            self.registry.histogram(f"{self.scope}.{name}").observe(v)


#: Shared disabled tracer: the default for every instrumented component, so
#: "no tracer configured" and "tracing off" are the same zero-cost path.
NULL_TRACER = Tracer(enabled=False, name="null")


class ProgramTracer(Tracer):
    """A tracer that records exactly while a `torch.profiler` session
    records (`torch.autograd.profiler._is_profiler_enabled`, a module flag:
    off, a span costs that one check and returns `NOOP_SPAN`).  Each new
    session, seen as the flag rising at a span, drops the previous
    session's events, so `events` holds the newest session only.  While it
    records, each pass of Python's garbage collector is a ``python.gc``
    span (arg ``generation``) under whatever span it interrupts.  A
    session's end is seen by a span or by a read of `events` while the
    flag is down."""

    def __init__(self, name: str = "program"):
        self._live = False  # a span has seen the current session
        self._gc_span: Optional[_Span] = None
        self._gc_hooked = False
        super().__init__(name=name)

    @property
    def enabled(self) -> bool:
        if not _profiler._is_profiler_enabled:
            self._live = False
            return False
        if not self._live:
            self._new_session()
        return True

    @enabled.setter
    def enabled(self, value: bool) -> None:  # `Tracer.__init__` sets True
        if not value:
            raise ValueError("a ProgramTracer follows the profiler; use "
                             "NULL_TRACER for a tracer that is always off")

    @property
    def events(self) -> List[TraceEvent]:
        """As `Tracer.events`; read after a session has ended, it also
        marks that end, so the next session starts afresh even where no
        span ran between the two."""
        if not _profiler._is_profiler_enabled:
            self._live = False
        return Tracer.events.fget(self)

    def _new_session(self) -> None:
        self.clear()
        self._live = True
        if not self._gc_hooked:
            gc.callbacks.append(self._on_gc)
            self._gc_hooked = True

    def _on_gc(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            if self._live and _profiler._is_profiler_enabled:
                self._gc_span = _Span(self, "python.gc", "host", "python",
                                      {"generation": info["generation"]})
                self._gc_span.__enter__()
        elif self._gc_span is not None:
            span, self._gc_span = self._gc_span, None
            span.__exit__(None, None, None)


#: The training path's tracer: `core.UniTaskEngine`, `core.CoCoASolver`,
#: `launch.train.scheduled_batch` and `launch.steps` record into it.
PROGRAM_TRACER = ProgramTracer()


def validate_chrome_trace(obj: Any,
                          require_names: Sequence[str] = (),
                          require_tracks: Sequence[str] = ()
                          ) -> Dict[str, int]:
    """Validate an exported object against the Chrome trace-event format's
    required keys (name/ph/ts/pid/tid, plus dur for complete events); then
    check every name in `require_names` occurs at least once and every
    track in `require_tracks` appears as a thread_name metadata row (the
    per-pool tracks a `ScopedTracer` emits).  Returns per-name occurrence
    counts; raises ValueError on any violation."""
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"),
                                                   list):
        raise ValueError("not a Chrome trace: expected a dict with a "
                         "'traceEvents' list")
    counts: Dict[str, int] = {}
    tracks: Dict[str, None] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] missing required "
                                 f"key {key!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"traceEvents[{i}]: complete ('X') event "
                             f"missing 'dur'")
        if ev["ph"] == "M" and ev["name"] == "thread_name":
            tracks.setdefault(str(ev.get("args", {}).get("name", "")))
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    missing = [n for n in require_names if not counts.get(n)]
    if missing:
        raise ValueError(f"trace has no event named: {missing}")
    missing_tracks = [t for t in require_tracks if t not in tracks]
    if missing_tracks:
        raise ValueError(f"trace has no track named: {missing_tracks} "
                         f"(tracks present: {sorted(tracks)})")
    return counts


def _cli() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate an exported Chrome trace-event JSON file")
    ap.add_argument("--validate", required=True, metavar="FILE")
    ap.add_argument("--require", default="",
                    help="comma-separated event names that must be present")
    ap.add_argument("--require-tracks", default="",
                    help="comma-separated track (thread) names that must "
                         "be present")
    args = ap.parse_args()
    with open(args.validate) as fh:
        obj = json.load(fh)
    names = [n for n in args.require.split(",") if n]
    tracks = [t for t in args.require_tracks.split(",") if t]
    counts = validate_chrome_trace(obj, require_names=names,
                                   require_tracks=tracks)
    total = sum(counts.values())
    print(f"{args.validate}: valid Chrome trace, {total} events, "
          f"{len(counts)} distinct names")
    for n in names:
        print(f"  {n}: {counts[n]} event(s)")


if __name__ == "__main__":
    _cli()
