"""Tracer: nestable spans with host/device attribution and Chrome export.

Design constraints, in priority order:

1. **Disabled is free.** `Tracer.span()` on a disabled tracer is a single
   attribute check returning a shared no-op context manager — no object
   allocation, no clock read, no event append.  The serving engine keeps
   its tracer calls inline on the hot path because of this.
2. **Device time is attributed explicitly.** Under async XLA dispatch a
   jitted call returns immediately and whichever host phase happens to
   touch the result pays the wait.  Callers wrap their
   ``jax.block_until_ready`` in a span with ``cat="device"`` (by
   convention named ``device_wait``, placed on the *owning phase's* track)
   so the attribution report can split host ms from device ms per phase
   instead of blaming a random host phase for device latency.
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

Stdlib-only; single-threaded by design (one tracer per engine/orchestrator
tick loop).

CLI: ``python -m repro_torch.obs.trace --validate trace.json --require a,b``
validates an exported file (used by scripts/smoke.sh and CI).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

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


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0",
                 "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self._depth = tr._depth
        tr._depth += 1
        self._t0 = tr._clock()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        tr = self._tracer
        t1 = tr._clock()
        tr._depth -= 1
        tr.events.append(TraceEvent(
            name=self._name, ph="X", track=self._track, cat=self._cat,
            ts=self._t0 - tr._epoch, dur=t1 - self._t0, depth=self._depth,
            args=self._args, error=etype is not None))
        return False  # never swallow the exception


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
        self._depth = 0
        self.events: List[TraceEvent] = []

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

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        """Point event (e.g. a jit-cache miss, a lease change)."""
        if not self.enabled:
            return
        self.events.append(TraceEvent(
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
        self.events.append(TraceEvent(
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
        self.events.clear()
        self._depth = 0
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
    def events(self) -> List[TraceEvent]:
        return self.parent.events

    @property
    def _epoch(self) -> float:
        return self.parent._epoch

    @property
    def _depth(self) -> int:
        return self.parent._depth

    @_depth.setter
    def _depth(self, v: int) -> None:
        self.parent._depth = v

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
