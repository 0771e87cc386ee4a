"""Tick-time attribution: turn a tracer's spans into a per-phase
host-vs-device breakdown.

This is the measurement behind the async-overlap roadmap item: the paged
engine wins decode p50 but loses end-to-end tokens/s because host phases
(scheduling, drafting, COW planning, chunked prefill) serialize with device
compute inside one synchronous tick.  `phase_attribution` quantifies
exactly that — for every track (= engine phase, or cluster job) it sums
span time split by ``cat`` ("host" vs "device") and reports p50/p95 of the
per-span durations — and `dominant_host_phase` names the phase whose host
time an overlapped tick loop should hide first.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence

from .metrics import percentile
from .trace import TraceEvent, Tracer


def phase_attribution(tracer_or_events, *,
                      percentiles: Sequence[float] = (50, 95),
                      exclude: Iterable[str] = ("tick", "overlap"),
                      ) -> Dict[str, Dict[str, Optional[float]]]:
    """Per-track timing breakdown from finished spans.

    Returns ``{track: {count, host_ms_total, host_ms_p50, ...,
    device_ms_total, device_ms_p50, ...}}``.  Root/envelope tracks that
    merely contain the others (default: ``tick``, and the overlapped
    loop's ``overlap`` bind/prep envelopes, whose children carry their own
    phase tracks) are excluded, and within each (track, host/device) lane
    only the OUTERMOST spans are summed — a detail span nested inside its
    phase envelope on the same track adds trace-viewer depth without
    double-counting the phase's time."""
    events = (tracer_or_events.events
              if isinstance(tracer_or_events, Tracer) else tracer_or_events)
    skip = set(exclude)
    # sort longest-first on ts ties: a parent sharing its child's start
    # time must win the outermost sweep
    spans = sorted((e for e in events if e.ph == "X" and e.track not in skip),
                   key=lambda e: (e.ts, -e.dur))
    open_end: Dict[tuple, float] = {}
    per: Dict[str, Dict[str, List[float]]] = {}
    for e in spans:
        kind = "device" if e.cat == "device" else "host"
        if e.ts < open_end.get((e.track, kind), -1.0):
            continue  # nested inside a span already counted for this lane
        open_end[(e.track, kind)] = e.ts + e.dur
        per.setdefault(e.track, {"host": [], "device": []})[kind].append(
            e.dur * 1e3)
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for track in sorted(per):
        rec: Dict[str, Optional[float]] = {}
        n = 0
        for kind in ("host", "device"):
            vals = per[track][kind]
            n += len(vals)
            rec[f"{kind}_ms_total"] = sum(vals)
            for q in percentiles:
                key = f"{kind}_ms_p{int(q) if float(q).is_integer() else q}"
                rec[key] = percentile(vals, q) if vals else None
        rec["count"] = n
        out[track] = rec
    return out


def host_overlap_ratio(tracer_or_events, *,
                       exclude: Iterable[str] = ("tick", "overlap"),
                       ) -> Optional[float]:
    """Fraction of host span time that ran WHILE the device was busy — the
    direct score of the overlapped engine loop (host ms hidden under device
    ms / total host ms).

    Device-busy wall time is the union of all ``cat="device"`` span
    intervals across tracks.  The synchronous engine only emits
    ``device_wait`` blocks, which by construction never coincide with host
    spans on a single-threaded tick loop, so its ratio is ~0; the
    overlapped engine additionally emits ``overlap.inflight`` envelopes
    covering [dispatch, ready], so prep work inside the window counts as
    hidden.  Host time uses the same outermost-per-track sweep as
    `phase_attribution`; the ``overlap`` envelope track is excluded by
    default because its children (prefill/draft/handoff spans) already
    carry the phase identity.  Returns None when there is no host time."""
    events = (tracer_or_events.events
              if isinstance(tracer_or_events, Tracer) else tracer_or_events)
    skip = set(exclude)
    spans = sorted((e for e in events if e.ph == "X"),
                   key=lambda e: (e.ts, -e.dur))
    # merged device-busy intervals (device spans from ALL tracks)
    dev: List[List[float]] = []
    for e in spans:
        if e.cat != "device" or e.track in skip:
            continue
        s, t = e.ts, e.ts + e.dur
        if dev and s <= dev[-1][1]:
            dev[-1][1] = max(dev[-1][1], t)
        else:
            dev.append([s, t])
    starts = [iv[0] for iv in dev]

    def hidden_in(s: float, t: float) -> float:
        tot = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(dev) and dev[i][0] < t:
            tot += max(0.0, min(t, dev[i][1]) - max(s, dev[i][0]))
            i += 1
        return tot

    open_end: Dict[str, float] = {}
    total = hidden = 0.0
    for e in spans:
        if e.cat == "device" or e.track in skip:
            continue
        if e.ts < open_end.get(e.track, -1.0):
            continue  # nested inside a host span already counted
        open_end[e.track] = e.ts + e.dur
        total += e.dur
        hidden += hidden_in(e.ts, e.ts + e.dur)
    return hidden / total if total > 0 else None


def overload_timeline(tracer_or_events) -> Dict[str, object]:
    """Compact summary of the overload-control track: the ordered instant
    timeline (``slo.miss``, ``admission.reject``, ``degrade.*``,
    ``breaker.*``) plus per-name counts.  Tests and the serve CLI use it
    to assert that a run actually exercised the control path rather than
    merely configuring it."""
    events = (tracer_or_events.events
              if isinstance(tracer_or_events, Tracer) else tracer_or_events)
    timeline = [(e.ts, e.name, dict(e.args))
                for e in events if e.ph == "i"
                and (e.track == "overload"
                     or e.track.endswith(".overload"))]  # scoped halves
    timeline.sort(key=lambda t: t[0])
    counts: Dict[str, int] = {}
    for _, name, _ in timeline:
        counts[name] = counts.get(name, 0) + 1
    return {"timeline": timeline, "counts": counts}


def dominant_host_phase(attribution: Dict[str, Dict[str, Optional[float]]]
                        ) -> Optional[str]:
    """The phase with the most serialized HOST time — the direct input to
    the async-overlap work: this is the phase to move off the tick's
    critical path first.  Device-wait time never wins here by construction
    (it is accounted under ``device_ms_*``)."""
    best: Optional[str] = None
    best_ms = 0.0
    for track, rec in attribution.items():
        ms = rec.get("host_ms_total") or 0.0
        if ms > best_ms:
            best, best_ms = track, ms
    return best


def format_attribution(attribution: Dict[str, Dict[str, Optional[float]]]
                       ) -> str:
    """Human-readable table (used by the serve CLI's --trace-out path)."""
    lines = [f"  {'phase':<16s} {'host ms':>10s} {'p50':>8s} {'p95':>8s} "
             f"{'device ms':>10s} {'spans':>6s}"]
    order = sorted(attribution,
                   key=lambda t: -(attribution[t]["host_ms_total"] or 0.0))
    fmt = lambda v: f"{v:8.2f}" if v is not None else "     n/a"  # noqa: E731
    for track in order:
        r = attribution[track]
        lines.append(
            f"  {track:<16s} {r['host_ms_total'] or 0.0:10.2f} "
            f"{fmt(r.get('host_ms_p50'))} {fmt(r.get('host_ms_p95'))} "
            f"{r['device_ms_total'] or 0.0:10.2f} {r['count']:6d}")
    return "\n".join(lines)
