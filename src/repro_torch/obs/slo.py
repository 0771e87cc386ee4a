"""Rolling SLO attainment tracking (stdlib-only, like all of repro.obs).

``SLOTracker`` scores finished requests against TTFT/TPOT targets and
maintains windowed attainment over the last N finishes — the control
signal for the serve engine's degradation ladder and for split/allocator
feedback.  Final-run *accounting* (goodput over all finishes) is
computed from the request records themselves in ``ServeMetrics``; the
tracker exists for live control and tracing, so a run's reported
goodput never depends on window size.

A finish meets its SLO iff every set target is met; a request too short
to measure TPOT (fewer than two tokens) is exempt from the TPOT target.
Misses emit a traced ``slo.miss`` instant on the "overload" track and
bump the ``serve.slo_misses`` counter; attainment lands in the metrics
registry as gauges via the tracer.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple


def meets_slo(ttft: Optional[float], tpot: Optional[float],
              ttft_target: Optional[float],
              tpot_target: Optional[float]) -> bool:
    """True iff the measured latencies meet every *set* target."""
    if ttft_target is not None and (ttft is None or ttft > ttft_target):
        return False
    if tpot_target is not None and tpot is not None and tpot > tpot_target:
        return False
    return True


class SLOTracker:
    def __init__(self, *,
                 ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None,
                 window: int = 64,
                 tracer: Any = None) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self.window = int(window)
        self.tracer = tracer
        self.met_total = 0
        self.missed_total = 0
        self._win: Deque[bool] = deque(maxlen=self.window)
        self._ttft_win: Deque[bool] = deque(maxlen=self.window)
        self._tpot_win: Deque[bool] = deque(maxlen=self.window)
        self._tenant_win: Dict[str, Deque[bool]] = {}

    @property
    def enabled(self) -> bool:
        return self.ttft_target is not None or self.tpot_target is not None

    def observe(self, *, rid: int = -1, tenant: str = "default",
                ttft: Optional[float] = None,
                tpot: Optional[float] = None,
                ttft_target: Optional[float] = None,
                tpot_target: Optional[float] = None) -> bool:
        """Score one finished request; returns whether it met its SLOs.

        Per-request targets (when given) override the tracker-level
        defaults, so a mixed-SLO workload shares one tracker.
        """
        tt = self.ttft_target if ttft_target is None else ttft_target
        pt = self.tpot_target if tpot_target is None else tpot_target
        ttft_ok = tt is None or (ttft is not None and ttft <= tt)
        tpot_ok = pt is None or tpot is None or tpot <= pt
        ok = ttft_ok and tpot_ok
        self._win.append(ok)
        self._ttft_win.append(ttft_ok)
        self._tpot_win.append(tpot_ok)
        tw = self._tenant_win.get(tenant)
        if tw is None:
            tw = self._tenant_win[tenant] = deque(maxlen=self.window)
        tw.append(ok)
        if ok:
            self.met_total += 1
        else:
            self.missed_total += 1
        trc = self.tracer
        if trc is not None:
            if not ok:
                trc.instant("slo.miss", track="overload", rid=rid,
                            tenant=tenant, ttft=ttft, tpot=tpot,
                            ttft_ok=ttft_ok, tpot_ok=tpot_ok)
                trc.count("serve.slo_misses")
            a = self.attainment()
            if a is not None:
                trc.gauge("serve.slo_attainment", a)
        return ok

    @staticmethod
    def _frac(win: Deque[bool]) -> Optional[float]:
        return sum(win) / len(win) if win else None

    def attainment(self) -> Optional[float]:
        """Windowed fraction of recent finishes meeting all SLOs."""
        return self._frac(self._win)

    def ttft_attainment(self) -> Optional[float]:
        return self._frac(self._ttft_win)

    def tpot_attainment(self) -> Optional[float]:
        return self._frac(self._tpot_win)

    def tenant_attainment(self, tenant: str) -> Optional[float]:
        return self._frac(self._tenant_win.get(tenant, deque()))

    def summary(self) -> Dict[str, Any]:
        return {
            "ttft_target": self.ttft_target,
            "tpot_target": self.tpot_target,
            "met_total": self.met_total,
            "missed_total": self.missed_total,
            "attainment": self.attainment(),
            "ttft_attainment": self.ttft_attainment(),
            "tpot_attainment": self.tpot_attainment(),
            "tenants": {t: self._frac(w)
                        for t, w in sorted(self._tenant_win.items())},
        }


__all__ = ["SLOTracker", "meets_slo"]
