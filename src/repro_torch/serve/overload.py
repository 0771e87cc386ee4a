"""Overload control for the serving engine.

Four cooperating mechanisms, all default-off (constructing an engine
without overload knobs is bit-identical to not having this module):

- ``TokenBucket`` / ``AdmissionController``: per-tenant token-bucket
  admission with a bounded admission queue.  A request that fails
  admission is REJECTED (terminal) with a retry-after hint — explicit
  backpressure, counted separately from deadline sheds (EXPIRED).
- ``DegradationLadder``: brownout levels driven by SLO attainment and
  queue pressure.  Each level sheds *work quality* before shedding
  requests: shrink speculative drafting, then disable it, then cap
  chunked-prefill width, then park lowest-priority residents, then
  proactively shed queued work that can no longer meet its TTFT target.
  Hysteresis (consecutive-tick patience, asymmetric up/down) keeps the
  level from flapping; every transition is reversible.
- ``CircuitBreaker``: crash-storm protection.  When crashes+retries in
  a sliding window exceed a threshold the breaker opens — new
  admissions pause (recovery traffic still passes) — then half-opens
  with a small admission probe and closes when the probe survives.

Everything here is deterministic and host-only: no jax, no numpy, no
wall-clock reads.  Time comes in through method arguments.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


# --------------------------------------------------------------------------
# Token bucket
# --------------------------------------------------------------------------

class TokenBucket:
    """Classic leaky/token bucket on an externally supplied clock.

    Starts full (``burst`` tokens) so a cold tenant can burst up to its
    burst budget immediately; refills at ``rate`` tokens per second of
    the supplied clock.  Non-monotonic timestamps are clamped (dt >= 0)
    so replayed/merged arrival streams can't mint tokens.
    """

    def __init__(self, rate: float, burst: float) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        dt = max(now - self._last, 0.0)
        self.tokens = min(self.burst, self.tokens + self.rate * dt)
        self._last = now

    def peek(self, now: float) -> float:
        """Tokens available at `now` without consuming."""
        self._refill(now)
        return self.tokens

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, now: float, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if already)."""
        self._refill(now)
        if self.tokens >= n:
            return 0.0
        return (n - self.tokens) / self.rate


@dataclasses.dataclass
class Rejection:
    """Why admission refused a request, plus a client backoff hint."""
    reason: str          # "rate" | "queue_full"
    retry_after: float   # seconds; hint, not a promise


class AdmissionController:
    """Per-tenant token buckets + a bounded admission queue.

    ``tenant_rate``/``tenant_burst`` may be scalars (applied to every
    tenant) or ``{tenant: value}`` dicts; a tenant missing from the
    rate dict is not rate-limited.  ``queue_cap`` bounds the *total*
    queued (not yet admitted) requests across tenants.  Either control
    may be None (disabled).
    """

    def __init__(self, *,
                 tenant_rate: Any = None,
                 tenant_burst: Any = None,
                 queue_cap: Optional[int] = None,
                 drain_rate: float = 4.0) -> None:
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst
        self.queue_cap = queue_cap
        # used only for the queue-full retry-after estimate
        self.drain_rate = max(float(drain_rate), 1e-6)
        self._buckets: Dict[str, TokenBucket] = {}
        self.rejected_rate = 0
        self.rejected_queue = 0

    @property
    def enabled(self) -> bool:
        return self.tenant_rate is not None or self.queue_cap is not None

    def _lookup(self, table: Any, tenant: str) -> Optional[float]:
        if table is None:
            return None
        if isinstance(table, dict):
            v = table.get(tenant)
            return None if v is None else float(v)
        return float(table)

    def bucket(self, tenant: str) -> Optional[TokenBucket]:
        rate = self._lookup(self.tenant_rate, tenant)
        if rate is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            burst = self._lookup(self.tenant_burst, tenant)
            if burst is None:
                burst = max(rate, 1.0)
            b = self._buckets[tenant] = TokenBucket(rate, burst)
        return b

    def check(self, tenant: str, now: float,
              queue_len: int) -> Optional[Rejection]:
        """None = admit to queue; Rejection = refuse with a hint."""
        if self.queue_cap is not None and queue_len >= self.queue_cap:
            self.rejected_queue += 1
            excess = queue_len - self.queue_cap + 1
            return Rejection("queue_full",
                             max(excess / self.drain_rate, 1.0))
        b = self.bucket(tenant)
        if b is not None and not b.try_take(now):
            self.rejected_rate += 1
            return Rejection("rate", max(b.retry_after(now), 1e-6))
        return None


# --------------------------------------------------------------------------
# Graceful-degradation ladder
# --------------------------------------------------------------------------

class DegradationLadder:
    """Brownout level controller with hysteresis.

    Levels (cumulative — level N applies everything below it):

      0 normal       full service
      1 spec_shrink  speculative depth halved
      2 spec_off     speculative drafting disabled
      3 chunk_cap    chunked-prefill width capped at one page
      4 park_low     park a lowest-priority resident per tick when a
                     strictly higher-priority request is waiting
      5 shed_late    shed queued requests already past the TTFT target

    ``update`` is called once per tick with the rolling SLO attainment
    (None until anything finishes) and the arrived-queue depth.  The
    level escalates after ``up_patience`` consecutive hot ticks and
    de-escalates after ``down_patience`` consecutive cool ticks; the
    dead band between ``attain_low`` and ``attain_high`` (and between
    ``queue_low``/``queue_high`` pressure) means a borderline signal
    holds the current level instead of flapping.
    """

    LEVELS: Tuple[str, ...] = ("normal", "spec_shrink", "spec_off",
                               "chunk_cap", "park_low", "shed_late")

    def __init__(self, *,
                 attain_low: float = 0.9,
                 attain_high: float = 0.97,
                 queue_high: float = 2.0,
                 queue_low: float = 0.5,
                 up_patience: int = 2,
                 down_patience: int = 4,
                 max_level: int = 5) -> None:
        if not 0.0 <= attain_low <= attain_high <= 1.0:
            raise ValueError("need 0 <= attain_low <= attain_high <= 1")
        if queue_low > queue_high:
            raise ValueError("need queue_low <= queue_high")
        self.attain_low = attain_low
        self.attain_high = attain_high
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.up_patience = max(int(up_patience), 1)
        self.down_patience = max(int(down_patience), 1)
        self.max_level = min(max(int(max_level), 0), len(self.LEVELS) - 1)
        self.level = 0
        self._hot = 0
        self._cool = 0

    @property
    def name(self) -> str:
        return self.LEVELS[self.level]

    def update(self, attainment: Optional[float], queue_depth: int,
               capacity: int) -> int:
        """Feed this tick's signals; returns the (possibly new) level."""
        pressure = queue_depth / max(capacity, 1)
        hot = (pressure > self.queue_high
               or (attainment is not None and attainment < self.attain_low))
        cool = (pressure <= self.queue_low
                and (attainment is None
                     or attainment >= self.attain_high))
        if hot:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.up_patience and self.level < self.max_level:
                self.level += 1
                self._hot = 0
        elif cool:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.down_patience and self.level > 0:
                self.level -= 1
                self._cool = 0
        else:  # dead band: hold, decay patience
            self._hot = 0
            self._cool = 0
        return self.level


# --------------------------------------------------------------------------
# Crash-storm circuit breaker
# --------------------------------------------------------------------------

class CircuitBreaker:
    """closed -> open -> half_open -> closed breaker on the tick clock.

    Faults (crashes + retry enqueues) are recorded into a sliding
    window of ticks.  When the windowed total reaches ``threshold`` the
    breaker opens: new admissions pause (the engine still lets crash
    victims re-admit, so recovery drains instead of starving).  After
    ``cooldown`` ticks it half-opens and admits up to ``probe_admits``
    fresh requests per tick; a fault during the probe re-opens it, and
    ``probe_ticks`` quiet ticks close it and clear the window.
    """

    def __init__(self, *,
                 threshold: int = 3,
                 window: int = 8,
                 cooldown: int = 6,
                 probe_ticks: int = 3,
                 probe_admits: int = 1) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.window = max(int(window), 1)
        self.cooldown = max(int(cooldown), 1)
        self.probe_ticks = max(int(probe_ticks), 1)
        self.probe_admits = max(int(probe_admits), 0)
        self.state = "closed"
        self.transitions: List[Tuple[int, str]] = []
        self._events: Deque[Tuple[int, int]] = deque()
        self._opened_at = 0
        self._half_at = 0

    def _windowed(self, tick: int) -> int:
        while self._events and self._events[0][0] <= tick - self.window:
            self._events.popleft()
        return sum(n for _, n in self._events)

    def update(self, tick: int, faults: int = 0) -> Optional[str]:
        """Feed this tick's fault count; returns a transition name
        ("open" / "half_open" / "closed") when the state changes."""
        if faults > 0:
            self._events.append((tick, faults))
        if self.state == "closed":
            if self._windowed(tick) >= self.threshold:
                self.state = "open"
                self._opened_at = tick
                self.transitions.append((tick, "open"))
                return "open"
        elif self.state == "open":
            if tick - self._opened_at >= self.cooldown:
                self.state = "half_open"
                self._half_at = tick
                self.transitions.append((tick, "half_open"))
                return "half_open"
        elif self.state == "half_open":
            if faults > 0:
                self.state = "open"
                self._opened_at = tick
                self.transitions.append((tick, "open"))
                return "open"
            if tick - self._half_at >= self.probe_ticks:
                self.state = "closed"
                self._events.clear()
                self.transitions.append((tick, "closed"))
                return "closed"
        return None

    def admit_limit(self) -> Optional[int]:
        """Per-tick cap on *fresh* admissions: None = unlimited,
        0 = paused (recovery traffic only), k = probe budget."""
        if self.state == "open":
            return 0
        if self.state == "half_open":
            return self.probe_admits
        return None


__all__ = ["TokenBucket", "Rejection", "AdmissionController",
           "DegradationLadder", "CircuitBreaker"]
