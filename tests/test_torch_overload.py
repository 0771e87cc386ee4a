"""SLO-aware overload control in the port against the JAX package: the unit
tests of tests/test_overload.py on the port's own `serve/overload.py`,
`obs/slo.py` and `faults.py`, and its serving-engine tests through both
packages.

The engine tests drive both engines on the tick clock of
tests/test_overload.py (one tick is one simulated second, so TTFT, TPOT
and SLO attainment do not depend on wall time) or, where the reference
test does, through `run()`.  Both run the smoke smollm-360m in fp32 on the
same parameters; the port runs on the CPU with `debug_checks`.  Token
streams, request states, retry-after hints, the `summarize` counters (on
the tick clock every key but the JAX engine's jit-cache sizes) and the
fault, recovery, brownout and breaker event lists must be equal.  The
disaggregated and cluster tests of tests/test_overload.py wait for those
layers (ROADMAP A6, A8)."""

import contextlib

import jax
import numpy as np
import pytest
import torch

import repro.faults as JF
import repro_torch.faults as TF
from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.models import model as JM
from repro.obs import SLOTracker as JSLOTracker
from repro.serve import (AdmissionController as JAdmissionController,
                         CircuitBreaker as JCircuitBreaker,
                         DegradationLadder as JDegradationLadder,
                         ServeEngine, TokenBucket as JTokenBucket,
                         synthetic_requests)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import model as TM
from repro_torch.obs import SLOTracker, Tracer, meets_slo, overload_timeline
from repro_torch.serve import (AdmissionController, CircuitBreaker,
                               DegradationLadder, RequestState,
                               TokenBucket)
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests
from repro_torch.serve.scheduler import SlotScheduler

ARCH = "smollm-360m"
KW = dict(capacity=4, cache_len=32, prefill_bucket=8, seed=0)
# the JAX engine's compile-cache bookkeeping has no counterpart
NOT_COMPARED = {"jit_cache_sizes"}
# keys that carry wall time when an engine runs on the wall clock
WALL = {"tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
        "tpot_p99_s", "queue_delay_p50_s", "queue_delay_p99_s",
        "handoff_delay_p50_s", "handoff_delay_p99_s", "slo_met", "goodput",
        "wall_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines here run thousands of tiny CPU ops: one intra-op thread
    each keeps them from contending with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = smoke_variant(get_config(ARCH))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(ARCH))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


def _burst(make, vocab, n=8, seed=0, prompt=(6, 16), max_new=(5, 9)):
    return make(n, vocab_size=vocab, arrivals=np.zeros(n),
                prompt_len=prompt, max_new_tokens=max_new,
                rng=np.random.default_rng(seed))


def _streams(metrics, *, finished_only=True):
    return {r.rid: list(r.generated) for r in metrics.requests
            if not finished_only or r.state.name == "FINISHED"}


def _mesh(eng):
    """The JAX engine ticks inside its mesh; the port has none."""
    return (set_mesh(eng.mesh) if isinstance(eng, ServeEngine)
            else contextlib.nullcontext())


def _busy(eng):
    return (eng.scheduler.has_pending or eng._by_slot or eng._prefilling
            or eng._retrying)


def _drive(eng, reqs, *, max_ticks=500, each=None):
    """Tick-clock drive: 1 tick = 1 simulated second (deterministic TTFT/
    TPOT for SLO assertions; engines built with clock=... can't use
    run()).  `each(eng)` runs after every tick."""
    eng.submit(reqs)
    with _mesh(eng):
        while _busy(eng) and eng._tick < max_ticks:
            eng._clk = float(eng._tick)
            eng.tick()
            if each is not None:
                each(eng)
    eng.metrics.wall_s = float(eng._tick)
    return eng.metrics


def _tick_engine(eng_cls, c, **kw):
    """A ServeEngine on an injected tick clock (see _drive)."""
    holder = {}
    eng = eng_cls(c, clock=lambda: holder["e"]._clk, **kw)
    eng._clk = 0.0
    holder["e"] = eng
    return eng


def _sides(model):
    """(engine class, config, params, request factory, extra keywords) for
    the JAX package, then the port."""
    cfg, params, tcfg, tparams = model
    return ((ServeEngine, cfg, params, synthetic_requests, {}),
            (TServeEngine, tcfg, tparams, t_synthetic_requests,
             dict(device="cpu", debug_checks=True)))


def _record(metrics):
    return ({r.rid: list(r.generated) for r in metrics.requests},
            {r.rid: (r.state.name, r.retries, r.retry_after)
             for r in metrics.requests},
            (metrics.fault_events, metrics.recovery_events,
             metrics.brownout_events, metrics.breaker_events))


def _assert_same(jm, tm, *, tick_clock):
    """Equal streams, request records, event lists and summaries (on the
    wall clock, the wall-time-free keys only)."""
    assert _record(tm) == _record(jm)
    skip = NOT_COMPARED | (set() if tick_clock else WALL)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: v for k, v in ts.items() if k not in skip} == \
        {k: v for k, v in js.items() if k not in skip}


def _both_ticked(model, workload, *, make_kw=None, each=None, **kw):
    """Both engines on the tick clock over the same workload -> (jax engine,
    jax metrics, port engine, port metrics).  `make_kw(side)` adds
    keywords built from one side's modules (0 = JAX, 1 = port)."""
    out = []
    for i, (cls, c, p, make, extra) in enumerate(_sides(model)):
        more = make_kw(i) if make_kw is not None else {}
        eng = _tick_engine(cls, c, params=p, **kw, **more, **extra)
        out.append((eng, _drive(eng, workload(make, c.vocab_size),
                                each=each)))
    (jeng, jm), (teng, tm) = out
    _assert_same(jm, tm, tick_clock=True)
    return jeng, jm, teng, tm


def _both_run(model, workload, *, make_kw=None, **kw):
    """Both engines through run() (wall clock) -> the same tuple."""
    out = []
    for i, (cls, c, p, make, extra) in enumerate(_sides(model)):
        more = make_kw(i) if make_kw is not None else {}
        eng = cls(c, params=p, **kw, **more, **extra)
        out.append((eng, eng.run(workload(make, c.vocab_size))))
    (jeng, jm), (teng, tm) = out
    _assert_same(jm, tm, tick_clock=False)
    return jeng, jm, teng, tm


# ---------------------------------------------------------------------------
# Token bucket + admission controller (host-only units)
# ---------------------------------------------------------------------------


def test_token_bucket_refill_property():
    """Seeded fuzz: over any arrival sequence, tokens stay in [0, burst]
    and the number of admits can never exceed burst + rate * elapsed; the
    JAX package's bucket takes the same decisions."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        rate = float(rng.uniform(0.5, 8.0))
        burst = int(rng.integers(1, 6))
        b, ref = TokenBucket(rate, burst), JTokenBucket(rate, burst)
        now, admits = 0.0, 0
        for _ in range(200):
            now += float(rng.exponential(0.3))
            took = b.try_take(now)
            assert took == ref.try_take(now)
            admits += took
            assert 0.0 <= b.tokens <= burst + 1e-9
            assert b.tokens == ref.tokens
        assert admits <= burst + rate * now + 1e-6


def test_token_bucket_deterministic_and_clamped():
    b1, b2 = TokenBucket(2.0, 2), TokenBucket(2.0, 2)
    seq = [0.0, 0.1, 0.5, 0.4, 2.0]  # includes a non-monotonic step
    assert [b1.try_take(t) for t in seq] == [b2.try_take(t) for t in seq]
    b = TokenBucket(1.0, 1)
    assert b.try_take(10.0)
    b._refill(0.0)  # time going backwards must not mint tokens
    assert b.tokens < 1.0
    with pytest.raises(ValueError):
        TokenBucket(0.0, 1)
    with pytest.raises(ValueError):
        TokenBucket(1.0, 0)


def test_admission_controller_reasons_and_hints():
    for cls in (AdmissionController, JAdmissionController):
        ac = cls(tenant_rate=1.0, queue_cap=3)
        full = ac.check("a", 0.0, 3)
        assert full is not None and full.reason == "queue_full"
        assert full.retry_after > 0
        assert ac.check("a", 0.0, 0) is None  # burst token
        rated = ac.check("a", 0.0, 0)
        assert rated is not None and rated.reason == "rate"
        assert rated.retry_after > 0
        assert ac.rejected_queue == 1 and ac.rejected_rate == 1
        # per-tenant dict rates: an unlisted tenant is not rate-limited
        ac2 = cls(tenant_rate={"a": 1.0})
        assert ac2.check("b", 0.0, 10) is None
        assert not cls().enabled
    mine = AdmissionController(tenant_rate=2.0, queue_cap=2)
    ref = JAdmissionController(tenant_rate=2.0, queue_cap=2)
    got = [mine.check("t", 0.3 * i, i % 4) for i in range(20)]
    want = [ref.check("t", 0.3 * i, i % 4) for i in range(20)]
    assert [(g and (g.reason, g.retry_after)) for g in got] == \
        [(w and (w.reason, w.retry_after)) for w in want]


# ---------------------------------------------------------------------------
# Bounded queue + rejection accounting (engine)
# ---------------------------------------------------------------------------


def test_bounded_queue_cap_and_accounting(model):
    """The admission queue never exceeds its cap; every offered request is
    exactly one of finished/rejected; rejects carry a retry-after hint; the
    JAX engine rejects the same requests with the same hints."""
    def capped(eng):
        assert eng.scheduler.queue_len() <= 3

    _, _, teng, tm = _both_ticked(
        model, lambda make, v: _burst(make, v, n=10), each=capped,
        kv_layout="paged", n_workers=1, queue_cap=3, **KW)
    reqs = tm.requests
    states = [r.state for r in reqs]
    fin = sum(1 for s in states if s is RequestState.FINISHED)
    rej = sum(1 for s in states if s is RequestState.REJECTED)
    assert fin + rej == len(reqs) and rej > 0
    for r in reqs:
        if r.state is RequestState.REJECTED:
            assert r.retry_after is not None and r.retry_after > 0
            assert not r.generated  # rejected before any compute
    s = tm.summarize()
    assert s["rejected_requests"] == rej
    assert s["shed_requests"] == 0  # backpressure, not shedding


@pytest.mark.parametrize("layout", ["flat", "paged"])
def test_bit_identity_when_limits_never_bind(model, layout):
    """Generous limits + SLO tracking give the streams of an engine without
    overload control, on both layouts, in both packages."""
    loose = dict(tenant_rate=1000.0, queue_cap=1000,
                 slo_ttft=1e9, slo_tpot=1e9)
    _, _, tcfg, tparams = model
    want = _streams(TServeEngine(tcfg, params=tparams, device="cpu",
                                 kv_layout=layout, n_workers=1, **KW).run(
        _burst(t_synthetic_requests, tcfg.vocab_size)))
    _, _, _, tm = _both_run(model, _burst, kv_layout=layout, n_workers=1,
                            **loose, **KW)
    assert _streams(tm) == want
    assert sum(1 for r in tm.requests
               if r.state is RequestState.REJECTED) == 0
    assert tm.summarize()["slo_met"] == 8


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


def test_ladder_monotone_single_steps_and_hysteresis():
    lad = DegradationLadder(up_patience=2, down_patience=3)
    hot = lambda: lad.update(0.5, 20, 4)   # noqa: E731
    cool = lambda: lad.update(1.0, 0, 4)   # noqa: E731
    hold = lambda: lad.update(0.95, 4, 4)  # noqa: E731  dead band
    levels = [hot() for _ in range(20)]
    # at most one step per update, and never above max_level
    assert all(b - a <= 1 for a, b in zip(levels, levels[1:]))
    assert levels[-1] == 5 == lad.max_level
    # dead band holds the level indefinitely (no flapping)
    assert [hold() for _ in range(10)] == [5] * 10
    # de-escalation needs down_patience consecutive cool ticks
    assert cool() == 5 and cool() == 5 and cool() == 4
    # a single hot tick resets the cool streak (hysteresis)
    assert cool() == 4 and cool() == 4 and hot() == 4
    assert [cool() for _ in range(3)] == [4, 4, 3]
    # full recovery reaches normal
    for _ in range(30):
        cool()
    assert lad.level == 0 and lad.name == "normal"
    assert DegradationLadder.LEVELS == JDegradationLadder.LEVELS


def test_ladder_up_patience_gates_escalation():
    lad = DegradationLadder(up_patience=3, down_patience=1)
    assert lad.update(0.0, 99, 4) == 0
    assert lad.update(0.0, 99, 4) == 0
    assert lad.update(0.0, 99, 4) == 1  # third consecutive hot tick


@pytest.mark.parametrize("layout", ["flat", "paged"])
def test_brownout_engine_degrades_and_recovers(model, layout):
    """Under a burst the auto ladder escalates (traced, recorded) and comes
    back; finished streams equal the unthrottled speculative run (levels
    1-3 trade latency, never content) and the JAX engine's, transition for
    transition."""
    _, _, tcfg, tparams = model
    want = _streams(TServeEngine(
        tcfg, params=tparams, device="cpu", kv_layout=layout, n_workers=1,
        spec="ngram", spec_k=4, **KW).run(
            _burst(t_synthetic_requests, tcfg.vocab_size, n=12)))
    tracer = Tracer(name="brownout-test")

    def ladder(side):
        # capped below park/shed, so every finished stream must match
        cls = (JDegradationLadder, DegradationLadder)[side]
        return dict(ladder=cls(up_patience=1, down_patience=2,
                               max_level=3),
                    **({"tracer": tracer} if side else {}))

    _, _, teng, tm = _both_ticked(
        model, lambda make, v: _burst(make, v, n=12), make_kw=ladder,
        kv_layout=layout, n_workers=1, spec="ngram", spec_k=4,
        brownout="auto", slo_ttft=2.0, slo_tpot=1.0, **KW)
    s = tm.summarize()
    assert s["brownout_level_max"] >= 1
    assert s["brownout_events"], "transitions must be recorded"
    assert _streams(tm) == want
    names = {e.name for e in tracer.events if e.track == "overload"}
    assert "degrade.enter" in names
    # transitions are (tick, level, label) and strictly ordered
    ticks = [t for t, _, _ in s["brownout_events"]]
    assert ticks == sorted(ticks)


def test_brownout_forced_level_bit_equal_to_static_oracle(model):
    """At a pinned ladder level the engine equals an engine configured that
    way from the start (level 3 = spec off + chunk width capped at one
    page), in both packages."""

    def pinned(side):
        base = (JDegradationLadder, DegradationLadder)[side]

        class Pinned(base):
            def update(self, attainment, queue_depth, capacity):
                self.level = 3
                return 3

        return dict(ladder=Pinned())

    _, _, teng, tm = _both_ticked(
        model, _burst, make_kw=pinned, kv_layout="paged", n_workers=1,
        spec="ngram", spec_k=4, brownout="auto", chunked_prefill=True,
        prefill_chunk=16, page_size=8, **KW)
    _, _, tcfg, tparams = model
    oracle = TServeEngine(tcfg, params=tparams, device="cpu",
                          kv_layout="paged", n_workers=1,
                          chunked_prefill=True, prefill_chunk=8, page_size=8,
                          **KW).run(_burst(t_synthetic_requests,
                                           tcfg.vocab_size))
    assert _streams(tm) == _streams(oracle)
    assert teng.spec_k == 0 and teng.drafter is None
    assert teng.prefill_chunk == 8


def test_ladder_walks_back_to_the_base_configuration(model):
    """`_apply_degradation` is a function of (base configuration, level):
    every level's spec_k, drafter and chunk width, and level 0 again after
    the climb, on the port as on the JAX engine."""
    cfg, params, tcfg, tparams = model
    kw = dict(kv_layout="paged", spec="ngram", spec_k=4, prefill_chunk=16,
              page_size=8, **KW)
    mine = TServeEngine(tcfg, params=tparams, device="cpu", **kw)
    ref = ServeEngine(cfg, params=params, **kw)
    drafter = mine.drafter
    for lvl in (1, 2, 3, 4, 5, 2, 1, 0):
        mine._apply_degradation(lvl)
        ref._apply_degradation(lvl)
        assert (mine.spec_k, mine.drafter is None, mine.prefill_chunk) == \
            (ref.spec_k, ref.drafter is None, ref.prefill_chunk)
    assert (mine.spec_k, mine.drafter, mine.prefill_chunk) == \
        (4, drafter, 16)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_unit_transitions():
    br = CircuitBreaker(threshold=3, window=4, cooldown=2, probe_ticks=2,
                        probe_admits=1)
    assert br.update(0, 1) is None and br.state == "closed"
    assert br.update(1, 1) is None
    assert br.update(2, 1) == "open" and br.admit_limit() == 0
    assert br.update(3, 0) is None  # cooling down
    assert br.update(4, 0) == "half_open" and br.admit_limit() == 1
    # a fault during the probe re-opens
    assert br.update(5, 1) == "open"
    assert br.update(7, 0) == "half_open"
    assert br.update(8, 0) is None
    assert br.update(9, 0) == "closed" and br.admit_limit() is None
    # window cleared on close: one old fault doesn't instantly re-open
    assert br.update(10, 1) is None and br.state == "closed"


def test_breaker_window_expires_old_faults():
    br = CircuitBreaker(threshold=2, window=2)
    assert br.update(0, 1) is None
    assert br.update(5, 1) is None, "faults outside the window must expire"
    assert br.state == "closed"


def test_breaker_prevents_retry_storm(model):
    """Scripted 3-crash storm on the same worker: with the breaker armed,
    retry re-executions drop and recovery does not regress; every request
    still finishes, with the same streams, in both packages."""

    def run(with_breaker):
        def plan(side):
            F = (JF, TF)[side]
            br_cls = (JCircuitBreaker, CircuitBreaker)[side]
            return dict(
                fault_injector=F.FaultInjector(F.FaultPlan(
                    F.crash_storm(2, 3, 3, worker=0))),
                breaker=(br_cls(threshold=2, window=8, cooldown=5,
                                probe_ticks=2) if with_breaker else None))

        _, _, _, tm = _both_run(
            model, lambda make, v: _burst(make, v, n=16, max_new=(8, 12)),
            make_kw=plan, kv_layout="paged", n_workers=4, capacity=4,
            cache_len=32, prefill_bucket=8, seed=0, slots_per_chunk=1,
            retry_jitter=False)
        return tm.summarize(), _streams(tm)

    plain, streams_plain = run(False)
    braked, streams_braked = run(True)
    assert streams_plain == streams_braked
    assert braked["requests_finished"] == plain["requests_finished"] == 16
    assert plain["shed_requests"] == braked["shed_requests"] == 0
    assert braked["retries_total"] < plain["retries_total"]
    assert braked["recovery_ticks_mean"] <= plain["recovery_ticks_mean"]
    kinds = [k for _, k in braked["breaker_events"]]
    assert kinds[0] == "open" and "half_open" in kinds
    assert braked["breaker_events"][-1][1] == "closed"


def test_crash_storm_helper_validates():
    evs = TF.crash_storm(4, n=3, every=2, worker=1, pool="decode")
    assert [(e.at, e.target, e.payload.get("pool")) for e in evs] == \
        [(4, 1, "decode"), (6, 1, "decode"), (8, 1, "decode")]
    assert [e.to_dict() for e in evs] == [
        e.to_dict() for e in JF.crash_storm(4, n=3, every=2, worker=1,
                                            pool="decode")]
    with pytest.raises(ValueError):
        TF.crash_storm(0, n=0)
    with pytest.raises(ValueError):
        TF.crash_storm(0, every=0)


# ---------------------------------------------------------------------------
# Jittered retry backoff
# ---------------------------------------------------------------------------


def test_jittered_backoff_deterministic_and_desynchronized(model):
    """Jitter draws from the engine rng: deterministic per seed, the JAX
    engine's draws, and a multi-victim crash spreads re-admissions over
    distinct ticks."""
    cfg, params, tcfg, tparams = model

    def backoffs(seed, jax_side=False):
        eng = (ServeEngine(cfg, params=params, kv_layout="paged",
                           n_workers=1, **{**KW, "seed": seed})
               if jax_side else
               TServeEngine(tcfg, params=tparams, device="cpu",
                            kv_layout="paged", n_workers=1,
                            **{**KW, "seed": seed}))
        return [eng._backoff_ticks(r) for r in (3, 1, 2, 3, 3, 1, 2, 3)]

    assert backoffs(0) == backoffs(0)
    assert backoffs(0) != backoffs(1)
    assert backoffs(0) == backoffs(0, jax_side=True)
    assert backoffs(1) == backoffs(1, jax_side=True)
    eng = TServeEngine(tcfg, params=tparams, device="cpu", kv_layout="paged",
                       n_workers=1, **KW)
    draws = {eng._backoff_ticks(3) for _ in range(16)}
    base = eng.retry_backoff * 4
    assert all(1 <= d <= int(base * 1.5) + 1 for d in draws)
    assert len(draws) > 1, "jitter must desynchronize a victim cohort"
    eng.retry_jitter = False
    assert eng._backoff_ticks(3) == base


# ---------------------------------------------------------------------------
# Deadline sweeps: parked requests
# ---------------------------------------------------------------------------


def test_parked_past_deadline_is_shed_and_pages_freed(model):
    """A PARKED request whose deadline passes while its KV sits on host is
    shed at the next tick and its parked payload freed (no page leak), in
    both packages alike."""
    out = []
    for cls, c, p, make, extra in _sides(model):
        eng = _tick_engine(cls, c, params=p, kv_layout="paged", n_workers=1,
                           evict=True, **KW, **extra)
        reqs = _burst(make, c.vocab_size, n=4, max_new=(8, 10))
        eng.submit(reqs)
        with _mesh(eng):
            while not eng._by_slot and eng._tick < 50:
                eng._clk = float(eng._tick)
                eng.tick()
            victim = next(iter(eng._by_slot.values()))
            eng.park_excess(1)
            assert victim.state.name == "PARKED"
            assert eng.mem.n_parked == 1
            victim.deadline = 1e-9  # already blown relative to arrival 0
            eng._clk = float(eng._tick)
            eng.tick()
            assert victim.state.name == "EXPIRED"
            assert eng.mem.n_parked == 0
            while _busy(eng) and eng._tick < 500:
                eng._clk = float(eng._tick)
                eng.tick()
        eng.metrics.wall_s = float(eng._tick)
        assert all(r.state.name == "FINISHED" for r in reqs
                   if r is not victim)
        out.append(eng.metrics)
    _assert_same(*out, tick_clock=True)


# ---------------------------------------------------------------------------
# SLO tracker
# ---------------------------------------------------------------------------


def test_slo_tracker_windows_and_tenants():
    t = SLOTracker(ttft_target=1.0, tpot_target=0.5, window=4)
    assert t.attainment() is None  # empty window
    for ttft in (0.5, 0.5, 2.0, 0.5):
        t.observe(ttft=ttft, tpot=0.1)
    assert t.attainment() == 0.75
    assert t.ttft_attainment() == 0.75 and t.tpot_attainment() == 1.0
    for _ in range(4):  # window slides: old miss forgotten
        t.observe(ttft=0.5, tpot=0.1)
    assert t.attainment() == 1.0
    t.observe(tenant="vip", ttft=9.0, tpot=0.1)
    assert t.tenant_attainment("vip") == 0.0
    # per-request override beats the default target
    assert t.observe(ttft=5.0, tpot=0.1, ttft_target=10.0)
    assert meets_slo(0.5, None, 1.0, 0.5)  # tpot exempt until measurable
    assert not meets_slo(2.0, 0.1, 1.0, 0.5)
    # a seeded stream of finishes scores as the JAX package's tracker does
    rng = np.random.default_rng(3)
    mine = SLOTracker(ttft_target=1.0, tpot_target=0.2, window=8)
    ref = JSLOTracker(ttft_target=1.0, tpot_target=0.2, window=8)
    for _ in range(50):
        kw = dict(tenant=str(rng.integers(3)), ttft=float(rng.uniform(0, 2)),
                  tpot=float(rng.uniform(0, 0.4)))
        assert mine.observe(**kw) == ref.observe(**kw)
        assert mine.attainment() == ref.attainment()


def test_slo_tracker_traces_misses():
    tracer = Tracer(name="slo-test")
    t = SLOTracker(ttft_target=1.0, tracer=tracer)
    t.observe(rid=7, ttft=5.0)
    tl = overload_timeline(tracer)
    assert tl["counts"].get("slo.miss") == 1
    assert tl["timeline"][0][2]["rid"] == 7


def test_scheduler_allow_bypass_skips_paused_heads(model):
    """The `allow` filter admits the first MATCHING request per tenant
    queue, not just the head: a paused fresh head must not head-of-line
    block a crash victim queued behind it (recovery bypass)."""
    vocab = model[2].vocab_size
    fresh, victim = _burst(t_synthetic_requests, vocab, n=2, max_new=(4, 5))
    victim.retries = 1
    victim.arrival_time = fresh.arrival_time + 0.25  # behind the head
    sched = SlotScheduler(4, n_workers=1)
    sched.submit(fresh)
    sched.submit(victim)
    got = sched.admit(1.0, allow=lambda r: r.retries > 0)
    assert got == [victim]
    assert sched.pending == [fresh]  # fresh head untouched, still FCFS
    # no filter: plain FCFS order is unchanged by the bypass machinery
    sched2 = SlotScheduler(4, n_workers=1)
    f2, v2 = _burst(t_synthetic_requests, vocab, n=2, max_new=(4, 5))
    v2.retries, v2.arrival_time = 1, f2.arrival_time + 0.25
    sched2.submit(f2)
    sched2.submit(v2)
    assert sched2.admit(1.0) == [f2, v2]


def test_breaker_open_holds_retries_then_drains(model):
    """An OPEN breaker holds crash victims in backoff (no requeue: they
    must not feed the next crash) and pauses fresh admission; at half-open
    the probe window re-admits them and the run completes, in both
    packages alike."""
    out = []
    for i, (cls, c, p, make, extra) in enumerate(_sides(model)):
        br_cls = (JCircuitBreaker, CircuitBreaker)[i]
        eng = _tick_engine(cls, c, params=p, kv_layout="paged", n_workers=2,
                           breaker=br_cls(threshold=1, window=4, cooldown=4,
                                          probe_ticks=2), **KW, **extra)
        reqs = _burst(make, c.vocab_size, n=6, max_new=(6, 8))
        eng.submit(reqs)
        with _mesh(eng):
            while not eng._by_slot and eng._tick < 50:
                eng._clk = float(eng._tick)
                eng.tick()
            eng.crash_worker()
            victims = [r for r in reqs if r.retries > 0]
            assert victims
            eng._clk = float(eng._tick)
            eng.tick()  # breaker sees the fault and opens
            assert eng.breaker.state == "open"
            held = len(eng._retrying)
            assert held == len(victims)
            q_open = eng.scheduler.queue_len()
            for _ in range(2):  # still open: nothing moves
                eng._clk = float(eng._tick)
                eng.tick()
                if eng.breaker.state != "open":
                    break
                assert len(eng._retrying) == held
                assert eng.scheduler.queue_len() == q_open
            while _busy(eng) and eng._tick < 500:
                eng._clk = float(eng._tick)
                eng.tick()
        eng.metrics.wall_s = float(eng._tick)
        assert eng.breaker.state == "closed"
        assert all(r.state.name == "FINISHED" for r in reqs)
        out.append(eng.metrics)
    _assert_same(*out, tick_clock=True)
