"""Fault injection and crash recovery in the port against the JAX package:
the serving tests of tests/test_faults.py, on both KV layouts where the
test is not about pages.

Both engines run the smoke smollm-360m in fp32 on the same parameters (the
JAX tree carried across by `params_from_numpy`), the same workload and the
same fault plan (each side builds it from its own `faults` module); the
port runs on the CPU with `debug_checks`.  Token streams, request states,
retry counts, every wall-time-free `summarize` counter, the fault and
recovery event lists and the injected fault sequence must be equal, and a
recovered stream must equal the port's fault-free run.  The disaggregated
and cluster tests of tests/test_faults.py wait for those layers
(ROADMAP A6, A8)."""

import contextlib

import jax
import numpy as np
import pytest
import torch

import repro.faults as JF
import repro_torch.faults as TF
from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.models import model as JM
from repro.serve import Request, ServeEngine, synthetic_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import ElasticScalingPolicy as TElasticScalingPolicy
from repro_torch.core import ScaleEvent as TScaleEvent
from repro_torch.models import model as TM
from repro_torch.serve import Request as TRequest
from repro_torch.serve import RequestState as TRequestState
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"
LAYOUTS = ["flat", "paged"]
KW = dict(capacity=4, cache_len=32, prefill_bucket=8, seed=0)
# summarize() keys that carry no wall time (jit_cache_sizes is the JAX
# engine's compile-cache bookkeeping and has no counterpart)
COUNTERS = ["requests_finished", "requests_total", "tokens_generated",
            "n_ticks", "prefill_chunks_total", "prefill_dispatches_total",
            "admission_bytes_total", "meta_transfers_total",
            "decode_dispatches", "draft_dispatches", "tokens_per_dispatch",
            "spec_drafted_total", "spec_accepted_total",
            "spec_acceptance_rate", "shared_page_hits_total",
            "cow_breaks_total", "parked_total", "restored_total",
            "kv_moved_bytes_total", "shared_extra_pages_mean",
            "occupancy_mean", "page_occupancy_mean", "kv_stats",
            "scale_events", "resize_moved_bytes_total", "requeued_total",
            "recoveries", "retries_total", "shed_requests", "crashes_total",
            "recovery_ticks_mean", "recovery_events", "rejected_requests",
            "slo_ttft_target", "slo_tpot_target", "brownout_events",
            "breaker_events", "brownout_level_max"]
JAX_SIDE = (synthetic_requests, Request, JF, ElasticScalingPolicy,
            ScaleEvent)
PORT_SIDE = (t_synthetic_requests, TRequest, TF, TElasticScalingPolicy,
             TScaleEvent)


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


def _burst(side, vocab, n=8, seed=0, prompt=(6, 16), max_new=(5, 9)):
    return side[0](n, vocab_size=vocab, arrivals=np.zeros(n),
                   prompt_len=prompt, max_new_tokens=max_new,
                   rng=np.random.default_rng(seed))


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _request_record(metrics):
    """Per request: state, retries and the retry-after hint."""
    return {r.rid: (r.state.name, r.retries, r.retry_after)
            for r in metrics.requests}


def _events(metrics):
    return (metrics.fault_events, metrics.recovery_events,
            metrics.brownout_events, metrics.breaker_events)


def _port_oracle(model, workload, **kw):
    """The port's fault-free run of the same workload (flat, one worker)."""
    _, _, tcfg, tparams = model
    eng = TServeEngine(tcfg, params=tparams, device="cpu", kv_layout="flat",
                       n_workers=1, **{**KW, **kw})
    return _streams(eng.run(workload(PORT_SIDE, tcfg.vocab_size)))


def _run_both(model, workload, *, faults=None, events=None, jax_kw=None,
              port_kw=None, **kw):
    """The same engine keywords, workload, fault plan (`faults(module)`
    builds an injector from one side's `faults` module) and scale events
    through both packages -> (jax engine, jax metrics, port engine, port
    metrics, jax injector, port injector); asserts equal streams, request
    records, counters and event lists."""
    cfg, params, tcfg, tparams = model
    out = []
    for side, eng_cls, c, p, extra in (
            (JAX_SIDE, ServeEngine, cfg, params, jax_kw or {}),
            (PORT_SIDE, TServeEngine, tcfg, tparams,
             dict(device="cpu", debug_checks=True, **(port_kw or {})))):
        inj = faults(side[2]) if faults is not None else None
        pol = ([side[3]([side[4](*e) for e in events])] if events else [])
        eng = eng_cls(c, params=p, policies=pol, fault_injector=inj, **kw,
                      **extra)
        out.append((eng, eng.run(workload(side, c.vocab_size)), inj))
    (jeng, jm, jinj), (teng, tm, tinj) = out
    assert _streams(tm) == _streams(jm)
    assert _request_record(tm) == _request_record(jm)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert _events(tm) == _events(jm)
    # the backoff jitter drew from the engine rng as often as the JAX
    # engine's did
    assert teng.rng.bit_generator.state == jeng.rng.bit_generator.state
    if jinj is not None:
        assert [(e.at, e.kind, e.target, e.factor) for e in tinj.injected] \
            == [(e.at, e.kind, e.target, e.factor) for e in jinj.injected]
    if teng.pages is not None:
        teng.pages.check_invariants()
        assert teng.pages.n_used == 0  # every page returned
    assert teng.scheduler.pool.n_used == 0
    assert not teng._retrying and not teng._recovering
    return jeng, jm, teng, tm, jinj, tinj


def _crash_at(tick, **kw):
    return lambda F: F.FaultInjector(F.FaultPlan([F.worker_crash(tick,
                                                                 **kw)]))


def _burst_wl(**kw):
    return lambda side, v: _burst(side, v, **kw)


# ---------------------------------------------------------------------------
# Crash recovery: bit-equal re-execution
# ---------------------------------------------------------------------------


def test_paged_crash_recovery_bit_equal(model):
    want = _port_oracle(model, _burst_wl())
    _, _, teng, tm, _, _ = _run_both(model, _burst_wl(), faults=_crash_at(3),
                                     kv_layout="paged", n_workers=2, **KW)
    assert _streams(tm) == want
    s = tm.summarize()
    assert s["crashes_total"] == 1
    assert s["recoveries"] == 1
    assert s["retries_total"] >= 1
    assert s["shed_requests"] == 0
    assert s["recovery_ticks_mean"] > 0
    assert teng.k == 1  # shrank by the crashed worker


def test_flat_layout_crash_recovery(model):
    want = _port_oracle(model, _burst_wl())
    _, _, _, tm, _, _ = _run_both(model, _burst_wl(), faults=_crash_at(2),
                                  kv_layout="flat", n_workers=2, **KW)
    assert _streams(tm) == want
    assert tm.summarize()["crashes_total"] == 1


def test_crash_mid_chunked_prefill_bit_equal(model):
    """A crash while prompts are mid-chunked-prefill restarts them cleanly:
    no partial KV survives, no page leaks, and the prefix index and the
    refcounts come out as the JAX engine's (`kv_stats`)."""
    wl = _burst_wl(n=4, prompt=(40, 60), max_new=(3, 5))
    big = dict(capacity=4, cache_len=96, prefill_bucket=8, seed=0)
    want = _port_oracle(model, wl, **big)
    _, _, teng, tm, _, _ = _run_both(model, wl, faults=_crash_at(1),
                                     kv_layout="paged", n_workers=2,
                                     prefill_chunk=8, **big)
    assert _streams(tm) == want
    s = tm.summarize()
    assert s["crashes_total"] == 1
    # the crash landed while chunks were in flight: its victims had no
    # token yet, and every chunk of theirs was prefilled again
    assert s["prefill_chunks_total"] > sum(
        -(-len(r.prompt) // 8) for r in tm.requests)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_crash_same_tick_as_resize_is_deterministic(model, layout):
    """The fault phase runs BEFORE the scheduler: a crash on the tick of a
    scale event has a fixed, replayable order."""
    want = _port_oracle(model, _burst_wl())
    kw = dict(kv_layout=layout, n_workers=2, **KW)
    _, jm, _, tm, _, _ = _run_both(model, _burst_wl(), faults=_crash_at(3),
                                   events=[(0, 2), (3, 3)], **kw)
    assert _streams(tm) == want
    # and a second port run replays the first
    _, _, tcfg, tparams = model
    again = TServeEngine(
        tcfg, params=tparams, device="cpu", debug_checks=True,
        policies=[TElasticScalingPolicy([TScaleEvent(0, 2),
                                         TScaleEvent(3, 3)])],
        fault_injector=_crash_at(3)(TF), **kw).run(
            _burst(PORT_SIDE, tcfg.vocab_size))
    s, s2 = tm.summarize(), again.summarize()
    assert (_streams(again), s2["retries_total"], s2["recovery_events"]) \
        == (_streams(tm), s["retries_total"], s["recovery_events"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jittered_backoff_bit_equal_and_seeded(model, layout):
    """Retry-backoff jitter (on by default) draws from the engine rng in
    the JAX engine's order: the same seed gives the JAX engine's retry
    ticks, and the recovered streams equal the crash-free run."""
    for seed in (0, 1):
        kw = dict(KW, seed=seed)
        _, _, teng, tm, _, _ = _run_both(
            model, _burst_wl(), faults=_crash_at(3), kv_layout=layout,
            n_workers=2, retry_backoff=4, **kw)
        assert teng.retry_jitter  # the default
        assert _streams(tm) == _port_oracle(model, _burst_wl(), seed=seed)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_worker_slow_keeps_streams_and_feeds_stats(model, layout):
    want = _port_oracle(model, _burst_wl())
    _, _, teng, tm, _, _ = _run_both(
        model, _burst_wl(),
        faults=lambda F: F.FaultInjector(F.FaultPlan([F.worker_slow(2, 0,
                                                                    3.0)])),
        kv_layout=layout, n_workers=2, **KW)
    assert _streams(tm) == want  # stragglers never change token streams
    assert ("worker_slow", 0) in [(k, t) for _, k, t in tm.fault_events]
    assert teng._slow_factors == {0: 3.0}
    # the slow factor reaches the per-worker stats the policies read
    t = teng._last_stats["per_sample_times"]
    assert t[0] == 3.0 * t[1]


def test_slow_worker_cleared_by_factor_one(model):
    """A `worker_slow` with factor 1.0 clears an earlier one (the `faults`
    phase of chip_smoke.py slows a worker, then clears it)."""
    plan = lambda F: F.FaultInjector(F.FaultPlan(  # noqa: E731
        [F.worker_slow(1, 1, 2.0), F.worker_slow(4, 1, 1.0)]))
    _, _, teng, tm, _, _ = _run_both(model, _burst_wl(), faults=plan,
                                     kv_layout="paged", n_workers=2, **KW)
    assert teng._slow_factors == {}
    assert [(t, k, w) for t, k, w in tm.fault_events] == \
        [(1, "worker_slow", 1), (4, "worker_slow", 1)]


# ---------------------------------------------------------------------------
# Retry budgets + deadline shedding
# ---------------------------------------------------------------------------


def _with(**attrs):
    def wl(side, v):
        reqs = _burst(side, v)
        for r in reqs:
            for k, val in attrs.items():
                setattr(r, k, val)
        return reqs
    return wl


@pytest.mark.parametrize("layout", LAYOUTS)
def test_retry_budget_exhaustion_sheds(model, layout):
    _, _, _, tm, _, _ = _run_both(model, _with(max_retries=0),
                                  faults=_crash_at(3), kv_layout=layout,
                                  n_workers=2, **KW)
    s = tm.summarize()
    assert s["shed_requests"] >= 1
    assert s["retries_total"] == 0
    expired = [r for r in tm.requests if r.state is TRequestState.EXPIRED]
    assert len(expired) == s["shed_requests"]
    assert s["requests_finished"] + s["shed_requests"] == 8
    # shed requests hold nothing: no slot, no generated tail left behind
    assert all(r.slot is None and not r.generated for r in expired)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_deadline_shedding_at_admission(model, layout):
    wl = lambda side, v: [  # noqa: E731
        setattr(r, "deadline", -1.0) or r
        for r in _burst(side, v, n=6)]  # already expired on arrival
    _, _, teng, tm, _, _ = _run_both(model, wl, kv_layout=layout,
                                     n_workers=1, **KW)
    s = tm.summarize()
    assert s["shed_requests"] == 6 and s["requests_finished"] == 0
    assert all(r.state is TRequestState.EXPIRED for r in tm.requests)
    assert teng.scheduler.pool.n_used == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_seeded_fault_plan_is_deterministic(model, layout):
    plan = lambda F: F.FaultInjector(  # noqa: E731
        F.FaultPlan(seed=5, p_crash=0.3, max_random=1))
    _, _, _, tm, _, tinj = _run_both(model, _burst_wl(), faults=plan,
                                     kv_layout=layout, n_workers=2, **KW)
    assert tinj.injected, "p_crash=0.3 over a full run should have fired"
    _, _, tcfg, tparams = model
    inj2 = plan(TF)
    again = TServeEngine(tcfg, params=tparams, device="cpu",
                         kv_layout=layout, n_workers=2, fault_injector=inj2,
                         **KW).run(_burst(PORT_SIDE, tcfg.vocab_size))
    assert _streams(again) == _streams(tm)
    assert [(e.at, e.kind, e.target) for e in inj2.injected] == \
        [(e.at, e.kind, e.target) for e in tinj.injected]


def test_external_crash_between_ticks_lands_in_the_next_tick(model):
    """`crash_worker()` called between ticks (the cluster's hook) is
    counted in the next tick's record and recovered like an injected
    crash; the JAX engine does the same."""
    cfg, params, tcfg, tparams = model
    recs = []
    for eng_cls, c, p, side, extra in (
            (ServeEngine, cfg, params, JAX_SIDE, {}),
            (TServeEngine, tcfg, tparams, PORT_SIDE,
             dict(device="cpu", debug_checks=True))):
        eng = eng_cls(c, params=p, kv_layout="paged", n_workers=2, **KW,
                      **extra)
        eng.submit(_burst(side, c.vocab_size))
        with (set_mesh(eng.mesh) if eng_cls is ServeEngine
              else contextlib.nullcontext()):
            for _ in range(3):
                eng.tick()
            victims = eng.crash_worker()
            while eng.scheduler.has_pending or eng._by_slot \
                    or eng._prefilling or eng._retrying:
                eng.tick()
        recs.append((sorted(r.rid for r in victims),
                     [t.crashes for t in eng.metrics.ticks],
                     [t.retries for t in eng.metrics.ticks],
                     eng.metrics.recovery_events,
                     _streams(eng.metrics)))
    assert recs[1] == recs[0]
    assert recs[1][1][3] == 1 and recs[1][0]


# ---------------------------------------------------------------------------
# Input validation + chaos spec parsing
# ---------------------------------------------------------------------------


def test_engine_construction_validation(model):
    _, _, tcfg, _ = model
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        TServeEngine(tcfg, capacity=0, **cpu)
    with pytest.raises(ValueError, match="n_workers"):
        TServeEngine(tcfg, n_workers=0, **cpu)
    with pytest.raises(ValueError, match="cache_len"):
        TServeEngine(tcfg, cache_len=0, **cpu)
    with pytest.raises(ValueError, match="zero-page budget"):
        TServeEngine(tcfg, kv_layout="paged", cache_len=4, page_size=8,
                     **cpu)
    with pytest.raises(ValueError, match="page_size"):
        TServeEngine(tcfg, kv_layout="paged", page_size=0, **cpu)
    with pytest.raises(ValueError, match="brownout"):
        TServeEngine(tcfg, brownout="sometimes", **cpu)
    with pytest.raises(ValueError, match="brownout"):
        ServeEngine(smoke_variant(get_config(ARCH)), brownout="sometimes")


def test_resize_validation(model):
    _, _, tcfg, tparams = model
    eng = TServeEngine(tcfg, params=tparams, device="cpu", n_workers=2,
                       **KW)
    with pytest.raises(ValueError, match="at least one worker"):
        eng.resize(0)
    with pytest.raises(ValueError, match="at least one worker"):
        eng.resize(-3)
    eng.resize(1)  # still legal
    assert eng.k == 1
    with pytest.raises(ValueError, match="not in live set"):
        eng.crash_worker(1)
    with pytest.raises(ValueError, match="wall clock"):
        TServeEngine(tcfg, params=tparams, device="cpu", clock=lambda: 0.0,
                     **KW).run([])


def test_fault_plan_validation_and_parse():
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultEvent(0, "meteor")
    with pytest.raises(ValueError, match=">= 0"):
        TF.worker_crash(-1)
    with pytest.raises(ValueError, match="factor"):
        TF.worker_slow(0, 0, 0.0)
    with pytest.raises(ValueError, match="p_crash"):
        TF.FaultPlan(p_crash=1.5)
    with pytest.raises(ValueError, match="unknown chaos event"):
        TF.parse_chaos("meteor@t=3")
    with pytest.raises(ValueError, match="worker and factor"):
        TF.parse_chaos("slow@t=1")
    with pytest.raises(ValueError, match="unknown chaos parameter"):
        TF.parse_chaos("p_meteor=0.5")
    spec = "crash@t=5:prefill,slow@t=3:w0:2.5,drop@t=8,seed=7"
    plan = TF.parse_chaos(spec)
    assert [e.kind for e in plan.events] == \
        ["worker_slow", "worker_crash", "handoff_drop"]
    assert plan.events[1].payload == {"pool": "prefill"}
    assert plan.seed == 7
    # every spec parses to the JAX package's plan, and a probabilistic
    # plan draws the JAX plan's faults tick for tick
    for s in (spec, "crash@t=2:w1,revoke@t=4:job,p_crash=0.2,seed=3",
              "p_slow=0.5,p_crash=0.1,seed=11"):
        mine, ref = TF.parse_chaos(s), JF.parse_chaos(s)
        assert [e.to_dict() for e in mine.events] == \
            [e.to_dict() for e in ref.events]
        got = [[e.to_dict() for e in mine.due(t)] for t in range(40)]
        want = [[e.to_dict() for e in ref.due(t)] for t in range(40)]
        assert got == want


# ---------------------------------------------------------------------------
# The serve launcher: --chaos and the overload flags
# ---------------------------------------------------------------------------

LAUNCH = dict(smoke=True, trace="burst", requests=8, capacity=4,
              cache_len=32, prefill_bucket=8, prompt_len=(6, 14),
              max_new_tokens=(3, 6), workers=2, seed=0, kv_layout="paged",
              chaos="crash@t=3,slow@t=1:w0:2.0", brownout="auto",
              queue_cap=5)


def test_launch_serve_chaos_matches_the_jax_launcher(model, monkeypatch):
    """`serve(...)` with a chaos spec, the brownout ladder (and so a
    circuit breaker) and a bounded queue, against the JAX package's
    `serve(...)` at the same arguments and weights: equal wall-time-free
    summary fields, the chaos spec and the injected faults.  No SLO
    target: on the wall clock it would make the ladder timing-dependent."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch import serve as port_launch
    _, params, _, tparams = model
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    js = jax_serve(ARCH, **LAUNCH)
    ts = port_launch.serve(ARCH, **LAUNCH, device="cpu")
    keys = COUNTERS + ["chaos", "faults_injected"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["faults_injected"] == {"worker_slow": 1, "worker_crash": 1}
    assert ts["rejected_requests"] > 0 and ts["crashes_total"] == 1
    assert [k for _, k in ts["breaker_events"]][:1] == ["open"]


def test_launch_serve_cli_takes_chaos_and_overload_flags(monkeypatch):
    from repro_torch.launch import serve as port_launch
    seen = {}

    def fake_serve(arch, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_launch, "serve", fake_serve)
    monkeypatch.setattr("sys.argv", [
        "serve", "--smoke", "--device", "cpu", "--chaos", "crash@t=5",
        "--slo-ttft", "0.5", "--slo-tpot", "0.05", "--tenant-rate", "3",
        "--queue-cap", "7", "--brownout", "auto"])
    with pytest.raises(SystemExit):
        port_launch.main()
    assert {k: seen[k] for k in ("chaos", "slo_ttft", "slo_tpot",
                                 "tenant_rate", "queue_cap", "brownout")} \
        == dict(chaos="crash@t=5", slo_ttft=0.5, slo_tpot=0.05,
                tenant_rate=3.0, queue_cap=7, brownout="auto")
