"""The overlapped tick (`overlap=True`) of the port against the JAX package:
the tests of tests/test_overlap.py that drive `ServeEngine`.

Both engines run the smoke smollm-360m in fp32 on the same parameters (the
JAX tree carried across by `params_from_numpy`) and the same workload; the
port runs on the CPU with `debug_checks`.  Every case asserts three
things: the port's overlapped streams equal its synchronous streams; they
equal the JAX engine's `overlap=True` streams; and every wall-time-free
`summarize` counter and the per-tick `meta_transfers` equal the JAX
overlapped run's.  Workloads that arrive over time run on a tick clock
(one tick, one simulated second), so the counters do not depend on the
host's speed.  The three disaggregated cases of tests/test_overlap.py
(the bit-identity pair and the drain test) are in
tests/test_torch_disagg.py, run the same three ways."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.faults import FaultInjector, FaultPlan, worker_crash
from repro.models import model as JM
from repro.serve import ServeEngine, synthetic_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import ElasticScalingPolicy as TElasticScalingPolicy
from repro_torch.core import ScaleEvent as TScaleEvent
from repro_torch.faults import FaultInjector as TFaultInjector
from repro_torch.faults import FaultPlan as TFaultPlan
from repro_torch.faults import worker_crash as t_worker_crash
from repro_torch.models import model as TM
from repro_torch.obs import Tracer, host_overlap_ratio, validate_chrome_trace
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

from test_torch_faults import COUNTERS

ARCH = "smollm-360m"
KW = dict(capacity=4, cache_len=32, prefill_bucket=8, seed=0)
CHUNKED = dict(capacity=4, cache_len=96, prefill_bucket=8, prefill_chunk=8,
               seed=0)
JAX_SIDE = dict(make=synthetic_requests, policy=ElasticScalingPolicy,
                event=ScaleEvent, injector=FaultInjector, plan=FaultPlan,
                crash=worker_crash)
PORT_SIDE = dict(make=t_synthetic_requests, policy=TElasticScalingPolicy,
                 event=TScaleEvent, injector=TFaultInjector, plan=TFaultPlan,
                 crash=t_worker_crash)


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
    return side["make"](n, vocab_size=vocab, arrivals=np.zeros(n),
                        prompt_len=prompt, max_new_tokens=max_new,
                        rng=np.random.default_rng(seed))


def _trickle(side, vocab, n=8, seed=0):
    """Arrivals spread over ticks 0-4 (the tick clock's seconds), so
    admissions land while decodes are in flight: the case the overlap
    window reorders."""
    return side["make"](n, vocab_size=vocab,
                        arrivals=np.linspace(0.0, 4.0, n),
                        prompt_len=(6, 16), max_new_tokens=(5, 9),
                        rng=np.random.default_rng(seed))


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _drive(eng, reqs, max_ticks=400):
    """Tick-clock drive (engines built with `clock=` refuse run()): tick
    t runs at time t."""
    eng.submit(reqs)
    with (set_mesh(eng.mesh) if isinstance(eng, ServeEngine)
          else contextlib.nullcontext()):
        while (eng.scheduler.has_pending or eng._by_slot or eng._prefilling
               or eng._retrying) and eng._tick < max_ticks:
            eng._clk = float(eng._tick)
            eng.tick()
    eng.metrics.wall_s = float(eng._tick)
    return eng.metrics


def _engine(cls, c, p, side, *, overlap, tick_clock, events=None,
            crash_at=None, **kw):
    if events:
        kw["policies"] = [side["policy"]([side["event"](*e)
                                          for e in events])]
    if crash_at is not None:
        kw["fault_injector"] = side["injector"](side["plan"](
            [side["crash"](crash_at)]))
    holder = {}
    if tick_clock:
        kw["clock"] = lambda: holder["e"]._clk
    eng = cls(c, params=p, overlap=overlap, **kw)
    eng._clk = 0.0
    holder["e"] = eng
    return eng


def _run_three(model, workload, *, tick_clock=False, tracers=(None, None),
               **kw):
    """The port synchronously, the port overlapped and the JAX engine
    overlapped on one workload (`tracers` for the port's two runs) ->
    (port overlapped engine, its metrics, JAX metrics); asserts equal
    streams, counters and per-tick meta_transfers."""
    cfg, params, tcfg, tparams = model
    runs = []
    for cls, c, p, side, overlap, extra in (
            (TServeEngine, tcfg, tparams, PORT_SIDE, False,
             dict(device="cpu", debug_checks=True, tracer=tracers[0])),
            (TServeEngine, tcfg, tparams, PORT_SIDE, True,
             dict(device="cpu", debug_checks=True, tracer=tracers[1])),
            (ServeEngine, cfg, params, JAX_SIDE, True, {})):
        eng = _engine(cls, c, p, side, overlap=overlap,
                      tick_clock=tick_clock, **kw, **extra)
        reqs = workload(side, c.vocab_size)
        runs.append((eng, _drive(eng, reqs) if tick_clock else eng.run(reqs)))
    (_, sync), (teng, tm), (_, jm) = runs
    assert teng.overlap
    assert _streams(tm) == _streams(sync)
    assert _streams(tm) == _streams(jm)
    ts, js = tm.summarize(), jm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert [t.meta_transfers for t in tm.ticks] \
        == [t.meta_transfers for t in jm.ticks]
    if teng.pages is not None:
        teng.pages.check_invariants()
        assert teng.pages.n_used == 0  # every page returned
    assert teng.scheduler.pool.n_used == 0
    return teng, tm, jm


# ---------------------------------------------------------------------------
# Bit identity with the synchronous loop and with the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "paged"])
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_overlap_bit_identical_layout_spec_matrix(model, layout, spec):
    _, tm, _ = _run_three(model, _burst, kv_layout=layout, spec=spec, **KW)
    assert sum(t.meta_transfers for t in tm.ticks) > 0
    if spec == "ngram":
        assert tm.summarize()["spec_drafted_total"] > 0


def test_overlap_bit_identical_staggered_arrivals(model):
    """Admissions arriving mid-run join the prep window (deferred prefill
    settles) without changing any stream."""
    _, tm, _ = _run_three(model, lambda s, v: _trickle(s, v, n=10),
                          tick_clock=True, kv_layout="paged", **KW)
    # some admissions landed on ticks that also decoded
    assert any(t.admitted and t.tokens_emitted for t in tm.ticks)


def test_overlap_bit_identical_chunked_prefill(model):
    _, tm, _ = _run_three(
        model, lambda s, v: _burst(s, v, n=4, prompt=(40, 60),
                                   max_new=(3, 5)),
        kv_layout="paged", **CHUNKED)
    assert sum(t.prefill_chunks for t in tm.ticks) > 0  # path exercised


def test_overlap_bit_identical_mid_run_resize(model):
    _, tm, _ = _run_three(model, _burst, kv_layout="paged", n_workers=2,
                          events=[(0, 2), (3, 3), (6, 2)], **KW)
    assert len(tm.scale_events) >= 2  # the resizes happened


def test_overlap_bit_identical_crash_recovery(model):
    """A mid-run worker crash inside the overlapped loop re-runs its
    victims bit-equal to the JAX engine's overlapped run."""
    _, tm, _ = _run_three(model, _burst, kv_layout="paged", n_workers=2,
                          crash_at=3, **KW)
    s = tm.summarize()
    assert s["crashes_total"] == 1 and s["recoveries"] == 1


def _preempting(side, vocab):
    """Two low-priority decodes fill capacity 2; a priority-2 arrival at
    tick 2 parks one, which restores when a slot frees (the workload of
    tests/test_torch_serve.py's preemption test, on the tick clock)."""
    low = side["make"](2, vocab_size=vocab, arrivals=np.zeros(2),
                       prompt_len=(6, 8), max_new_tokens=(12, 14),
                       rng=np.random.default_rng(2))
    hi = side["make"](1, vocab_size=vocab, arrivals=np.array([2.0]),
                      prompt_len=(6, 8), max_new_tokens=(4, 4), priority=2,
                      rng=np.random.default_rng(3), rid_base=100)
    return low + hi


def test_overlap_restores_bind_before_the_launch(model):
    """A parked decode's restore binds before the launch and joins that
    tick's step, as in the synchronous tick (a restore in the prep window
    would decode a tick late: more ticks than the JAX engine's)."""
    _, tm, _ = _run_three(model, _preempting, tick_clock=True,
                          kv_layout="paged", capacity=2, cache_len=32,
                          prefill_bucket=8, chunked_prefill=False, seed=0)
    s = tm.summarize()
    assert s["parked_total"] == s["restored_total"] == 1


# ---------------------------------------------------------------------------
# Metadata-transfer batching
# ---------------------------------------------------------------------------


def test_meta_transfers_counted_and_bounded(model):
    """Steady-state paged decode moves exactly ONE packed metadata array a
    dispatch, overlapped as synchronously; the per-tick count lands in the
    metrics registry and equals the JAX engine's tick for tick."""
    _, tm, _ = _run_three(model, lambda s, v: _burst(s, v, n=4),
                          kv_layout="paged", **KW)
    per_tick = [t.meta_transfers for t in tm.ticks]
    assert sum(per_tick) > 0
    solo = [t for t in tm.ticks
            if t.admitted == 0 and t.prefill_chunks == 0
            and t.tokens_emitted > 0]
    assert solo and all(t.meta_transfers == 1 for t in solo)
    assert tm.summarize()["meta_transfers_total"] == sum(per_tick)


# ---------------------------------------------------------------------------
# Tracing: overlap spans + host_overlap_ratio
# ---------------------------------------------------------------------------


def test_overlap_trace_spans_and_ratio(model):
    trc, trc2 = Tracer(name="overlap-test"), Tracer(name="sync-test")
    _run_three(model, _trickle, tick_clock=True, tracers=(trc2, trc),
               kv_layout="paged", **KW)
    names = {e.name for e in trc.events if e.ph == "X"}
    assert {"overlap.bind", "overlap.prep", "overlap.inflight",
            "prefill.device_wait"} <= names
    inflight = [e for e in trc.events if e.name == "overlap.inflight"]
    assert all(e.cat == "device" and e.track == "decode" for e in inflight)
    validate_chrome_trace(trc.to_chrome(),
                          require_names=["overlap.prep", "overlap.bind"])
    ratio = host_overlap_ratio(trc)
    assert ratio is not None and 0.0 <= ratio <= 1.0

    # the synchronous loop never overlaps: no in-flight envelopes
    assert "overlap.inflight" not in {e.name for e in trc2.events}


def test_prefill_has_own_settle_span(model):
    """Prefill dispatches settle under their own `prefill.device_wait`
    span (on the prefill track) in BOTH modes: no generic tick-end wait
    absorbs prefill time."""
    sync_trc, trc = Tracer(name="prefill-sync"), Tracer(name="prefill-ovl")
    _run_three(model, lambda s, v: _burst(s, v, n=4),
               tracers=(sync_trc, trc), kv_layout="paged", **KW)
    for t in (sync_trc, trc):
        spans = [e for e in t.events
                 if e.ph == "X" and e.name == "prefill.device_wait"]
        assert spans and all(e.cat == "device" and e.track == "prefill"
                             for e in spans)


# ---------------------------------------------------------------------------
# The serve launcher: --overlap
# ---------------------------------------------------------------------------


def test_launch_serve_overlap_matches_the_jax_launcher(model, monkeypatch):
    """`serve(..., overlap=True)` on the paged layout against the JAX
    package's `serve(...)` at the same arguments and weights (equal
    wall-time-free summary fields), and `--overlap` on the command line
    reaches `serve`."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch import serve as port_launch
    _, params, _, tparams = model
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    kw = dict(smoke=True, trace="burst", requests=6, capacity=4,
              cache_len=32, prefill_bucket=8, prompt_len=(6, 14),
              max_new_tokens=(3, 6), workers=2, seed=0, kv_layout="paged",
              spec="ngram", overlap=True)
    js = jax_serve(ARCH, **kw)
    ts = port_launch.serve(ARCH, **kw, device="cpu")
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["overlap"] and ts["requests_finished"] == 6

    seen = {}

    def fake_serve(arch, **k):
        seen.update(k)
        raise SystemExit(0)

    monkeypatch.setattr(port_launch, "serve", fake_serve)
    monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device", "cpu",
                                     "--kv-layout", "paged", "--overlap"])
    with pytest.raises(SystemExit):
        port_launch.main()
    assert seen["overlap"] is True
