"""Disaggregated serving in the port against the JAX package, part two:
the handoff mechanics of tests/test_disagg.py (no page leak across the
pool boundary, restore re-sharing across managers and through the
handoff, the handoff-delay metric, per-pool scoped tracing), the split
policies (tests/test_overload.py's SLO mode, `QueueSplitPolicy.decide`
as a pure function of one `SplitObs` in both packages, both modes, and
the `SplitObs` each package's `DisaggEngine` shows a policy each tick),
`DisaggEngine`'s keyword defaults, the handoff deadline sweep of
tests/test_overload.py, the moe family through `DisaggEngine`, and
`launch.serve --disagg`.

Conventions as in tests/test_torch_disagg.py, whose helpers run both
packages and compare them."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.obs import Tracer as JTracer
from repro.serve import KVMemoryManager as JKVMemoryManager
from repro.serve import QueueSplitPolicy as JQueueSplitPolicy
from repro.serve import ScheduledSplitPolicy as JScheduledSplitPolicy
from repro.serve import DisaggEngine as JDisaggEngine
from repro.serve import SplitObs as JSplitObs
from repro.serve import SplitPolicy as JSplitPolicy
from repro.serve import ServeEngine as JServeEngine
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serve import (DisaggEngine, KVMemoryManager,
                               QueueSplitPolicy, RequestState,
                               ScheduledSplitPolicy, ServeEngine, SplitObs,
                               SplitPolicy)
from repro_torch.serve.pages import PageError

from test_torch_disagg import (JAX_SIDE, KW, PORT_SIDE, burst,
                               load_model, port_oracle, run_both, streams)
from test_torch_faults import COUNTERS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model("smollm-360m")


# ---------------------------------------------------------------------------
# Handoff mechanics: page leaks, restore re-sharing, delay metrics
# ---------------------------------------------------------------------------


def test_disagg_no_page_leak_across_handoff(model):
    """After a drained run every page of BOTH pools is free and nothing is
    parked anywhere (`debug_checks` also ran `check()` every tick)."""
    _, _, teng, _ = run_both(model, burst, n_workers=2, **KW)
    for half in (teng.prefill, teng.decode):
        assert half.pages.n_used == 0
        assert half.mem.n_parked == 0
        half.pages.check_invariants()
    teng.check()  # nothing in flight either
    teng._handoff.append((None, None))  # and the guard guards
    with pytest.raises(PageError):
        teng.check()


def test_restore_resharing_across_managers():
    """A payload parked by one manager and adopted by another re-matches
    its prompt against the DESTINATION prefix index: full prompt pages
    are shared (nothing scattered), the tail page is not.  The port's
    payloads are torch tensors, the JAX package's numpy arrays; the plans
    and byte counts must be equal."""
    plans = []
    for mgr, host in ((JKVMemoryManager,
                       lambda pg: np.full(8, pg, np.float32)),
                      (KVMemoryManager,
                       lambda pg: torch.full((8,), float(pg)))):
        ps = 4
        prompt = np.arange(10, dtype=np.int32)  # 2 full pages + a tail of 2
        src = mgr(n_pages=17, page_size=ps)
        src.admit_slot(0, prompt)
        seq = src.park(1, 0, {str(pg): host(pg)
                              for pg in src.pages.table(0)},
                       live_tokens=12, next_tok=5, prompt=prompt)
        payload = src.take_parked(1)
        assert payload is seq and src.n_parked == 0
        dst = mgr(n_pages=17, page_size=ps)
        dst.admit_slot(0, prompt)  # a resident donor with the same prompt
        dst.adopt(payload)
        plan = dst.restore(1, 1)
        assert plan.shared_pages == 2  # both FULL prompt pages re-shared
        assert sum(1 for w in plan.write_ids if w == 0) == 2
        assert plan.moved_bytes < seq.nbytes
        assert src.park_bytes == seq.nbytes and src.restore_bytes == 0
        assert dst.restore_bytes == plan.moved_bytes and dst.park_bytes == 0
        assert dst.pages.ref(plan.table[-1]) == 1  # the tail: not shared
        dst.pages.check_invariants()
        plans.append((plan.table, plan.write_ids, plan.shared_pages,
                      plan.moved_bytes, seq.nbytes))
    assert plans[0] == plans[1]


def test_disagg_restore_resharing_through_handoff(model):
    """Few-shot shared-header workload: the decode pool re-shares restored
    prompt pages, so it scatters fewer bytes than the prefill pool
    parked."""
    head = np.random.default_rng(0).integers(0, model[2].vocab_size,
                                             size=24)
    kw = dict(capacity=4, cache_len=64, prefill_bucket=8, seed=0)

    def reqs(side, vocab):
        return burst(side, vocab, n=6, seed=2, prompt=(4, 8),
                     max_new=(3, 5), shared_prefix=head)

    want = port_oracle(model, reqs, **kw)
    jeng, _, teng, tm = run_both(model, reqs, n_workers=2, **kw)
    assert streams(tm) == want
    dstats = teng.decode.mem.stats()
    assert dstats["shared_page_hits"] > 0  # restores mapped onto donors
    assert dstats["restore_bytes"] < teng.prefill.mem.stats()["park_bytes"]
    assert dstats == jeng.decode.mem.stats()
    assert teng.prefill.mem.stats() == jeng.prefill.mem.stats()


def test_disagg_handoff_delay_metric(model):
    """The handoff wait is its own metric and stays out of the admission
    queue delay (stamped once, at first admission).  On the wall clock,
    as the reference test runs, so that the wait is > 0; the wall-time-free
    fields are compared with the JAX package's.  The reference test also
    asserts queue delay <= time to first token - handoff wait, which holds
    only while a prefill takes longer than the wait after it (the first
    token is the prefill pool's, and the wait follows it): the port's CPU
    prefill can be the shorter, so this test asserts the order the
    timestamps must have instead: admission, first token, the wait, the
    finish."""
    _, _, _, tm = run_both(model, lambda s, v: burst(s, v, n=6),
                           tick_clock=False, n_workers=2, **KW)
    s = tm.summarize()
    assert s["requeued_total"] == s["disagg"]["handoffs"] == 6
    assert s["handoff_delay_p50_s"] is not None
    assert s["handoff_delay_p50_s"] >= 0.0
    for r in tm.requests:
        assert r.handoff_delay > 0.0  # park -> decode admission took time
        assert r.t_parked is None  # consumed at admission
        assert r.t_admitted is not None
        assert r.arrival_time <= r.t_admitted <= r.t_first_token
        assert r.t_first_token + r.handoff_delay <= r.t_finished + 1e-9


# ---------------------------------------------------------------------------
# Observability: per-pool scoped tracks and handoff spans
# ---------------------------------------------------------------------------


def test_disagg_scoped_tracing(model):
    jtrc, trc = JTracer(name="disagg-jax"), Tracer(name="disagg-port")
    run_both(model, lambda s, v: burst(s, v, n=6), n_workers=2,
             jax_kw=dict(tracer=jtrc), port_kw=dict(tracer=trc), **KW)
    obj = trc.to_chrome()
    counts = validate_chrome_trace(
        obj, require_names=("handoff.extract", "handoff.inject",
                            "schedule"),
        require_tracks=("prefill_pool.prefill", "decode_pool.decode",
                        "handoff"))
    assert counts["handoff.extract"] == counts["handoff.inject"] == 6
    with pytest.raises(ValueError):
        validate_chrome_trace(obj, require_tracks=("nope",))
    names = set(trc.registry.names())
    assert "prefill_pool.serve.ticks" in names
    assert "decode_pool.serve.ticks" in names
    assert "serve.handoffs" in names  # handoff counters on the parent
    # the handoff, tick and KV counters of the JAX package's trace
    for name in ("serve.handoffs", "serve.handoff_bytes",
                 "serve.disagg_ticks", "prefill_pool.serve.ticks",
                 "decode_pool.serve.ticks", "decode_pool.serve.park_bytes",
                 "prefill_pool.serve.park_bytes"):
        if name in jtrc.registry.names():
            assert trc.registry.counter(name).value \
                == jtrc.registry.counter(name).value, name


# ---------------------------------------------------------------------------
# Split policies
# ---------------------------------------------------------------------------


def _obs(cls, rng, tick):
    att = lambda: (None if rng.random() < 0.2  # noqa: E731
                   else float(rng.random()))
    return cls(total_workers=int(rng.integers(1, 9)),
               prefill_backlog_tokens=int(rng.integers(0, 400)),
               decode_backlog_tokens=int(rng.integers(0, 400)),
               prefill_tick_s=float(rng.choice([0.0, rng.random()])),
               decode_tick_s=float(rng.choice([0.0, rng.random()])),
               handoff_depth=int(rng.integers(0, 6)), tick=tick,
               ttft_attainment=att(), tpot_attainment=att())


@pytest.mark.parametrize("mode", ["backlog", "slo"])
def test_split_policies_decide_as_the_jax_package(mode):
    """`QueueSplitPolicy.decide` is a pure function of its `SplitObs` and
    the current split: on 2,000 random observations (every tick, both
    cost inputs zero or not, attainments missing or not) the port
    decides as the JAX package does; so does `ScheduledSplitPolicy`."""
    pols = [(cls(interval=interval, min_each=min_each, mode=mode,
                 slo_deadband=0.05))
            for cls in (JQueueSplitPolicy, QueueSplitPolicy)
            for interval, min_each in ((1, 1), (3, 2))]
    rng = np.random.default_rng(1)
    moved = 0
    for tick in range(2000):
        state = rng.bit_generator.state
        jobs = _obs(JSplitObs, rng, tick)
        rng.bit_generator.state = state
        tobs = _obs(SplitObs, rng, tick)
        cur = int(rng.integers(1, 8))
        for j, t in zip(pols[:2], pols[2:]):
            want = j.decide(jobs, current=cur)
            assert t.decide(tobs, current=cur) == want
            moved += want != cur
    assert moved > 100
    sched = [(2, 2), (5, 1), (9, 3)]
    for tick in range(12):
        o = _obs(SplitObs, rng, tick)
        jo = _obs(JSplitObs, np.random.default_rng(0), tick)
        assert ScheduledSplitPolicy(sched).decide(o, current=1) \
            == JScheduledSplitPolicy(sched).decide(jo, current=1)


def test_split_policy_slo_mode():
    obs = lambda ttft, tpot: SplitObs(  # noqa: E731
        total_workers=4, prefill_backlog_tokens=50,
        decode_backlog_tokens=50, prefill_tick_s=0.0, decode_tick_s=0.0,
        handoff_depth=0, tick=4, ttft_attainment=ttft,
        tpot_attainment=tpot)
    pol = QueueSplitPolicy(interval=4, mode="slo", slo_deadband=0.05)
    assert pol.decide(obs(0.5, 0.9), current=2) == 3  # TTFT hurting
    assert pol.decide(obs(0.9, 0.5), current=2) == 1  # TPOT hurting
    assert pol.decide(obs(0.9, 0.88), current=2) == 2  # dead band holds
    assert pol.decide(obs(0.0, 1.0), current=3) == 3  # clamped at hi
    # attainment unknown -> falls back to the backlog rule
    cold = SplitObs(total_workers=4, prefill_backlog_tokens=300,
                    decode_backlog_tokens=0, prefill_tick_s=0.0,
                    decode_tick_s=0.0, handoff_depth=0, tick=4)
    assert pol.decide(cold, current=2) == 3
    with pytest.raises(ValueError):
        QueueSplitPolicy(mode="nope")


class _Recorder:
    """A split policy that never moves a worker and logs what it is shown:
    each tick's current split and `SplitObs`, less the two per-pool host
    tick-time EMAs (wall time)."""

    def __init__(self):
        self.log = []

    def decide(self, obs, *, current):
        seen = dataclasses.asdict(obs)
        del seen["prefill_tick_s"], seen["decode_tick_s"]
        self.log.append((current, seen))
        return current


class _JRecorder(_Recorder, JSplitPolicy):
    pass


class _TRecorder(_Recorder, SplitPolicy):
    pass


@pytest.mark.parametrize("overlap", [False, True])
def test_split_observations_match_the_jax_package(model, overlap):
    """What `DisaggEngine._observe` hands the split policy each tick (the
    backlog tokens of both pools, the handoff depth, the SLO attainments)
    equals the JAX package's, tick by tick, on the tick clock: staggered
    arrivals, chunked prefill, three workers, SLO targets set."""
    def reqs(side, vocab):
        return side["make"](10, vocab_size=vocab,
                            arrivals=np.repeat(np.arange(5.0), 2),
                            prompt_len=(6, 30), max_new_tokens=(4, 9),
                            rng=np.random.default_rng(5))

    jrec, trec = _JRecorder(), _TRecorder()
    _, _, _, tm = run_both(
        model, reqs, n_workers=3, capacity=4, cache_len=48,
        prefill_bucket=8, chunked_prefill=True, prefill_chunk=8,
        slo_ttft=4.0, slo_tpot=1.0, overlap=overlap, seed=0,
        jax_kw=dict(split_policy=jrec), port_kw=dict(split_policy=trec))
    assert trec.log == jrec.log
    assert tm.handoffs == 10
    assert tm.split_events == [(0, 1, 2)]  # the initial split alone
    seen = [o for _, o in trec.log]
    # the log covers the inputs that move the split: both backlogs at
    # once, and the attainments once finishes fill the window
    assert any(o["prefill_backlog_tokens"] and o["decode_backlog_tokens"]
               for o in seen)
    assert any(o["ttft_attainment"] is not None for o in seen)


def test_disagg_engine_takes_every_keyword_of_the_jax_engine():
    """The port's `DisaggEngine.__init__` names every keyword of the JAX
    package's with its default, but `paged_impl`: that one defaults as
    the port's `ServeEngine` does, to the paged-attention kernel."""
    ref = inspect.signature(JDisaggEngine.__init__).parameters
    mine = inspect.signature(DisaggEngine.__init__).parameters
    assert set(ref) <= set(mine)
    assert all(mine[n].default == ref[n].default for n in ref
               if n not in ("self", "cfg", "paged_impl"))
    serve = inspect.signature(ServeEngine.__init__).parameters
    assert mine["paged_impl"].default == serve["paged_impl"].default \
        == "kernel"
    assert mine["device"].default == "cuda"


# ---------------------------------------------------------------------------
# Overload: the handoff deadline sweep
# ---------------------------------------------------------------------------


def _deadline(sel, deadline=1e-9, n=4, seed=0, prompt=(6, 16)):
    def make(side, vocab):
        reqs = burst(side, vocab, n=n, seed=seed, prompt=prompt)
        for i in sel:
            reqs[i].deadline = deadline
        return reqs
    return make


def test_disagg_handoff_deadline_sweep(model):
    """Requests whose deadline blows are shed and nothing leaks (the
    reference test, on the wall clock); then, on the tick clock, a
    payload dropped in flight re-sends a tick later past its deadline and
    the sweep sheds it from the handoff queue before the decode pool
    adopts it (prompts of one page prefill whole in tick 0; the other
    three hand off in tick 0 and decode to their end)."""
    _, _, teng, tm = run_both(model, _deadline(range(4)), tick_clock=False,
                              n_workers=2, **KW)
    assert all(r.state is RequestState.EXPIRED for r in tm.requests)
    assert teng.prefill.mem.n_parked == 0 and teng.decode.mem.n_parked == 0
    assert tm.summarize()["shed_requests"] == 4
    _, _, _, tm2 = run_both(model, _deadline([2], seed=1),
                            tick_clock=False, n_workers=2, **KW)
    states = {r.rid: r.state for r in tm2.requests}
    assert states[2] is RequestState.EXPIRED
    assert sum(1 for s in states.values()
               if s is RequestState.FINISHED) == 3

    _, _, teng3, tm3 = run_both(
        model, _deadline(range(4), deadline=0.5, prompt=(4, 8)),
        n_workers=2,
        faults=lambda F: F.FaultInjector(F.FaultPlan([F.handoff_drop(0)])),
        **KW)
    expired = [r for r in tm3.requests if r.state is RequestState.EXPIRED]
    assert len(expired) == 1 and not expired[0].generated[1:]
    assert tm3.handoff_drops == tm3.handoff_retries == 1
    assert tm3.handoffs == 4
    # the swept request never reached the decode pool
    assert expired[0] not in tm3.decode.requests
    assert teng3.prefill.mem.n_parked == teng3.decode.mem.n_parked == 0
    assert sum(1 for r in tm3.requests
               if r.state is RequestState.FINISHED) == 3


# ---------------------------------------------------------------------------
# The moe family through DisaggEngine
# ---------------------------------------------------------------------------


def test_disagg_moe_matches_jax():
    """grok-1-314b's smoke variant (4 experts, top-2) through DisaggEngine
    in both packages at the same attention implementation (a moe row
    depends on every row of its dispatch, ROADMAP C6), overlapped and
    synchronous: equal streams, counters and records; every request
    handed off once."""
    m = load_model("grok-1-314b")
    kw = dict(capacity=8, cache_len=64, prefill_bucket=16, page_size=8,
              n_workers=2, seed=0)
    for overlap in (False, True):
        _, _, _, tm = run_both(
            m, lambda s, v: burst(s, v, n=8, prompt=(6, 40), max_new=(4, 8)),
            paged_impl="xla", overlap=overlap, **kw)
        assert tm.handoffs == 8
        assert tm.summarize()["requests_finished"] == 8


# ---------------------------------------------------------------------------
# The serve launcher: --disagg
# ---------------------------------------------------------------------------


def test_launch_serve_disagg_matches_the_jax_launcher(model, monkeypatch):
    """`serve(..., disagg=True)` against the JAX package's `serve(...)` at
    the same arguments and weights, with a handoff drop and a decode-pool
    straggler scripted (equal wall-time-free summary fields and disagg
    accounting).  The split policy decides once, at tick 0, where both
    tick-time EMAs are still 0: its later decisions would read host
    times.  `--disagg`, `--prefill-workers` and `--split-interval` on the
    command line reach `serve`."""
    from repro.launch.serve import serve as jax_serve
    from repro.models import model as JM
    from repro_torch.launch import serve as port_launch
    from repro_torch.models import model as TM
    _, params, _, tparams = model
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    kw = dict(smoke=True, trace="burst", requests=6, capacity=4,
              cache_len=32, prefill_bucket=8, prompt_len=(6, 14),
              max_new_tokens=(3, 6), workers=3, seed=0, disagg=True,
              prefill_workers=2, split_interval=10_000,
              chaos="drop@t=2,slow@t=1:w0:2.0,crash@t=3:prefill")
    js = jax_serve("smollm-360m", **kw)
    ts = port_launch.serve("smollm-360m", **kw, device="cpu")
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    wall = {"tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
            "tpot_p99_s", "queue_delay_p50_s", "queue_delay_p99_s",
            "handoff_delay_p50_s", "handoff_delay_p99_s", "wall_s",
            "jit_cache_sizes"}
    for key in ("handoffs", "handoff_bytes", "handoff_drops",
                "handoff_retries", "split_events", "degraded_events"):
        assert ts["disagg"][key] == js["disagg"][key], key
    for half in ("prefill_pool", "decode_pool"):
        assert {k: v for k, v in ts["disagg"][half].items()
                if k not in wall} \
            == {k: v for k, v in js["disagg"][half].items()
                if k not in wall}
    assert ts["faults_injected"] == js["faults_injected"]
    assert ts["disagg"]["handoffs"] == ts["requests_finished"] == 6
    assert ts["disagg"]["handoff_drops"] == 1
    # the prefill-pool crash reached the prefill half
    assert ts["disagg"]["prefill_pool"]["crashes_total"] == 1
    assert ts["disagg"]["decode_pool"]["crashes_total"] == 0

    seen = {}

    def fake_serve(arch, **k):
        seen.update(k)
        raise SystemExit(0)

    monkeypatch.setattr(port_launch, "serve", fake_serve)
    monkeypatch.setattr("sys.argv", [
        "serve", "--smoke", "--device", "cpu", "--disagg", "--workers", "3",
        "--prefill-workers", "1", "--split-interval", "3"])
    with pytest.raises(SystemExit):
        port_launch.main()
    assert (seen["disagg"], seen["prefill_workers"],
            seen["split_interval"]) == (True, 1, 3)


def test_prefill_only_engine_holds_prefilled_slots(model):
    """`ServeEngine(decode_enabled=False)` (the prefill pool) prefills and
    never decodes: prefilled slots wait in `_by_slot` with their first
    token, as in the JAX engine; `extract` parks without re-queueing and
    `inject` restores on another engine with the flat oracle's stream.
    The flat layout refuses the keyword with the JAX engine's
    ValueError."""
    cfg, params, tcfg, tparams = model
    small = dict(capacity=4, cache_len=32, prefill_bucket=8, page_size=8,
                 seed=0)
    held, pools = [], []
    for cls, c, p, side, extra in (
            (JServeEngine, cfg, params, JAX_SIDE, {}),
            (ServeEngine, tcfg, tparams, PORT_SIDE,
             dict(device="cpu", debug_checks=True))):
        with pytest.raises(ValueError, match="requires kv_layout='paged'"):
            cls(c, params=p, decode_enabled=False, kv_layout="flat",
                **small, **extra)
        eng = cls(c, params=p, decode_enabled=False, kv_layout="paged",
                  **small, **extra)
        eng.submit(burst(side, c.vocab_size, n=3))
        recs = [eng.tick() for _ in range(3)]
        assert sum(r.tokens_emitted for r in recs) == 0
        held.append({s: list(r.generated) for s, r in eng._by_slot.items()})
        pools.append(eng)
    assert held[0] == held[1] and len(held[1]) == 3
    pre = pools[1]
    dec = ServeEngine(tcfg, params=tparams, kv_layout="paged", device="cpu",
                      debug_checks=True, **small)
    for slot in sorted(pre._by_slot):
        req, seq = pre.extract(slot)
        assert req.state is RequestState.PARKED and req.slot is None
        dec.inject(req, seq)
    assert not pre._by_slot and pre.mem.n_parked == 0
    assert not pre.scheduler.has_pending and pre.pages.n_used == 0
    dec.run([])
    assert streams(dec.metrics) == port_oracle(
        model, lambda s, v: burst(s, v, n=3), capacity=4, cache_len=32,
        prefill_bucket=8, seed=0)


def test_disagg_suspend_resume_keeps_streams(model):
    """The lifecycle facade (the cluster job's hooks): a suspended engine
    refuses to tick, both halves record the suspend and the resume, and
    the run then finishes with the flat oracle's streams."""
    from test_torch_disagg import build, drive
    _, _, tcfg, tparams = model
    eng = build(PORT_SIDE, tcfg, tparams, n_workers=2, **KW)
    eng.submit(burst(PORT_SIDE, tcfg.vocab_size))
    for _ in range(3):
        eng._clk = float(eng._tick)
        eng.tick()
    assert eng.n_active_slots > 0
    eng.suspend()
    assert eng.suspended
    with pytest.raises(RuntimeError, match="suspended"):
        eng.tick()
    eng.resume()
    drive(eng, [])
    assert streams(eng.metrics) == port_oracle(model, burst, **KW)
    for half in (eng.prefill, eng.decode):  # each at its own tick count
        (t0, what0), (t1, what1) = half.metrics.suspend_events
        assert (what0, what1) == ("suspend", "resume") and t0 == t1
