"""The port's ServeEngine (CPU, paged_impl="kernel", so the kernel wrapper's
plain version) vs the JAX ServeEngine (paged_impl="pallas") on the same
parameters and the same workloads: token streams and every wall-time-free
`summarize()` counter must be equal.  The burst workloads run the JAX engine
with evict=False; the mixed-priority ones run both engines with the default
`evict` (on), so a high-priority arrival parks and later restores a decode."""
import json

import jax
import numpy as np
import pytest

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
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"
# summarize() keys that carry no wall time (jit_cache_sizes is the JAX
# engine's compile-cache bookkeeping and has no counterpart)
COUNTERS = ["requests_finished", "requests_total", "tokens_generated",
            "n_ticks", "prefill_chunks_total", "prefill_dispatches_total",
            "admission_bytes_total", "meta_transfers_total",
            "decode_dispatches", "shared_page_hits_total",
            "cow_breaks_total", "shared_extra_pages_mean", "occupancy_mean",
            "page_occupancy_mean", "kv_stats", "scale_events",
            "resize_moved_bytes_total"]


def _burst(make, vocab, n, seed, prompt, max_new):
    return make(n, vocab_size=vocab, arrivals=np.zeros(n), prompt_len=prompt,
                max_new_tokens=max_new, rng=np.random.default_rng(seed))


def _identical(make_request, vocab, n=3, plen=13, max_new=5):
    """Identical prompts with a partial last page: the first sharers map
    the whole prompt, and their first decode write breaks the share."""
    prompt = np.random.default_rng(3).integers(0, vocab, plen)
    return [make_request(rid=i, prompt=prompt.astype(np.int32),
                         max_new_tokens=max_new) for i in range(n)]


WORKLOADS = {
    "whole_prefill": dict(
        engine=dict(capacity=4, cache_len=32, prefill_bucket=8,
                    chunked_prefill=False),
        requests=lambda mk, mr, v: _burst(mk, v, 6, 0, (6, 16), (5, 9))),
    "chunked_prefill": dict(
        engine=dict(capacity=2, cache_len=48, prefill_bucket=8,
                    prefill_chunk=8),
        requests=lambda mk, mr, v: _burst(mk, v, 3, 4, (18, 30), (3, 5))),
    "shared_prefix_cow": dict(
        engine=dict(capacity=4, cache_len=32, prefill_bucket=8,
                    chunked_prefill=False),
        requests=lambda mk, mr, v: _identical(mr, v)),
    "resize_1_2_1": dict(
        engine=dict(capacity=4, cache_len=32, prefill_bucket=8,
                    slots_per_chunk=1, chunked_prefill=False),
        events=[(0, 1), (2, 2), (5, 1)],
        requests=lambda mk, mr, v: _burst(mk, v, 8, 2, (6, 16), (5, 9))),
}


@pytest.fixture(scope="module")
def model():
    cfg = smoke_variant(get_config(ARCH))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(ARCH))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_port_engine_matches_jax_engine(model, name):
    cfg, params, tcfg, tparams = model
    w = WORKLOADS[name]
    events = w.get("events")
    jpol = ([ElasticScalingPolicy([ScaleEvent(*e) for e in events])]
            if events else [])
    tpol = ([TElasticScalingPolicy([TScaleEvent(*e) for e in events])]
            if events else [])
    jeng = ServeEngine(cfg, kv_layout="paged", paged_impl="pallas",
                       evict=False, seed=0, params=params, policies=jpol,
                       **w["engine"])
    jm = jeng.run(w["requests"](synthetic_requests, Request,
                                cfg.vocab_size))
    teng = TServeEngine(tcfg, kv_layout="paged", paged_impl="kernel",
                        device="cpu", seed=0, params=tparams, policies=tpol,
                        debug_checks=True, **w["engine"])
    tm = teng.run(w["requests"](t_synthetic_requests, TRequest,
                                tcfg.vocab_size))

    assert ({r.rid: r.generated for r in tm.requests}
            == {r.rid: r.generated for r in jm.requests})
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["requests_finished"] == len(tm.requests)
    assert teng.pages.n_used == 0  # every page returned
    if name == "chunked_prefill":
        assert ts["prefill_chunks_total"] > 0
    if name == "shared_prefix_cow":
        assert ts["shared_page_hits_total"] > 0 and ts["cow_breaks_total"] > 0
    if name == "resize_1_2_1":
        assert ts["scale_events"] == [[2, 1, 2], [5, 2, 1]]
        assert ts["resize_moved_bytes_total"] > 0


VOCAB = smoke_variant(get_config(ARCH)).vocab_size
PRIORITY_ENGINE = dict(capacity=2, cache_len=32, prefill_bucket=8,
                       n_workers=1, seed=0, kv_layout="paged",
                       chunked_prefill=False)


def _mixed_priority(make):
    """Two low-priority decodes that fill capacity 2, then a priority-2
    arrival (the workload of test_memory.py's same-tenant preemption
    test)."""
    low = make(2, vocab_size=VOCAB, arrivals=np.zeros(2), prompt_len=(6, 8),
               max_new_tokens=(12, 14), rng=np.random.default_rng(2))
    hi = make(1, vocab_size=VOCAB, arrivals=np.array([0.05]),
              prompt_len=(6, 8), max_new_tokens=(4, 4), priority=2,
              rng=np.random.default_rng(3), rid_base=100)
    return low, hi


def _drive_priority(eng, make, before_hi=None):
    """Two ticks of the low-priority pair, then the high-priority arrival
    and one tick; `before_hi(eng)` runs between.  Returns (requests, the
    rids PARKED right after the arrival's tick), then runs to the end."""
    import time as _time
    low, hi = _mixed_priority(make)
    eng.submit(low)
    eng._now()
    for _ in range(2):
        eng.tick()
    assert len(eng._by_slot) == 2
    if before_hi is not None:
        before_hi(eng)
    eng.submit(hi)
    _time.sleep(0.06)  # let the high-priority arrival come due
    eng.tick()
    parked = sorted(r.rid for r in low + hi if r.state.name == "PARKED")
    while eng._by_slot or eng.scheduler.has_pending:
        eng.tick()
    eng.metrics.wall_s = eng._now()
    return low + hi, parked


def test_default_evict_preempts_like_the_jax_engine(model):
    """With the default `evict`, a priority-2 arrival parks the latest
    low-priority decode in both engines: equal streams, equal park/restore
    counters and the same request PARKED after the arrival's tick."""
    cfg, params, tcfg, tparams = model
    jeng = ServeEngine(cfg, paged_impl="pallas", params=params,
                       **PRIORITY_ENGINE)
    jreqs, jparked = _drive_priority(jeng, synthetic_requests)
    teng = TServeEngine(tcfg, paged_impl="kernel", device="cpu",
                        params=tparams, debug_checks=True, **PRIORITY_ENGINE)
    assert teng.evict  # the JAX paged default
    treqs, tparked = _drive_priority(teng, t_synthetic_requests)

    assert len(tparked) == 1 and tparked == jparked
    assert ({r.rid: r.generated for r in treqs}
            == {r.rid: r.generated for r in jreqs})
    js, ts = jeng.metrics.summarize(), teng.metrics.summarize()
    keys = ["parked_total", "restored_total", "kv_moved_bytes_total",
            "tokens_generated", "requests_finished", "n_ticks",
            "meta_transfers_total", "admission_bytes_total", "kv_stats"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["parked_total"] == ts["restored_total"] == 1
    assert teng.pages.n_used == 0 and teng.mem.n_parked == 0


def test_park_excess_matches_the_jax_engine(model):
    """The lease-shrink hook parks the lowest-priority, latest-admitted
    decode; the victim restores through admission and every stream still
    equals the JAX engine's."""
    cfg, params, tcfg, tparams = model
    moved = {}

    def shrink(key):
        def run(eng):
            victim = eng._pick_victim()
            moved[key] = (victim, eng.park_excess(1))
            assert victim not in eng._by_slot
        return run

    jeng = ServeEngine(cfg, paged_impl="pallas", params=params,
                       **PRIORITY_ENGINE)
    jreqs, _ = _drive_priority(jeng, synthetic_requests, shrink("jax"))
    teng = TServeEngine(tcfg, paged_impl="kernel", device="cpu",
                        params=tparams, debug_checks=True, **PRIORITY_ENGINE)
    treqs, _ = _drive_priority(teng, t_synthetic_requests, shrink("torch"))

    assert moved["torch"] == moved["jax"] and moved["torch"][1] > 0
    assert ({r.rid: r.generated for r in treqs}
            == {r.rid: r.generated for r in jreqs})
    js, ts = jeng.metrics.summarize(), teng.metrics.summarize()
    for k in ("parked_total", "restored_total", "kv_moved_bytes_total"):
        assert ts[k] == js[k]
    assert ts["parked_total"] >= 1
    assert teng.pages.n_used == 0 and teng.mem.n_parked == 0


# ---------------------------------------------------------------------------
# the serve launcher and the engine's keywords
# ---------------------------------------------------------------------------

LAUNCH = dict(smoke=True, trace="burst", requests=6, capacity=4,
              cache_len=32, prefill_bucket=8, prompt_len=(6, 14),
              max_new_tokens=(3, 6), workers=2, kv_layout="paged",
              page_size=8, seed=0)
PARK_KEYS = ["parked_total", "restored_total", "kv_moved_bytes_total"]


@pytest.mark.parametrize("option", ["straggler_policy", "evict_off",
                                    "trace_out"])
def test_launch_serve_options_match_the_jax_launcher(model, option,
                                                     tmp_path, monkeypatch):
    """`launch.serve.serve(...)` with --straggler-policy, --evict off or
    --trace-out, against the JAX package's `serve(...)` at the same
    arguments and weights: equal wall-time-free summary fields; the trace
    file passes the port's Chrome-trace validator."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch import serve as port_launch
    from repro_torch.obs import validate_chrome_trace
    cfg, params, tcfg, tparams = model
    kw = {"straggler_policy": dict(straggler_policy=True),
          "evict_off": dict(evict=False),
          "trace_out": dict(trace_out=str(tmp_path / "trace.json"))}[option]
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    js = jax_serve(ARCH, **LAUNCH, **kw)
    ts = port_launch.serve(ARCH, **LAUNCH, **kw, device="cpu")
    keys = COUNTERS + PARK_KEYS
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["requests_finished"] == LAUNCH["requests"]
    if option == "trace_out":
        assert ts["trace_out"] == kw["trace_out"]
        # the JAX engine's "jit" phase (compiles) has no counterpart
        assert set(ts["attribution"]) == set(js["attribution"]) - {"jit"}
        with open(kw["trace_out"]) as fh:
            counts = validate_chrome_trace(
                json.load(fh), require_names=["schedule", "decode.dispatch"])
        assert counts["decode.dispatch"] == ts["decode_dispatches"]


def test_launch_serve_cli_takes_the_new_flags(monkeypatch, tmp_path):
    """--straggler-policy, --evict on|off and --trace-out FILE reach
    `serve(...)`."""
    from repro_torch.launch import serve as port_launch
    seen = {}

    def fake_serve(arch, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_launch, "serve", fake_serve)
    trace = str(tmp_path / "t.json")
    monkeypatch.setattr("sys.argv", [
        "serve", "--smoke", "--straggler-policy", "--evict", "off",
        "--trace-out", trace, "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_launch.main()
    assert (seen["straggler_policy"], seen["evict"], seen["trace_out"]) \
        == (True, False, trace)


def test_engine_takes_every_keyword_of_the_jax_engine(model):
    """The port's `ServeEngine.__init__` names every keyword of the JAX
    package's with its default; an unported one raises NotImplementedError
    (naming its ROADMAP queue-A item) when given another value, and is
    accepted at its default."""
    import inspect
    from repro_torch.serve import engine as port_engine
    ref = inspect.signature(ServeEngine.__init__).parameters
    mine = inspect.signature(TServeEngine.__init__).parameters
    assert set(ref) <= set(mine)
    _, _, tcfg, tparams = model
    small = dict(capacity=2, cache_len=16, prefill_bucket=8, device="cpu",
                 params=tparams)
    others = {"decode_enabled": False}
    assert set(others) == set(port_engine._UNPORTED)
    for name, value in others.items():
        default, item = port_engine._UNPORTED[name]
        assert mine[name].default == ref[name].default == default
        with pytest.raises(NotImplementedError, match=item):
            TServeEngine(tcfg, **small, **{name: value})
        TServeEngine(tcfg, **small, **{name: default})
    for name in ("max_cached_meshes", "max_cached_fns"):
        assert mine[name].default == ref[name].default
        TServeEngine(tcfg, **small, **{name: 1})
