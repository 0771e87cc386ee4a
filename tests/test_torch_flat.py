"""The flat KV layout in the port against the JAX package: the flat cases
of tests/test_serve.py, the flat/paged A/B tests of tests/test_paged.py,
the layout-dependent defaults and errors, the serve launcher's flat
default and speculative flags, and smollm-360m's flat HEAD layout (15
query heads over 5 KV heads) at a narrow width.

Both engines run on the same parameters (the JAX tree carried across by
`params_from_numpy`) and the same workloads; the port on the CPU with
`debug_checks`.  Token streams and every wall-time-free summary counter
must be equal (the flat layout's `admission_bytes` counts the whole pool
per admission group in both, as the JAX engine rebuilds it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.models import model as JM
from repro.serve import ServeEngine, poisson_arrivals, synthetic_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import ElasticScalingPolicy as TElasticScalingPolicy
from repro_torch.core import ScaleEvent as TScaleEvent
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import poisson_arrivals as t_poisson_arrivals
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"
COUNTERS = ["requests_finished", "requests_total", "tokens_generated",
            "n_ticks", "prefill_chunks_total", "prefill_dispatches_total",
            "admission_bytes_total", "meta_transfers_total",
            "decode_dispatches", "tokens_per_dispatch",
            "shared_page_hits_total", "cow_breaks_total",
            "shared_extra_pages_mean", "occupancy_mean",
            "page_occupancy_mean", "kv_stats", "scale_events",
            "resize_moved_bytes_total"]


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
    return make(n, vocab_size=vocab, arrivals=np.zeros(n), prompt_len=prompt,
                max_new_tokens=max_new, rng=np.random.default_rng(seed))


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


_RUNS = {}


def _memo_run(model, name, workload, events=None, **kw):
    """`_run_both` once per (name, events, keywords) in this module: the
    spec-off baselines several tests compare against."""
    key = (name, tuple(events or ()), tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _run_both(model, workload, events=events, **kw)
    return _RUNS[key]


def _run_both(model, workload, events=None, **kw):
    """The same keywords and workload through both engines; equal streams
    and counters -> (jax metrics, port engine, port metrics)."""
    cfg, params, tcfg, tparams = model
    pol = ([ElasticScalingPolicy([ScaleEvent(*e) for e in events])]
           if events else [])
    tpol = ([TElasticScalingPolicy([TScaleEvent(*e) for e in events])]
            if events else [])
    jm = ServeEngine(cfg, params=params, policies=pol, **kw).run(
        workload(synthetic_requests, cfg.vocab_size))
    teng = TServeEngine(tcfg, params=tparams, policies=tpol, device="cpu",
                        debug_checks=True, **kw)
    tm = teng.run(workload(t_synthetic_requests, tcfg.vocab_size))
    assert _streams(tm) == _streams(jm)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert teng.scheduler.pool.n_used == 0
    return jm, teng, tm


# ---------------------------------------------------------------------------
# tests/test_serve.py: the flat engine
# ---------------------------------------------------------------------------


def test_per_slot_decode_matches_scalar(model):
    """Vectorized per-slot decode (right-padded prefill, per-row k_pos,
    vector positions) == per-request scalar decode, and == the JAX
    package's tokens."""
    cfg, params, tcfg, tparams = model
    rng = np.random.default_rng(0)
    lens = [5, 9]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    CACHE, BUCKET, STEPS = 20, 12, 5

    def scalar_run(prompt):
        logits, cache = TM.prefill(tcfg, tparams,
                                   torch.from_numpy(prompt)[None],
                                   cache_len=CACHE)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out = [int(tok[0, 0])]
        for i in range(STEPS - 1):
            logits, cache = TM.decode_step(tcfg, tparams, cache, tok,
                                           len(prompt) + i)
            tok = logits.argmax(-1).to(torch.int32)
            out.append(int(tok[0, 0]))
        return out

    def jax_scalar_run(prompt):
        logits, cache = JM.prefill(cfg, params, jnp.asarray(prompt)[None],
                                   rules=None, remat=False, cache_len=CACHE)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out = [int(tok[0, 0])]
        for i in range(STEPS - 1):
            logits, cache = JM.decode_step(cfg, params, cache, tok,
                                           jnp.int32(len(prompt) + i),
                                           rules=None)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(int(tok[0, 0]))
        return out

    with torch.inference_mode():
        refs = [scalar_run(p) for p in prompts]
        padded = np.zeros((2, BUCKET), np.int32)
        for i, p in enumerate(prompts):
            padded[i, : len(p)] = p
        true_len = torch.tensor(lens, dtype=torch.int32)
        logits, cache = TM.prefill(tcfg, tparams, torch.from_numpy(padded),
                                   cache_len=CACHE, true_len=true_len)
        assert tuple(cache["k_pos"].shape) == (2, CACHE)
        tok = logits.argmax(-1).to(torch.int32)
        outs = [[int(tok[i, 0])] for i in range(2)]
        pos = true_len
        for _ in range(STEPS - 1):
            logits, cache = TM.decode_step(tcfg, tparams, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            for i in range(2):
                outs[i].append(int(tok[i, 0]))
            pos = pos + 1
    assert outs == refs
    assert refs == [jax_scalar_run(p) for p in prompts]


def test_kv_survives_resize_identical_tokens(model):
    """k: 1 -> 2 -> 1 mid-run on the flat pool changes no token; the moved
    rows are counted as the JAX engine counts them (a whole row a slot)."""
    kw = dict(capacity=4, cache_len=32, prefill_bucket=8, n_workers=1,
              seed=0)
    burst = lambda mk, v: _burst(mk, v)  # noqa: E731
    _, _, ref = _memo_run(model, "burst", burst, **kw)
    _, teng, tm = _memo_run(model, "burst", burst,
                            events=[(0, 1), (3, 2), (7, 1)], **kw)
    assert teng.kv_layout == "flat" and teng.pages is None
    assert len(tm.scale_events) == 2, tm.scale_events
    assert _streams(tm) == _streams(ref)
    s = tm.summarize()
    assert s["requests_finished"] == 8
    assert s["resize_moved_bytes_total"] > 0
    assert s["resize_moved_bytes_total"] % (teng._pool_bytes // 4) == 0


def test_engine_end_to_end_smoke(model):
    """Poisson arrivals on the wall clock (admission timing may differ
    between runs, the per-request greedy streams may not)."""
    cfg, params, tcfg, tparams = model
    mk = lambda make, arr, vocab: make(  # noqa: E731
        10, vocab_size=vocab, arrivals=arr(10, 100.0,
                                           np.random.default_rng(1)),
        prompt_len=(6, 20), max_new_tokens=(4, 10),
        rng=np.random.default_rng(1))
    eng = TServeEngine(tcfg, params=tparams, capacity=4, cache_len=48,
                       prefill_bucket=8, n_workers=1, seed=0, device="cpu",
                       debug_checks=True)
    summary = eng.run(mk(t_synthetic_requests, t_poisson_arrivals,
                         tcfg.vocab_size)).summarize()
    assert summary["requests_finished"] == 10
    assert summary["tokens_per_s"] > 0
    assert summary["ttft_p50_s"] is not None
    assert summary["tpot_p50_s"] is not None
    assert 0 < summary["occupancy_mean"] <= 1
    for r in eng.metrics.requests:
        assert len(r.generated) == r.max_new_tokens
    jm = ServeEngine(cfg, params=params, capacity=4, cache_len=48,
                     prefill_bucket=8, n_workers=1, seed=0).run(
        mk(synthetic_requests, poisson_arrivals, cfg.vocab_size))
    assert _streams(eng.metrics) == _streams(jm)


def test_single_token_request_stops_at_prefill(model):
    single = lambda mk, v: _burst(mk, v, 3, prompt=(6, 10),  # noqa: E731
                                  max_new=(1, 1))
    _, teng, tm = _run_both(model, single, capacity=2, cache_len=32,
                            prefill_bucket=8, n_workers=1, seed=0)
    assert tm.summarize()["requests_finished"] == 3
    for r in tm.requests:
        assert len(r.generated) == 1
    teng.scheduler.pool.check_invariants()


def test_engine_rejects_oversized_request(model):
    _, _, tcfg, tparams = model
    eng = TServeEngine(tcfg, params=tparams, capacity=2, cache_len=16,
                       prefill_bucket=8, n_workers=1, seed=0, device="cpu")
    reqs = t_synthetic_requests(1, vocab_size=tcfg.vocab_size,
                                arrivals=np.zeros(1), prompt_len=(14, 14),
                                max_new_tokens=(8, 8))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.run(reqs)


# ---------------------------------------------------------------------------
# tests/test_paged.py: flat/paged A/B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("events", [None, [(0, 1), (3, 2), (7, 1)]],
                         ids=["steady", "resize_1_2_1"])
def test_paged_vs_flat_identical_streams(model, events):
    """The port's paged engine (both implementations) == its flat engine
    == the JAX flat engine, token for token, with and without a
    1 -> 2 -> 1 resize mid-run."""
    kw = dict(capacity=4, cache_len=32, prefill_bucket=8, n_workers=1,
              seed=0)
    burst = lambda mk, v: _burst(mk, v)  # noqa: E731
    _, _, flat = _memo_run(model, "burst", burst, events=events, **kw)
    for impl in ("xla", "pallas"):
        _, teng, paged = _run_both(model, burst, events=events,
                                   kv_layout="paged", chunked_prefill=False,
                                   paged_impl=impl, **kw)
        assert _streams(paged) == _streams(flat)
        assert paged.summarize()["requests_finished"] == 8
        teng.pages.check_invariants()
        assert teng.pages.n_used == 0


def test_paged_admission_bytes_are_page_proportional(model):
    """Both layouts count the JAX engine's admission bytes: the whole pool
    per flat admission group, exactly the written pages when paged."""
    few = lambda mk, v: _burst(mk, v, 6, seed=5, prompt=(6, 10),  # noqa
                               max_new=(2, 3))
    kw = dict(capacity=8, cache_len=64, prefill_bucket=8, n_workers=1,
              seed=0)
    fm, feng, _ = _run_both(model, few, **kw)
    fb = fm.summarize()["admission_bytes_total"]
    assert fb % feng._pool_bytes == 0 and fb > 0
    pm, peng, tm = _run_both(model, few, kv_layout="paged",
                             chunked_prefill=False, **kw)
    pb = pm.summarize()["admission_bytes_total"]
    pages_written = sum(peng.pages.pages_for(r.prompt_len)
                        for r in tm.requests)
    assert pb == pages_written * peng._page_bytes
    assert pb < fb / 4, (pb, fb)


@pytest.mark.parametrize("layout", ["flat", "paged"])
def test_slot_at_kv_capacity_finishes_instead_of_overwriting(model, layout):
    """A request that (bypassing the submit guard) would outgrow its KV
    finishes early and releases its slot, with the JAX engine's stream."""
    cfg, params, tcfg, tparams = model
    kw = dict(capacity=2, cache_len=16, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout=layout, chunked_prefill=False)
    got = {}
    for name, eng, make, vocab in (
            ("jax", ServeEngine(cfg, params=params, **kw),
             synthetic_requests, cfg.vocab_size),
            ("port", TServeEngine(tcfg, params=tparams, device="cpu",
                                  debug_checks=True, **kw),
             t_synthetic_requests, tcfg.vocab_size)):
        (req,) = _burst(make, vocab, 1, seed=6, prompt=(8, 8),
                        max_new=(64, 64))
        eng.scheduler.submit(req)  # around submit()'s up-front reject
        eng.metrics.requests.append(req)
        eng._now()
        for _ in range(32):
            if name == "jax":
                with set_mesh(eng.mesh):
                    eng.tick()
            else:
                eng.tick()
            assert eng.scheduler.pool.pos.max() <= eng.cache_len
            if not eng._by_slot:
                break
        assert req.state.value == "finished"
        assert len(req.generated) == eng.cache_len - req.prompt_len + 1
        assert eng.scheduler.pool.n_used == 0
        got[name] = list(req.generated)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# layout-dependent defaults and errors
# ---------------------------------------------------------------------------


def test_layout_defaults_and_errors(model):
    """Like the JAX engine: the flat layout is the default; prefix
    sharing, eviction and chunked prefill default on for the paged layout
    only and raise ValueError on the flat one; park needs pages; the
    paged implementations answer to their JAX names too."""
    import inspect
    _, _, tcfg, tparams = model
    kw = dict(capacity=2, cache_len=16, prefill_bucket=8, device="cpu",
              params=tparams)
    sig = inspect.signature(TServeEngine.__init__).parameters
    assert sig["kv_layout"].default == \
        inspect.signature(ServeEngine.__init__).parameters["kv_layout"]\
        .default == "flat"
    flat = TServeEngine(tcfg, **kw)
    assert (flat.kv_layout, flat.prefix_share, flat.evict,
            flat.chunked_prefill) == ("flat", False, False, False)
    assert flat.mem is None and flat.pages is None
    assert tuple(flat.k_pos.shape) == (2, 16)
    paged = TServeEngine(tcfg, kv_layout="paged", **kw)
    assert (paged.prefix_share, paged.evict, paged.chunked_prefill) == \
        (True, True, True)
    for name in ("prefix_share", "evict", "chunked_prefill"):
        with pytest.raises(ValueError, match=f"{name} requires"):
            TServeEngine(tcfg, kv_layout="flat", **{name: True}, **kw)
        TServeEngine(tcfg, kv_layout="flat", **{name: False}, **kw)
    with pytest.raises(ValueError, match="kv_layout"):
        TServeEngine(tcfg, kv_layout="ring", **kw)
    with pytest.raises(ValueError, match="spec"):
        TServeEngine(tcfg, spec="beam", **kw)
    with pytest.raises(RuntimeError, match="park requires"):
        flat.park(0)
    for alias, impl in (("xla", "gather"), ("pallas", "kernel"),
                        ("gather", "gather"), ("kernel", "kernel")):
        assert TServeEngine(tcfg, kv_layout="paged", paged_impl=alias,
                            **kw).paged_impl == impl
    with pytest.raises(ValueError, match="paged_impl"):
        TServeEngine(tcfg, kv_layout="paged", paged_impl="triton", **kw)


# ---------------------------------------------------------------------------
# smollm-360m's flat head layout (15 query heads over 5 KV heads)
# ---------------------------------------------------------------------------


def test_flat_head_layout_serves_like_the_jax_engine():
    """smollm-360m's real head ratio at the smoke width takes the flat
    HEAD layout (H_pad 16, k/v expanded by a gather): the flat KV layout
    and the paged gather path serve it with the JAX engine's streams and
    counters, speculation on and off."""
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)),
                              num_heads=15, num_kv_heads=5)
    tcfg = dataclasses.replace(t_smoke_variant(t_get_config(ARCH)),
                               num_heads=15, num_kv_heads=5)
    assert t_attn.head_layout(tcfg)[:2] == ("flat", 16)
    params = JM.init_params(cfg, jax.random.key(0))
    pair = (cfg, params, tcfg,
            TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu"))
    kw = dict(capacity=4, cache_len=32, prefill_bucket=8, n_workers=1,
              seed=0)
    burst = lambda mk, v: _burst(mk, v, 6)  # noqa: E731
    _, _, base = _run_both(pair, burst, **kw)
    _, _, spec = _run_both(pair, burst, spec="ngram", spec_k=3, **kw)
    _, _, paged = _run_both(pair, burst, kv_layout="paged",
                            chunked_prefill=False, paged_impl="xla", **kw)
    assert _streams(spec) == _streams(base) == _streams(paged)


# ---------------------------------------------------------------------------
# the serve launcher: flat default, --spec, --spec-k
# ---------------------------------------------------------------------------

LAUNCH = dict(smoke=True, trace="burst", requests=6, capacity=4,
              cache_len=32, prefill_bucket=8, prompt_len=(6, 14),
              max_new_tokens=(3, 6), workers=2, seed=0)


@pytest.mark.parametrize("case", [dict(), dict(spec="ngram", spec_k=3),
                                  dict(spec="ngram", spec_k=2,
                                       kv_layout="paged")],
                         ids=["flat_default", "flat_spec", "paged_spec"])
def test_launch_serve_matches_the_jax_launcher(model, case, monkeypatch):
    """`serve(...)` with its flat default and with --spec/--spec-k on both
    layouts, against the JAX package's `serve(...)` at the same arguments
    and weights: equal wall-time-free summary fields."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch import serve as port_launch
    _, params, _, tparams = model
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    js = jax_serve(ARCH, **LAUNCH, **case)
    ts = port_launch.serve(ARCH, **LAUNCH, **case, device="cpu")
    keys = COUNTERS + ["spec_drafted_total", "spec_accepted_total",
                       "draft_dispatches"]
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["requests_finished"] == LAUNCH["requests"]
    assert ts["kv_layout"] == case.get("kv_layout", "flat")
    assert (ts["spec_drafted_total"] > 0) == ("spec" in case)


def test_launch_serve_cli_takes_spec_flags(monkeypatch):
    """--spec and --spec-k reach `serve(...)`; --kv-layout defaults to
    flat, as in the JAX launcher."""
    from repro_torch.launch import serve as port_launch
    seen = {}

    def fake_serve(arch, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(port_launch, "serve", fake_serve)
    for argv, want in ((["--spec", "ngram", "--spec-k", "3"],
                        ("ngram", 3, "flat")),
                       (["--kv-layout", "paged"], ("off", 4, "paged"))):
        monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device",
                                         "cpu"] + argv)
        with pytest.raises(SystemExit):
            port_launch.main()
        assert (seen["spec"], seen["spec_k"], seen["kv_layout"]) == want
