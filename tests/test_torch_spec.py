"""Speculative decoding in the port against the JAX package: every test of
tests/test_spec.py, on both KV layouts where the test is not about pages.

The engines run the smoke smollm-360m in fp32 on the same parameters (the
JAX tree carried across by `params_from_numpy`) and the same workloads;
the port runs on the CPU with `debug_checks`, the paged implementation
given by its JAX name ("xla" = the port's "gather", "pallas" = "kernel",
whose wrapper runs its plain version on the CPU).  Token streams, the
drafted and accepted totals, the acceptance rate, tokens per dispatch and
every wall-time-free counter must be equal; the rollback invariants are
checked on the port after every tick.

tests/test_spec.py::test_acceptance_repetitive_beats_random fails on the
JAX package itself (its repetitive workload accepts exactly 0.5 of the
drafts, not more), so its mirror holds the port's rates to the JAX
package's actual ones."""

import jax
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.models import model as JM
from repro.serve import PageAllocator, PageError, Request, ServeEngine
from repro.serve import greedy_accept, synthetic_requests
from repro.serve import NgramDrafter, DraftModelDrafter
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import ElasticScalingPolicy as TElasticScalingPolicy
from repro_torch.core import ScaleEvent as TScaleEvent
from repro_torch.models import model as TM
from repro_torch.serve import DraftModelDrafter as TDraftModelDrafter
from repro_torch.serve import NgramDrafter as TNgramDrafter
from repro_torch.serve import PageAllocator as TPageAllocator
from repro_torch.serve import PageError as TPageError
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import greedy_accept as t_greedy_accept
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"
LAYOUTS = ["flat", "paged"]
# summarize() keys that carry no wall time (jit_cache_sizes is the JAX
# engine's compile-cache bookkeeping and has no counterpart)
COUNTERS = ["requests_finished", "requests_total", "tokens_generated",
            "n_ticks", "prefill_chunks_total", "prefill_dispatches_total",
            "admission_bytes_total", "meta_transfers_total",
            "decode_dispatches", "draft_dispatches", "tokens_per_dispatch",
            "spec_drafted_total", "spec_accepted_total",
            "spec_acceptance_rate", "shared_page_hits_total",
            "cow_breaks_total", "shared_extra_pages_mean", "occupancy_mean",
            "page_occupancy_mean", "kv_stats", "scale_events",
            "resize_moved_bytes_total"]
JAX_SIDE = (synthetic_requests, Request)
PORT_SIDE = (t_synthetic_requests, TRequest)


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


def _burst(side, vocab, n=6, seed=0, prompt=(6, 16), max_new=(5, 12)):
    return side[0](n, vocab_size=vocab, arrivals=np.zeros(n),
                   prompt_len=prompt, max_new_tokens=max_new,
                   rng=np.random.default_rng(seed))


def _repetitive(side, vocab, n=6, seed=0, prompt_len=(12, 20),
                max_new=(4, 7)):
    """Prompts that tile a short random motif (prompt-lookup's best case),
    as tests/test_spec.py makes them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        motif = rng.integers(0, vocab, size=int(rng.integers(3, 5)))
        plen = int(rng.integers(*prompt_len))
        prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
        reqs.append(side[1](rid=i, prompt=prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(*max_new))))
    return reqs


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


def _run_both(model, workload, events=None, jax_kw=None, port_kw=None,
              **kw):
    """The same engine keywords and workload through both packages ->
    (jax engine, jax metrics, port engine, port metrics); asserts equal
    streams and counters."""
    cfg, params, tcfg, tparams = model
    pol = ([ElasticScalingPolicy([ScaleEvent(*e) for e in events])]
           if events else [])
    tpol = ([TElasticScalingPolicy([TScaleEvent(*e) for e in events])]
            if events else [])
    jeng = ServeEngine(cfg, params=params, policies=pol, **kw,
                       **(jax_kw or {}))
    jm = jeng.run(workload(JAX_SIDE, cfg.vocab_size))
    teng = TServeEngine(tcfg, params=tparams, policies=tpol, device="cpu",
                        debug_checks=True, **kw, **(port_kw or {}))
    tm = teng.run(workload(PORT_SIDE, tcfg.vocab_size))
    assert _streams(tm) == _streams(jm)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if teng.pages is not None:
        teng.pages.check_invariants()
        assert teng.pages.n_used == 0  # every page returned
    assert teng.scheduler.pool.n_used == 0
    return jeng, jm, teng, tm


# ---------------------------------------------------------------------------
# Drafter units + accept rule
# ---------------------------------------------------------------------------


def test_greedy_accept_prefix_rule():
    v = np.array([5, 7, 9, 2, 4])
    for fn in (t_greedy_accept, greedy_accept):
        assert fn(np.array([5, 7, 9, 2]), v) == 4
        assert fn(np.array([5, 7, 1, 2]), v) == 2
        assert fn(np.array([3]), v) == 0
        assert fn(np.empty(0, np.int64), v) == 0
    rng = np.random.default_rng(0)
    for _ in range(200):
        d, w = rng.integers(0, 3, 4), rng.integers(0, 3, 5)
        assert t_greedy_accept(d, w) == greedy_accept(d, w)


def test_ngram_drafter_continues_repetition():
    d = TNgramDrafter(max_ngram=3)
    ctx = np.tile([5, 7, 9], 6)  # ... 5 7 9 | next: 5 7 9 5
    (out,) = d.propose([ctx], 4)
    assert out.tolist() == [5, 7, 9, 5]
    # longest-suffix match wins over a shorter, more recent one
    ctx2 = np.array([1, 2, 3, 4, 9, 9, 1, 2, 3])
    (out2,) = d.propose([ctx2], 3)
    assert out2.tolist() == [4, 9, 9]
    with pytest.raises(ValueError):
        TNgramDrafter(max_ngram=1, min_ngram=2)


def test_ngram_drafter_no_match_proposes_nothing():
    d = TNgramDrafter()
    (out,) = d.propose([np.arange(32)], 4)  # all-unique context
    assert out.size == 0
    (short,) = d.propose([np.array([3])], 4)  # too short to match
    assert short.size == 0
    assert d.propose([], 4) == []


def test_ngram_drafter_prefers_most_recent_occurrence():
    ctx = np.array([4, 6, 1, 4, 8, 2, 4])
    d = TNgramDrafter(max_ngram=1)
    (out,) = d.propose([ctx], 2)
    assert out.tolist() == [8, 2]


def test_ngram_drafter_matches_jax_on_random_contexts():
    """Small-alphabet contexts of every length up to 40, budgets 1-5, a
    short lookback: the port's drafts are the JAX package's."""
    rng = np.random.default_rng(1)
    mine, ref = TNgramDrafter(max_lookback=24), NgramDrafter(max_lookback=24)
    ctxs = [rng.integers(0, 4, n) for n in range(41)]
    for k in range(1, 6):
        got, want = mine.propose(ctxs, k), ref.propose(ctxs, k)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_draft_model_drafter_matches_jax(model):
    """The draft model's proposals (power-of-two batch and length buckets,
    pad rows, prefill then k-1 decode steps) are the JAX drafter's."""
    cfg, params, tcfg, tparams = model
    rng = np.random.default_rng(2)
    ctxs = [rng.integers(0, cfg.vocab_size, n) for n in (5, 11, 3)]
    ref = DraftModelDrafter(cfg, params)
    mine = TDraftModelDrafter(tcfg, tparams, device="cpu")
    for k in (1, 3):
        got, want = mine.propose(ctxs, k), ref.propose(ctxs, k)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert all(len(g) == k for g in got)
    assert mine.propose([], 3) == []
    assert TDraftModelDrafter.dispatches_per_propose == 1


# ---------------------------------------------------------------------------
# Bit-equality: speculative == baseline greedy, port == JAX
# ---------------------------------------------------------------------------


def _base(layout):
    kw = dict(capacity=4, cache_len=32, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout=layout)
    if layout == "paged":
        kw["chunked_prefill"] = False
    return kw


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_matches_baseline_streams(model, layout):
    burst = lambda side, v: _burst(side, v)  # noqa: E731
    _, jm_off, _, tm_off = _memo_run(model, "burst", burst, **_base(layout))
    _, jm, _, tm = _run_both(model, burst, spec="ngram", spec_k=3,
                             **_base(layout))
    assert _streams(tm) == _streams(tm_off)
    s = tm.summarize()
    assert s["requests_finished"] == 6
    assert s["spec_accepted_total"] > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_matches_baseline_across_resize(model, layout):
    """k: 1 -> 2 -> 1 mid-run with speculation on: streams stay the
    baseline's and the resize moves are the JAX engine's."""
    burst = lambda side, v: _burst(side, v)  # noqa: E731
    _, _, _, tm_off = _memo_run(model, "burst", burst, **_base(layout))
    _, _, _, tm = _run_both(model, burst, events=[(0, 1), (2, 2), (5, 1)],
                            spec="ngram", spec_k=2, **_base(layout))
    assert len(tm.scale_events) == 2, tm.scale_events
    assert tm.summarize()["resize_moved_bytes_total"] > 0
    assert _streams(tm) == _streams(tm_off)


def test_spec_pallas_impl_matches_baseline(model):
    """The paged kernel (its plain version here) scores all k+1 positions
    in one call (q_span > 1) and reproduces the baseline stream."""
    kw = dict(capacity=2, cache_len=16, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout="paged", chunked_prefill=False)
    small = lambda side, v: _burst(side, v, 3, prompt=(4, 8),  # noqa: E731
                                   max_new=(3, 6))
    _, _, _, tm_off = _run_both(model, small, **kw)
    _, _, teng, tm = _run_both(model, small, spec="ngram", spec_k=2,
                               paged_impl="pallas", **kw)
    assert teng.paged_impl == "kernel"
    assert _streams(tm) == _streams(tm_off)


def test_pallas_chunked_prefill_matches_xla(model):
    """The kernel impl drives the chunked-prefill spans too; streams match
    the gather path."""
    kw = dict(capacity=2, cache_len=48, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout="paged", prefill_chunk=8)
    long = lambda side, v: _burst(side, v, 3, seed=4,  # noqa: E731
                                  prompt=(18, 30), max_new=(3, 5))
    _, _, _, tm_x = _run_both(model, long, paged_impl="xla", **kw)
    _, _, _, tm_p = _run_both(model, long, paged_impl="pallas", **kw)
    assert tm_p.summarize()["prefill_chunks_total"] > 0
    assert _streams(tm_p) == _streams(tm_x)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_draft_model_same_params_accepts_everything(model, layout):
    """A draft model with the TARGET's own params drafts the target's own
    greedy stream: acceptance exactly 1.0 in both packages."""
    cfg, params, tcfg, tparams = model
    burst = lambda side, v: _burst(side, v)  # noqa: E731
    _, _, _, tm_off = _memo_run(model, "burst", burst, **_base(layout))
    _, jm, _, tm = _run_both(
        model, burst, spec="draft", spec_k=3,
        jax_kw=dict(draft_cfg=cfg, draft_params=params),
        port_kw=dict(draft_cfg=tcfg, draft_params=tparams), **_base(layout))
    s = tm.summarize()
    assert _streams(tm) == _streams(tm_off)
    assert s["spec_acceptance_rate"] == 1.0
    assert s["tokens_per_dispatch"] > 1.3


def test_draft_without_params_warns_and_halves_depth(model):
    """spec='draft' without draft_params: the JAX engine's warning and its
    half-depth random draft model, made from the engine's seed."""
    _, _, tcfg, tparams = model
    with pytest.warns(UserWarning, match="draft_params"):
        eng = TServeEngine(tcfg, params=tparams, device="cpu", spec="draft",
                           capacity=2, cache_len=16, prefill_bucket=8)
    assert eng.drafter.cfg.num_layers == max(1, tcfg.num_layers // 2)
    assert eng.drafter.cfg.name == tcfg.name + "-draft"


def test_spec_with_chunked_prefill(model):
    """Speculative decode of in-flight streams interleaves with chunked
    prefill of long prompts without disturbing either."""
    kw = dict(capacity=4, cache_len=48, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout="paged")
    long = lambda side, v: _burst(side, v, 4, seed=3,  # noqa: E731
                                  prompt=(18, 30), max_new=(3, 5))
    _, _, _, tm_off = _memo_run(model, "long", long, chunked_prefill=False,
                                **kw)
    _, _, _, tm = _run_both(model, long, prefill_chunk=8, spec="ngram",
                            spec_k=3, **kw)
    assert tm.summarize()["prefill_chunks_total"] > 0
    assert _streams(tm) == _streams(tm_off)


# ---------------------------------------------------------------------------
# Acceptance rates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_acceptance_repetitive_beats_random(model, layout):
    """The mirror of the JAX test that fails on the JAX package itself:
    the port's acceptance rates on the repetitive and the random workload
    equal the JAX engine's (whatever their order), and prompt lookup
    accepts drafts on both."""
    accs = {}
    for name, work in (
            ("rep", lambda side, v: _repetitive(side, v, seed=1)),
            ("rand", lambda side, v: _burst(side, v, 6, seed=1,
                                            prompt=(12, 19),
                                            max_new=(4, 7)))):
        _, jm, _, tm = _run_both(model, work, capacity=8, cache_len=64,
                                 prefill_bucket=16, n_workers=1, seed=0,
                                 kv_layout=layout, spec="ngram", spec_k=4)
        accs[name] = (tm.summarize()["spec_acceptance_rate"],
                      jm.summarize()["spec_acceptance_rate"])
    assert all(mine == ref for mine, ref in accs.values()), accs
    assert all(mine > 0 for mine, _ in accs.values()), accs


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_raises_tokens_per_dispatch(model, layout):
    """The payoff metric: >= 1.3x tokens per dispatch at equal output on
    the repetitive workload, and the JAX engine's ratio."""
    rep = lambda side, v: _repetitive(side, v, n=8, seed=1,  # noqa: E731
                                      max_new=(16, 28))
    kw = dict(capacity=8, cache_len=64, prefill_bucket=16, n_workers=1,
              seed=0, kv_layout=layout)
    out = {}
    for mode in ("off", "ngram"):
        _, _, _, tm = _run_both(model, rep, spec=mode, spec_k=4, **kw)
        out[mode] = (_streams(tm), tm.summarize()["tokens_per_dispatch"])
    assert out["ngram"][0] == out["off"][0]
    assert out["ngram"][1] / out["off"][1] >= 1.3, out


# ---------------------------------------------------------------------------
# Rollback invariants (lengths / block tables / free list)
# ---------------------------------------------------------------------------


def _tick_all(eng, jax_engine):
    """Tick to the end; -> per-tick (drafted, accepted) and, on the port,
    each tick's live-page check."""
    seen = []
    while eng._by_slot or eng.scheduler.has_pending or eng._prefilling:
        if jax_engine:
            with set_mesh(eng.mesh):
                rec = eng.tick()
        else:
            rec = eng.tick()  # debug_checks validates tables per tick
            for slot in eng._by_slot:
                assert eng.pages.n_pages_of(slot) == eng.pages.pages_for(
                    int(eng.scheduler.pool.pos[slot]))
        seen.append((rec.spec_drafted, rec.spec_accepted))
    return seen


def test_rollback_frees_rejected_draft_pages(model):
    """Partial rejection with page_size 4 and k 4 crosses page boundaries:
    after every tick each live slot holds exactly the pages its live
    tokens need, and the run ends with an empty owner map; the per-tick
    drafted/accepted counts are the JAX engine's."""
    cfg, params, tcfg, tparams = model
    kw = dict(capacity=4, cache_len=32, prefill_bucket=8, page_size=4,
              n_workers=1, seed=0, kv_layout="paged", chunked_prefill=False,
              spec="ngram", spec_k=4)
    runs = {}
    for name, eng, side, vocab in (
            ("jax", ServeEngine(cfg, params=params, **kw), JAX_SIDE,
             cfg.vocab_size),
            ("port", TServeEngine(tcfg, params=tparams, device="cpu",
                                  debug_checks=True, **kw), PORT_SIDE,
             tcfg.vocab_size)):
        reqs = _burst(side, vocab, 6, seed=2, prompt=(6, 12),
                      max_new=(6, 12))
        eng.submit(reqs)
        eng._now()
        runs[name] = (_tick_all(eng, name == "jax"),
                      {r.rid: list(r.generated) for r in reqs}, eng)
    assert runs["port"][:2] == runs["jax"][:2]
    assert any(d > a for d, a in runs["port"][0]), \
        "workload never exercised a rejected draft"
    eng = runs["port"][2]
    eng.pages.check_invariants()
    assert eng.pages.n_used == 0
    assert eng.scheduler.pool.n_used == 0


def test_pages_trim():
    for pa_cls, err in ((TPageAllocator, TPageError),
                        (PageAllocator, PageError)):
        pa = pa_cls(n_pages=9, page_size=4)
        t = pa.alloc_slot(0, 15)  # 4 pages
        freed = pa.trim(0, 6)  # keep 2
        assert freed == t[2:] and pa.n_pages_of(0) == 2
        assert pa.trim(0, 6) == []  # idempotent
        pa.check({0: 6})
        with pytest.raises(err):
            pa.check({0: 3})  # over-coverage now detected
        with pytest.raises(err):
            pa.trim(1, 0)  # no table
        pa.alloc_slot(1, 8 * 4 - 2 * 4)  # rest of the pool
        pa.check_invariants()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_at_kv_capacity_finishes_cleanly(model, layout):
    """A slot at the KV boundary degrades its draft budget to fit and
    finishes instead of overwriting, with the JAX engine's stream."""
    cfg, params, tcfg, tparams = model
    kw = dict(capacity=2, cache_len=16, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout=layout, chunked_prefill=False, spec="ngram",
              spec_k=4)
    got = {}
    for name, eng, side, vocab in (
            ("jax", ServeEngine(cfg, params=params, **kw), JAX_SIDE,
             cfg.vocab_size),
            ("port", TServeEngine(tcfg, params=tparams, device="cpu",
                                  debug_checks=True, **kw), PORT_SIDE,
             tcfg.vocab_size)):
        (req,) = _burst(side, vocab, 1, seed=6, prompt=(8, 8),
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
        got[name] = list(req.generated)
        if eng.pages is not None:
            eng.pages.check_invariants()
            assert eng.pages.n_used == 0
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# Batched chunked prefill (satellite)
# ---------------------------------------------------------------------------


def test_batched_chunked_prefill_fewer_dispatches_same_streams(model):
    """Several long prompts mid-prefill on the same tick share one batched
    chunk forward per table-width bucket; tokens are unchanged."""
    kw = dict(capacity=4, cache_len=48, prefill_bucket=8, n_workers=1,
              seed=0, kv_layout="paged")
    long = lambda side, v: _burst(side, v, 4, seed=3,  # noqa: E731
                                  prompt=(18, 30), max_new=(3, 5))
    _, _, _, tm_off = _memo_run(model, "long", long, chunked_prefill=False,
                                **kw)
    _, _, _, tm = _run_both(model, long, prefill_chunk=8, **kw)
    s = tm.summarize()
    assert _streams(tm) == _streams(tm_off)
    assert s["prefill_chunks_total"] > 0
    assert s["prefill_dispatches_total"] < s["prefill_chunks_total"], s


def test_spec_trace_spans_match_the_jax_engine(model):
    """The speculative tick's phase spans (draft, verify.dispatch,
    rollback, device_wait on the verify track) are the JAX engine's."""
    from repro.obs import Tracer
    from repro_torch.obs import Tracer as TTracer
    cfg, params, tcfg, tparams = model
    names = {}
    for name, eng_cls, tr, p, c, side in (
            ("jax", ServeEngine, Tracer(), params, cfg, JAX_SIDE),
            ("port", TServeEngine, TTracer(), tparams, tcfg, PORT_SIDE)):
        kw = dict(device="cpu") if name == "port" else {}
        eng = eng_cls(c, params=p, tracer=tr, spec="ngram", spec_k=3,
                      **_base("paged"), **kw)
        eng.run(_burst(side, c.vocab_size))
        names[name] = {(e.name, e.track) for e in tr.spans()
                       if e.name in ("draft", "verify.dispatch", "rollback",
                                     "device_wait")}
    assert {n for n, _ in names["port"]} == {"draft", "verify.dispatch",
                                             "rollback", "device_wait"}
    assert names["port"] == names["jax"]
