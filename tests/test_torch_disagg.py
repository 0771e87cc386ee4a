"""Disaggregated serving (`DisaggEngine`) in the port against the JAX
package: the stream tests of tests/test_disagg.py (bit identity with the
monolithic flat oracle, across a scheduled split rebalance and total-worker
resizes, under speculation and chunked prefill) and the disaggregated
tests of tests/test_overlap.py, each run three ways (the port
synchronously, the port overlapped, the JAX package overlapped).

Both packages run the smoke smollm-360m in fp32 on the same parameters
(the JAX tree carried across by `params_from_numpy`) and the same
workload; the port runs on the CPU with `debug_checks`.  Both engines run
on a tick clock (one tick, one simulated second), so every summary field
is comparable, TTFT and handoff delay included.  `run_both` asserts equal
token streams, request states and retry-after hints, the disagg
accounting (handoffs, handoff bytes, drops, retries, split and degraded
events), each half's summary, event lists, per-tick metadata transfers
and engine rng state.  The split policies' wall-time input (per-pool host
tick-time EMAs) never reaches a compared run: the runs here use no policy
or `ScheduledSplitPolicy`; tests/test_torch_disagg_handoff.py compares
`QueueSplitPolicy.decide` as a function, and every other input a policy
is shown, tick by tick, through a recording policy.

The handoff, tracing, overload, moe and launcher tests are in
tests/test_torch_disagg_handoff.py, the fault tests in
tests/test_torch_disagg_faults.py; the orchestrator test
(tests/test_disagg.py:268) is in tests/test_torch_cluster_faults.py."""

import jax
import numpy as np
import pytest
import torch

import repro.faults as JF
import repro_torch.faults as TF
from repro.configs import get_config, smoke_variant
from repro.models import model as JM
from repro.serve import (DisaggEngine, Request, ScheduledSplitPolicy,
                         synthetic_requests)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import model as TM
from repro_torch.serve import DisaggEngine as TDisaggEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ScheduledSplitPolicy as TScheduledSplitPolicy
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"
KW = dict(capacity=4, cache_len=32, prefill_bucket=8, seed=0)
# the JAX engine's compile-cache bookkeeping has no counterpart
NOT_COMPARED = {"jit_cache_sizes"}
# summary keys that carry wall time when an engine runs on the wall clock
WALL = {"tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
        "tpot_p99_s", "queue_delay_p50_s", "queue_delay_p99_s",
        "handoff_delay_p50_s", "handoff_delay_p99_s", "slo_met", "goodput",
        "wall_s"}
JAX_SIDE = dict(engine=DisaggEngine, make=synthetic_requests,
                request=Request, faults=JF, scheduled=ScheduledSplitPolicy)
PORT_SIDE = dict(engine=TDisaggEngine, make=t_synthetic_requests,
                 request=TRequest, faults=TF,
                 scheduled=TScheduledSplitPolicy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines here run thousands of tiny CPU ops: one intra-op thread
    each keeps them from contending with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_model(arch):
    """(JAX config, JAX params, port config, port params): the JAX init
    carried across through numpy."""
    cfg = smoke_variant(get_config(arch))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(arch))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def model():
    return load_model(ARCH)


def burst(side, vocab, n=8, seed=0, prompt=(6, 16), max_new=(5, 9), **kw):
    return side["make"](n, vocab_size=vocab, arrivals=np.zeros(n),
                        prompt_len=prompt, max_new_tokens=max_new,
                        rng=np.random.default_rng(seed), **kw)


def streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def port_oracle(model, workload, **kw):
    """The port's flat monolithic engine on one worker: the bit-exactness
    reference of tests/test_disagg.py."""
    _, _, tcfg, tparams = model
    eng = TServeEngine(tcfg, params=tparams, device="cpu", kv_layout="flat",
                       n_workers=1, **kw)
    return streams(eng.run(workload(PORT_SIDE, tcfg.vocab_size)))


def build(side, c, p, *, tick_clock=True, **kw):
    """One side's DisaggEngine; with `tick_clock` both halves read
    `eng._clk`, which `drive` sets to the tick index before each tick."""
    if side is PORT_SIDE:
        kw = dict(device="cpu", debug_checks=True, **kw)
    holder = {}
    if tick_clock:
        kw["clock"] = lambda: holder["e"]._clk
    eng = side["engine"](c, params=p, **kw)
    eng._clk = 0.0
    holder["e"] = eng
    return eng


def drive(eng, reqs, *, before=None, max_ticks=400):
    """Tick-clock drive (an engine built with `clock=` refuses run()): tick
    t runs at time t; `before(eng)` runs ahead of every tick."""
    eng.submit(reqs)
    while not eng.drained and eng._tick < max_ticks:
        if before is not None:
            before(eng)
        eng._clk = float(eng._tick)
        eng.tick()
    eng.finalize(float(eng._tick))
    return eng.metrics


def clean(summary, skip):
    """A `DisaggMetrics.summarize()` without the `skip` keys, at the top
    and in each half's summary."""
    out = {k: v for k, v in summary.items() if k not in skip}
    if "disagg" in out:
        out["disagg"] = {k: ({kk: vv for kk, vv in v.items()
                              if kk not in skip}
                             if isinstance(v, dict) else v)
                         for k, v in out["disagg"].items()}
    return out


def record(eng):
    """Everything of a run that carries no wall time, besides the
    summary: per request (stream, state, retries, retry-after hint), the
    disagg accounting, and per half its event lists, per-tick metadata
    transfers, worker count and rng state."""
    m = eng.metrics
    reqs = {r.rid: (list(r.generated), r.state.name, r.retries,
                    r.retry_after) for r in m.requests}
    halves = {}
    for name in ("prefill", "decode"):
        half = getattr(eng, name)
        hm = half.metrics
        halves[name] = (hm.fault_events, hm.recovery_events,
                        hm.brownout_events, hm.breaker_events,
                        hm.scale_events, hm.resize_moves,
                        [t.meta_transfers for t in hm.ticks],
                        [t.n_active for t in hm.ticks], half.k,
                        half.rng.bit_generator.state)
    return (reqs, m.handoffs, m.handoff_bytes, m.handoff_drops,
            m.handoff_retries, [tuple(e) for e in m.split_events],
            [tuple(e) for e in m.degraded_events], eng.degraded,
            eng.total_workers, halves)


def run_both(model, workload, *, tick_clock=True, faults=None, split=None,
             before=None, jax_kw=None, port_kw=None, **kw):
    """The same keywords, workload, fault plan (`faults(module)` builds an
    injector from one side's `faults` module) and split schedule through
    both packages' DisaggEngine (`jax_kw`, `port_kw`: one side's own
    keywords) -> (jax engine, jax metrics, port engine,
    port metrics); asserts equal records and summaries (on the wall
    clock, without the wall-time keys)."""
    cfg, params, tcfg, tparams = model
    out = []
    for side, c, p, extra in ((JAX_SIDE, cfg, params, jax_kw or {}),
                              (PORT_SIDE, tcfg, tparams, port_kw or {})):
        if faults is not None:
            kw["fault_injector"] = faults(side["faults"])
        if split is not None:
            kw["split_policy"] = side["scheduled"](split)
        eng = build(side, c, p, tick_clock=tick_clock, **kw, **extra)
        reqs = workload(side, c.vocab_size)
        m = (drive(eng, reqs, before=before) if tick_clock
             else eng.run(reqs))
        out.append((eng, m))
    (jeng, jm), (teng, tm) = out
    assert record(teng) == record(jeng)
    skip = NOT_COMPARED | (set() if tick_clock else WALL)
    assert clean(tm.summarize(), skip) == clean(jm.summarize(), skip)
    if faults is not None:
        assert teng.fault_injector.summary() \
            == jeng.fault_injector.summary()
    return jeng, jm, teng, tm


# ---------------------------------------------------------------------------
# Bit identity with the monolithic oracle and with the JAX package
# ---------------------------------------------------------------------------


def test_disagg_stream_matches_flat_oracle(model):
    want = port_oracle(model, burst, **KW)
    _, _, teng, tm = run_both(model, burst, n_workers=2, **KW)
    assert streams(tm) == want
    assert tm.handoffs == len(want)  # every request crossed exactly once
    assert tm.handoff_bytes > 0
    s = tm.summarize()
    assert s["requests_finished"] == len(want)  # each request counted once
    assert s["disagg"]["handoffs"] == len(want)
    # one params module for both halves: the same tensors, not copies
    assert teng.decode.params is teng.prefill.params
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        teng.prefill.params.parameters(), teng.decode.params.parameters()))


def test_disagg_rebalance_bit_identical(model):
    """A scheduled mid-run split change must not perturb the streams."""
    kw = dict(capacity=4, cache_len=48, prefill_bucket=8, seed=0)

    def reqs(side, vocab):
        return burst(side, vocab, n=10, seed=3, prompt=(6, 20),
                     max_new=(4, 8))

    want = port_oracle(model, reqs, **kw)
    _, _, _, tm = run_both(model, reqs, n_workers=3,
                           split=[(2, 2), (5, 1)], **kw)
    assert streams(tm) == want
    kps = [kp for _, kp, _ in tm.split_events]
    assert 2 in kps and kps[-1] == 1  # both scheduled moves happened


def test_disagg_resize_bit_identical(model):
    """Total-worker resizes mid-run keep the streams and re-split both
    pools."""
    def resize(eng):
        if eng._tick == 2:
            eng.resize(4)
        if eng._tick == 5:
            eng.resize(2)

    want = port_oracle(model, lambda s, v: burst(s, v, seed=5), **KW)
    _, _, teng, tm = run_both(model, lambda s, v: burst(s, v, seed=5),
                              n_workers=2, before=resize, **KW)
    assert streams(tm) == want
    totals = {kp + kd for _, kp, kd in tm.split_events}
    assert 4 in totals and 2 in totals
    assert teng.prefill.k + teng.decode.k == 2


def motif_requests(side, vocab):
    """Six prompts tiling a random 4-token motif (tests/test_disagg.py's
    spec workload): prompt lookup accepts drafts after the handoff."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        motif = rng.integers(0, vocab, size=4)
        prompt = np.tile(motif, 5)[:18]
        reqs.append(side["request"](rid=i, prompt=prompt.astype(np.int32),
                                    max_new_tokens=10, arrival_time=0.0))
    return reqs


def test_disagg_handoff_under_spec(model):
    """Speculation lives on the decode pool only; the streams stay the
    spec-off flat oracle's and drafts are accepted after the handoff."""
    kw = dict(capacity=4, cache_len=48, prefill_bucket=8, seed=0)
    want = port_oracle(model, motif_requests, **kw)
    _, _, _, tm = run_both(model, motif_requests, n_workers=2,
                           spec="ngram", spec_k=4, **kw)
    assert streams(tm) == want
    assert tm.decode.summarize()["spec_accepted_total"] > 0
    assert tm.prefill.summarize()["spec_drafted_total"] == 0


def test_disagg_chunked_prefill_handoff(model):
    """Long prompts prefill in chunks on the prefill pool over several
    ticks, then hand off once complete."""
    kw = dict(capacity=4, cache_len=64, prefill_bucket=8, seed=0)

    def reqs(side, vocab):
        return burst(side, vocab, n=6, seed=7, prompt=(20, 40),
                     max_new=(4, 6))

    want = port_oracle(model, reqs, **kw)
    _, _, _, tm = run_both(model, reqs, n_workers=2, chunked_prefill=True,
                           prefill_chunk=8, **kw)
    assert streams(tm) == want
    assert tm.prefill.summarize()["prefill_chunks_total"] > len(want)


# ---------------------------------------------------------------------------
# The overlapped tick: port sync == port overlapped == JAX overlapped
# ---------------------------------------------------------------------------


def run_three(model, workload, **kw):
    """The port synchronously, then both packages overlapped (`run_both`,
    which holds the port's overlapped run to the JAX package's) -> (port
    overlapped engine, its metrics, the port's synchronous streams)."""
    _, _, tcfg, tparams = model
    sync = build(PORT_SIDE, tcfg, tparams, **kw)
    want = streams(drive(sync, workload(PORT_SIDE, tcfg.vocab_size)))
    _, _, teng, tm = run_both(model, workload, overlap=True, **kw)
    assert teng.overlap and teng.decode.overlap_hook is not None
    assert streams(tm) == want
    return teng, tm, want


def test_overlap_bit_identical_disagg(model):
    _, tm, want = run_three(model, burst, n_workers=2, **KW)
    assert tm.handoffs == len(want)  # every request crossed exactly once
    # the decode pool's prep window drained some handoffs
    assert tm.handoffs > 0


def test_overlap_bit_identical_disagg_spec_chunked(model):
    kw = dict(capacity=4, cache_len=96, prefill_bucket=8, prefill_chunk=8,
              spec="ngram", n_workers=2, seed=0)
    run_three(model, lambda s, v: burst(s, v, n=4, prompt=(40, 60),
                                        max_new=(3, 5)), **kw)


def test_overlap_drains_within_bounded_ticks(model):
    """The overlapped loop (its deferred settles and the handoff drain
    hook) drains a full-pipeline workload in bounded ticks; a settle left
    pending or a handoff stuck between the pools would hang or fail."""
    teng, tm, _ = run_three(
        model, lambda s, v: burst(s, v, n=6, prompt=(10, 50),
                                  max_new=(4, 8)),
        n_workers=2, spec="ngram", capacity=4, cache_len=96,
        prefill_bucket=8, prefill_chunk=8, seed=0)
    assert teng.drained and teng._tick < 400
    assert all(len(r.generated) == r.max_new_tokens for r in tm.requests)
