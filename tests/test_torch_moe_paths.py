"""The rest of the port's serving paths on the moe family against the JAX
ServeEngine (the set-up and the drop counter of test_torch_moe_serve.py:
the smoke variants of grok-1-314b and arctic-480b in fp32 on the same
parameters, eight slots, so decode steps drop expert assignments):
resize(k) across scale events, speculative decoding (ngram) on both
layouts, the overlapped tick, a worker crash and the serve launcher.
Token streams and every wall-time-free `summarize` counter must be
equal; the overlapped tick's streams must also equal the port's
synchronous ones, and a crash plan's fault and recovery events the JAX
engine's."""
import pytest

import repro.faults as JF
import repro_torch.faults as TF
from repro.models import model as JM
from repro_torch.models import model as TM

from test_torch_faults import COUNTERS
from test_torch_moe_serve import (  # noqa: F401 (fixtures)
    JAX_SIDE, PORT_SIDE, _one_torch_thread, _run, _run_both, _streams, drops,
    model)


def test_moe_resize_matches_jax(model, drops):
    _, tm = _run_both(model, kv_layout="paged", paged_impl="pallas",
                      n_workers=1, slots_per_chunk=2,
                      events=[(0, 1), (2, 2), (5, 1)])
    s = tm.summarize()
    assert s["scale_events"] == [[2, 1, 2], [5, 2, 1]]
    assert s["resize_moved_bytes_total"] > 0
    assert drops[0] > 0


@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_moe_spec_ngram_matches_jax(model, layout, drops):
    """The verify span batches spec_k + 1 tokens a slot into one call, so
    its drops differ from decode's: the JAX engine is the oracle, not the
    spec-off stream."""
    impl = dict(paged_impl="pallas") if layout == "paged" else {}
    _, tm = _run_both(model, kv_layout=layout, spec="ngram", spec_k=3,
                      **impl)
    s = tm.summarize()
    assert s["spec_drafted_total"] > 0
    assert drops[0] > 0


def test_moe_overlap_matches_sync_and_jax(model, drops):
    kw = dict(kv_layout="paged", paged_impl="pallas")
    jm, tm = _run_both(model, overlap=True, **kw)
    _, sync = _run(model, PORT_SIDE, **kw)
    assert _streams(sync) == _streams(tm)
    assert [t.meta_transfers for t in tm.ticks] \
        == [t.meta_transfers for t in jm.ticks]
    assert drops[1] > 0


def test_moe_crash_recovery_matches_jax(model, drops, monkeypatch):
    """A worker crash at tick 3: its victims restart from their prompts
    (their re-prefill shares calls with other rows, so the recovered
    streams are the JAX engine's, not the fault-free ones)."""
    got = []
    for side, F in ((JAX_SIDE, JF), (PORT_SIDE, TF)):
        inj = F.FaultInjector(F.FaultPlan([F.worker_crash(3)]))
        eng, m = _run(model, side, kv_layout="paged", paged_impl="pallas",
                      n_workers=2, fault_injector=inj)
        got.append((eng, m, inj))
    (jeng, jm, jinj), (teng, tm, tinj) = got
    assert _streams(tm) == _streams(jm)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert (tm.fault_events, tm.recovery_events) \
        == (jm.fault_events, jm.recovery_events)
    assert teng.rng.bit_generator.state == jeng.rng.bit_generator.state
    assert ts["crashes_total"] == 1 and ts["recoveries"] == 1
    assert ts["requests_finished"] == len(tm.requests)
    teng.pages.check_invariants()
    assert teng.pages.n_used == 0
    assert drops[0] > 0


def test_launch_serve_grok_smoke_matches_the_jax_launcher(model,
                                                          monkeypatch):
    """`launch.serve --arch grok-1-314b --smoke --device cpu` (and
    arctic-480b) against the JAX launcher at the same arguments and
    weights, on the launchers' default flat layout: equal wall-time-free
    summary fields.  (On the paged layout the JAX launcher always runs
    its "xla" attention and the port's defaults to the kernel: for moe
    the two differ by design, see test_torch_moe_serve.py.)"""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch import serve as port_launch
    cfg, params, _, tparams = model
    monkeypatch.setattr(JM, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: tparams)
    launch = dict(smoke=True, trace="burst", requests=8, capacity=8,
                  cache_len=48, prefill_bucket=16, prompt_len=(6, 30),
                  max_new_tokens=(3, 8), seed=0)
    arch = cfg.name.replace("-smoke", "")
    js = jax_serve(arch, **launch)
    ts = port_launch.serve(arch, **launch, device="cpu")
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["requests_finished"] == launch["requests"]
    assert ts["arch"] == js["arch"] == arch
