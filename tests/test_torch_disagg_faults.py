"""Disaggregated serving under faults in the port against the JAX package:
the disaggregated tests of tests/test_faults.py (a handoff dropped in
flight and re-sent exactly once, the loss of the prefill pool's last
worker with its collapse to monolithic serving and the re-split when
capacity returns, the loss of the decode pool while handoffs are in
flight, and the split validation), on the tick clock.

Conventions as in tests/test_torch_disagg.py, whose helpers run both
packages and compare them: equal streams, request states, retry counts,
the disagg accounting (drops, retries, split and degraded events), each
half's summary, fault and recovery events and rng state, and the
injected fault sequence; every stream also equals the port's fault-free
flat run."""

import pytest
import torch

from repro.configs import get_config
from repro.serve import DisaggEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.serve import DisaggEngine as TDisaggEngine

from test_torch_disagg import (KW, PORT_SIDE, JAX_SIDE, burst, drive,
                               load_model, port_oracle, record, run_both,
                               streams)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model("smollm-360m")


def _plan(*make):
    """A fault plan builder for `run_both`: each `make(F)` one event from
    one side's `faults` module."""
    return lambda F: F.FaultInjector(F.FaultPlan([m(F) for m in make]))


def test_disagg_handoff_drop_retries_exactly_once(model):
    want = port_oracle(model, burst, **KW)
    _, _, teng, tm = run_both(model, burst, n_workers=2,
                              faults=_plan(lambda F: F.handoff_drop(2)),
                              **KW)
    assert streams(tm) == want  # neither lost nor decoded twice
    d = tm.summarize()["disagg"]
    assert d["handoff_drops"] == 1 and d["handoff_retries"] == 1
    assert not teng._handoff_retry


def test_disagg_prefill_pool_loss_degrades_then_resplits(model):
    """The prefill pool's last worker crashes at tick 3: the engine serves
    monolithically on the decode half, the streams unchanged; a resize to
    2 re-splits the pools, and both serve a second burst, as in the JAX
    package."""
    want = port_oracle(model, burst, **KW)
    jeng, _, teng, tm = run_both(
        model, burst, n_workers=2,
        faults=_plan(lambda F: F.worker_crash(3, pool="prefill")), **KW)
    assert streams(tm) == want
    assert teng.degraded
    assert teng.metrics.degraded_events == [(3, "enter:prefill")]
    for eng in (jeng, teng):
        eng.resize(2)  # capacity returns: two pools again
    assert not teng.degraded
    assert teng.prefill.k == 1 and teng.decode.k == 1
    assert teng.metrics.degraded_events[-1][1] == "exit"
    for eng, side in ((jeng, JAX_SIDE), (teng, PORT_SIDE)):
        drive(eng, burst(side, model[2].vocab_size, n=4, seed=9))
    assert record(teng) == record(jeng)
    second = {r.rid: r for r in teng.metrics.requests}
    assert len(second) == 8 and all(
        r.state.name == "FINISHED" for r in second.values())


def test_disagg_decode_pool_loss_is_exactly_once(model):
    """Crash the decode pool while handoffs are in flight: every request
    finishes exactly once (completed prefills keep their KV on the
    surviving prefill workers; mid-prefill restarts re-execute)."""
    want = port_oracle(model, burst, **KW)
    _, _, teng, tm = run_both(
        model, burst, n_workers=2,
        faults=_plan(lambda F: F.worker_crash(4, pool="decode")), **KW)
    assert streams(tm) == want
    assert teng.degraded
    assert tm.summarize()["requests_finished"] == len(want)


def test_disagg_split_validation(model):
    """The port refuses what the JAX package refuses, with its
    messages."""
    cfg, params, tcfg, tparams = model
    for cls, c, p, full, faults, extra in (
            (DisaggEngine, cfg, params, get_config("smollm-360m"),
             JAX_SIDE["faults"], {}),
            (TDisaggEngine, tcfg, tparams, t_get_config("smollm-360m"),
             PORT_SIDE["faults"], dict(device="cpu"))):
        with pytest.raises(ValueError, match="n_workers"):
            cls(full, n_workers=0, **extra)
        with pytest.raises(ValueError, match="prefill_workers"):
            cls(c, params=p, n_workers=4, prefill_workers=4, **KW, **extra)
        with pytest.raises(ValueError, match="prefill_workers"):
            cls(c, params=p, n_workers=4, prefill_workers=0, **KW, **extra)
        eng = cls(c, params=p, n_workers=2, **KW, **extra)
        with pytest.raises(ValueError, match="at least one worker"):
            eng.resize(0)
        ev = faults.worker_crash(0)
        ev.payload["pool"] = "encode"  # a pool neither package has
        with pytest.raises(ValueError, match="fault pool"):
            eng.apply_fault(ev)
