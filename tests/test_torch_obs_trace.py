"""The port's tracer on the training path: the program tracer records
exactly while a `torch.profiler` session records, each span is also a
profiler range of its name, a new session drops the last one's events,
spans know their parent (so self time is a subtraction), device spans
fall back to the host clock on the CPU, and a traced train step is the
untraced one bit for bit."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.obs import NOOP_SPAN, PROGRAM_TRACER, Tracer
from repro_torch.optim import init_opt_state


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _earlier_sessions_ended():
    """Each test starts a session of its own: a read while no profiler
    records marks the end of any earlier one (a span would too)."""
    PROGRAM_TRACER.events


def _program_spans():
    """The program tracer's events but the collector's passes (which may
    fall anywhere), each as (name, its parent's name, args)."""
    evs = PROGRAM_TRACER.events
    return [(e.name, evs[e.parent].name if e.parent is not None else None,
             e.args) for e in evs if e.name != "python.gc"]


class _Clock:
    """A clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_program_tracer_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    before = list(PROGRAM_TRACER.events)
    assert not PROGRAM_TRACER.enabled
    assert PROGRAM_TRACER.span("engine.iteration", it=0) is NOOP_SPAN
    assert PROGRAM_TRACER.device_span("train.forward",
                                      device="cpu") is NOOP_SPAN
    with PROGRAM_TRACER.span("cocoa.pools"):
        pass
    PROGRAM_TRACER.instant("x")
    assert PROGRAM_TRACER.events == before and opened == []
    # an injected tracer records without a profiler, and opens no range
    trc = Tracer()
    with trc.span("decode.dispatch"):
        pass
    assert [e.name for e in trc.events] == ["decode.dispatch"]
    assert opened == []
    with _cpu_profile():
        with PROGRAM_TRACER.span("engine.iteration"):
            pass
    assert opened == ["engine.iteration"]


def test_spans_stand_in_the_profiler_with_parents_and_self_time():
    clock = _Clock()
    trc = Tracer(clock=clock)
    with _cpu_profile() as prof:
        with trc.span("engine.iteration", it=7):            # [0, 10]
            clock.t = 1.0
            with trc.span("engine.schedule"):               # [1, 3]
                clock.t = 3.0
            with trc.span("engine.solver_step"):            # [3, 9]
                with trc.span("cocoa.pools"):               # [3, 4]
                    clock.t = 4.0
                with trc.span("cocoa.da_to_host", cat="device",
                              bytes=64):                    # [4, 8.5]
                    clock.t = 8.5
                clock.t = 9.0
            trc.instant("engine.note")
            clock.t = 10.0
        with PROGRAM_TRACER.span("engine.iteration"):
            with PROGRAM_TRACER.span("engine.metric"):
                with PROGRAM_TRACER.span("cocoa.gap"):
                    pass
    names = {e.name for e in prof.events()}
    assert {"engine.iteration", "engine.schedule", "engine.solver_step",
            "cocoa.pools", "cocoa.da_to_host", "engine.metric",
            "cocoa.gap"} <= names
    evs = trc.events
    by = {e.name: i for i, e in enumerate(evs)}
    parent = {e.name: (evs[e.parent].name if e.parent is not None else None)
              for e in evs}
    assert parent == {"engine.schedule": "engine.iteration",
                      "cocoa.pools": "engine.solver_step",
                      "cocoa.da_to_host": "engine.solver_step",
                      "engine.solver_step": "engine.iteration",
                      "engine.note": "engine.iteration",
                      "engine.iteration": None}
    assert evs[by["engine.iteration"]].args == {"it": 7}
    assert evs[by["cocoa.da_to_host"]].args == {"bytes": 64}
    assert [e.depth for e in evs] == [1, 2, 2, 1, 1, 0]

    def self_time(i):
        return evs[i].dur - sum(e.dur for e in evs
                                if e.parent == i and e.ph == "X")
    assert self_time(by["engine.iteration"]) == pytest.approx(2.0)
    assert self_time(by["engine.solver_step"]) == pytest.approx(0.5)
    assert self_time(by["cocoa.pools"]) == pytest.approx(1.0)
    chrome = trc.to_chrome()["traceEvents"]
    assert [e["args"].get("parent") for e in chrome if e["ph"] != "M"] == \
        [e.parent for e in evs]
    obs.validate_chrome_trace(trc.to_chrome(), ["cocoa.pools"])
    assert _program_spans() == [("cocoa.gap", "engine.metric", {}),
                                ("engine.metric", "engine.iteration", {}),
                                ("engine.iteration", None, {})]


@pytest.mark.parametrize("between", ["span", "read"])
def test_a_second_session_drops_the_first(between):
    with _cpu_profile():
        with PROGRAM_TRACER.span("engine.iteration", it=0):
            pass
    # the first session's end is seen by a span or a read while it is off
    if between == "span":
        with PROGRAM_TRACER.span("engine.iteration", it=1):
            pass
    assert _program_spans() == [("engine.iteration", None, {"it": 0})]
    with _cpu_profile():
        with PROGRAM_TRACER.span("engine.iteration", it=2):
            with PROGRAM_TRACER.span("cocoa.pools"):
                pass
    assert _program_spans() == [("cocoa.pools", "engine.iteration", {}),
                                ("engine.iteration", None, {"it": 2})]


def test_gc_passes_are_spans_while_the_program_tracer_records():
    import gc
    with _cpu_profile() as prof:
        with PROGRAM_TRACER.span("cocoa.alpha_scatter"):
            gc.collect()
    gcs = [e for e in PROGRAM_TRACER.events if e.name == "python.gc"]
    assert gcs and all(e.args["generation"] == 2 for e in gcs)
    assert all(PROGRAM_TRACER.events[e.parent].name == "cocoa.alpha_scatter"
               for e in gcs)
    assert "python.gc" in {e.name for e in prof.events()}
    n = len(PROGRAM_TRACER.events)
    gc.collect()  # off: nothing recorded
    assert len(PROGRAM_TRACER.events) == n


def test_device_span_on_the_cpu_is_the_host_clock():
    clock = _Clock()
    trc = Tracer(clock=clock)
    for device in ("cpu", None, torch.device("cpu")):
        with trc.device_span("train.forward", device=device, micro=1):
            clock.t += 2.5
    assert [e.dur for e in trc.events] == [2.5, 2.5, 2.5]
    assert all(e.cat == "device" and e.args == {"micro": 1}
               for e in trc.events)
    with _cpu_profile():
        t0 = time.perf_counter()
        with PROGRAM_TRACER.device_span("train.backward", device="cpu"):
            time.sleep(0.01)
        wall = time.perf_counter() - t0
    (ev,) = [e for e in PROGRAM_TRACER.events if e.name != "python.gc"]
    assert 0.01 <= ev.dur <= wall


def _train_run(cfg, tc, traced: bool):
    """Two train steps from one start; the losses, the weights, and each
    traced step's program spans as (name, bytes)."""
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(M.param_dict(params), optimizer=tc.optimizer)
    step = steps.make_train_step(cfg, tc)
    g = np.random.default_rng(1)
    losses, spans = [], []
    for _ in range(2):
        toks = g.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "weights": g.uniform(0.5, 1.5, 4).astype(np.float32)}
        if traced:
            with _cpu_profile():
                params, opt, m = step(params, opt,
                                      steps.to_device(batch, "cpu"))
            spans.append([(n, a.get("bytes"))
                          for n, _, a in _program_spans()])
        else:
            params, opt, m = step(params, opt, steps.to_device(batch, "cpu"))
        losses.append(m["loss"])
    return losses, M.param_dict(params), spans


@pytest.mark.parametrize("accum", [1, 2])
def test_traced_train_step_is_the_untraced_one_bit_for_bit(accum):
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    tc = TrainConfig(learning_rate=1e-2, optimizer="sgdm", momentum=0.9,
                     remat=True, accum_steps=accum)
    plain_loss, plain, _ = _train_run(cfg, tc, traced=False)
    loss, traced, spans = _train_run(cfg, tc, traced=True)
    assert all(torch.equal(a, b) for a, b in zip(plain_loss, loss))
    assert plain.keys() == traced.keys()
    assert all(torch.equal(plain[k], traced[k]) for k in plain)
    # each step's session: the batch's copy (tokens and labels int32,
    # weights float32), a forward, a backward and an optimizer a micro-batch
    # with accumulation, and the step's optimizer; inside the forward each
    # layer's attention, and inside the backward remat's recomputation of it
    attn = [("train.attention", None)] * cfg.num_layers
    want = [("train.to_device", 2 * 4 * 16 * 4 + 4 * 4)] + (
        attn + [("train.forward", None)] + attn + [
            ("train.backward", None), ("train.optimizer", None)]) * accum + (
            [("train.optimizer", None)] if accum > 1 else [])
    assert spans == [want, want]
