"""The CoCoA duality-gap history that the card's SCD kernel is held to.

`tests/data/cocoa_history_f28.json` is the JAX package's history, on the
CPU, of CoCoA/SCD on the uni-task engine at a reduced `cocoa` shape: F=28
(the width whose rows take the card's blocked SCD kernel), 32,000 unit
rows in 128 chunks of 250, K scaling in 16 -> 2 over 12 iterations on the
`cocoa` phase's schedule, so a worker's pass is 2,000 to 16,000
sequential steps (62 to 500 blocks of the blocked kernel's 32 rows).
lambda is 1e-2, not the phase's 1e-3: at this n it takes the gap from
6.3e-2 to the fp32 floor (2.4e-7) in 12 iterations, as the phase's
11,000,000 rows take it from 1.9e-2 to 1.2e-7, so the history has both a
relative and a floor regime.  `write_fixture()` writes it;
run it by hand after a change to the shape or to the JAX package:

    PYTHONPATH=src python tests/test_torch_cocoa_history.py

Here the JAX history is recomputed and held to the fixture (a stale
fixture fails), and so are the port's history on the CPU (the plain
sequential SCD) and the history of the blocked kernel's arithmetic
(`scd_pass_blocked_plain`).  `tests/test_torch_cuda.py` reads only the
fixture and holds the card's kernel-run history to it.

Tolerances: the K trajectory is exact.  The JAX rerun holds its own
fixture at rtol 1e-5 (another CPU may vectorise XLA's sums differently).
A port history holds it at |gap - want| <= GAP_RTOL |want| + GAP_ATOL:
relative while the gap is well above fp32 rounding; below that the gap
is the difference of the primal and the dual, two fp32 values of ~0.69,
so it is known only to a few of their ulps (6e-8 each): on the CPU the
port differs from the JAX package by at most 4 of them (2.4e-7), and
GAP_ATOL allows 16."""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest

FIXTURE = Path(__file__).resolve().parent / "data" / "cocoa_history_f28.json"
SHAPE = dict(n=32_000, features=28, chunk_size=250, lam=1e-2, k0=16,
             iters=12, seed=0)
GAP_RTOL, GAP_ATOL = 1e-3, 1e-6


def schedule(pkg, n: int, k0: int):
    """`chip_smoke.py`'s cocoa schedule: 2 workers fewer every 2 units of
    simulated time (one unit = one K=k0 pass), down to 2."""
    unit = n // k0
    return [pkg.ElasticScalingPolicy(
        [pkg.ScaleEvent(2 * i * unit, max(k0 - 2 * i, 2))
         for i in range(k0 // 2)])]


def history(pkg, make_svm_data, shape=SHAPE, **solver_kw):
    """[(K, gap)] per iteration of the scale-in run of `pkg` (the JAX
    package or the port; solver_kw e.g. device="cpu" for the port)."""
    c = shape
    x, y = make_svm_data(c["n"], c["features"], seed=c["seed"])
    store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=c["chunk_size"])
    a = pkg.Assignment(store.n_chunks, c["k0"], np.random.default_rng(0))
    solver = pkg.CoCoASolver(store, lam=c["lam"], **solver_kw)
    eng = pkg.UniTaskEngine(store, a, schedule(pkg, c["n"], c["k0"]),
                            balance_processing=False)
    hist = eng.run(c["iters"], lambda s, asg, sh: solver.step(s, asg, sh),
                   solver.metric)
    return [(h.n_workers, float(h.metric)) for h in hist]


def load_fixture():
    obj = json.loads(FIXTURE.read_text())
    return obj["shape"], [(k, g) for k, g in obj["history"]]


def gap_excess(got, want, rtol=GAP_RTOL, atol=GAP_ATOL):
    """max over iterations of |got - want| - (rtol |want| + atol): <= 0
    when every gap holds; the K trajectories must be equal."""
    assert [k for k, _ in got] == [k for k, _ in want]
    return max(abs(g - w) - (rtol * abs(w) + atol)
               for (_, g), (_, w) in zip(got, want))


def write_fixture() -> None:
    import repro.core as J
    from repro.data import make_svm_data
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps(
        {"source": "repro (JAX package) CoCoASolver on the CPU; written by "
                   "tests/test_torch_cocoa_history.py::write_fixture",
         "shape": SHAPE, "history": history(J, make_svm_data)}, indent=1)
        + "\n")


def test_fixture_is_the_jax_history():
    import repro.core as J
    from repro.data import make_svm_data
    shape, want = load_fixture()
    assert shape == SHAPE
    got = history(J, make_svm_data)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([g for _, g in got], [g for _, g in want],
                               rtol=1e-5)
    ks = [k for k, _ in want]
    assert ks[0] == 16 and ks[-1] == 2 and want[-1][1] < want[0][1]


@pytest.mark.parametrize("arithmetic", ["sequential", "blocked"])
def test_port_history_on_the_cpu_holds_the_fixture(arithmetic, monkeypatch):
    """The port's solver on the CPU, through the plain sequential SCD (what
    the wrapper runs for CPU tensors) and through the blocked kernel's
    arithmetic (what the card runs at F=28), holds the fixture."""
    import repro_torch.core as T
    from repro_torch.data import make_svm_data
    from repro_torch.kernels import scd
    if arithmetic == "blocked":
        monkeypatch.setattr(scd, "scd_pass", scd.scd_pass_blocked_plain)
    _, want = load_fixture()
    got = history(T, make_svm_data, device="cpu")
    assert gap_excess(got, want) <= 0


# the traced path: `CoCoASolver` and `UniTaskEngine` record into the
# program tracer while a profiler records, and change nothing they compute
TRACED = dict(n=4_000, features=28, chunk_size=250, lam=1e-2, iters=8)
LEAVES_COVER = 0.9  # of each iteration's span, by its leaf spans


def _traced_history(ks, traced):
    """Every iteration's K, gap, alpha, w and samples_processed, each
    iteration under a CPU profiler or not; and each traced iteration's
    program spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as T
    from repro_torch.data import make_svm_data
    from repro_torch.obs import PROGRAM_TRACER
    c = TRACED
    x, y = make_svm_data(c["n"], c["features"], seed=3)
    store = T.ChunkStore({"x": x, "y": y}, chunk_size=c["chunk_size"])
    a = T.Assignment(store.n_chunks, ks[0], np.random.default_rng(0))
    solver = T.CoCoASolver(store, lam=c["lam"], seed=5, device="cpu")
    # K follows `ks` by iteration, as the benchmark's worker schedules do
    # (chunks and their alpha move at each change)
    eng = T.UniTaskEngine(
        store, a, [T.ElasticScalingPolicy(
            lambda t: ks[eng.iteration % len(ks)])],
        seed=5, balance_processing=False)
    out, sessions = [], []
    for _ in range(c["iters"]):
        if traced:  # a session an iteration; reading it, while off, ends it
            with profile(activities=[ProfilerActivity.CPU]):
                eng.run(1, solver.step, solver.metric)
            sessions.append(list(PROGRAM_TRACER.events))
        else:
            eng.run(1, solver.step, solver.metric)
        h = eng.history[-1]
        out.append((h.n_workers, h.metric, store.state["alpha"].copy(),
                    solver.w.clone(), eng.samples_processed))
    return out, sessions, torch


@pytest.mark.parametrize("ks", [[4, 4, 2, 2, 4], [8, 2, 8, 4]])
def test_traced_cocoa_is_the_untraced_one_bit_for_bit(ks, monkeypatch):
    from repro_torch.obs import PROGRAM_TRACER
    # spans timed by this thread's CPU clock: on a busy machine, a
    # preemption between two spans does not read as uncovered time
    monkeypatch.setattr(PROGRAM_TRACER, "_clock", time.thread_time)
    plain, _, torch = _traced_history(ks, traced=False)
    traced, sessions, _ = _traced_history(ks, traced=True)
    for (k0, g0, a0, w0, s0), (k1, g1, a1, w1, s1) in zip(plain, traced):
        assert (k0, g0, s0) == (k1, g1, s1)
        assert np.array_equal(a0, a1) and torch.equal(w0, w1)
    assert [k for k, *_ in plain] == [ks[i % len(ks)]
                                      for i in range(TRACED["iters"])]
    # each iteration's session: its phases, the leaves covering it
    for t, evs in enumerate(sessions):
        kids = {}
        for i, e in enumerate(evs):
            if e.name != "python.gc":
                kids.setdefault(e.parent, []).append(i)
        (it,) = [i for i, e in enumerate(evs)
                 if e.name == "engine.iteration"]
        assert evs[it].args == {"it": t}
        (scd,) = [e for e in evs if e.name == "cocoa.scd_pass"]
        assert scd.args["K"] == plain[t][0]

        def leaves(i):
            return [j for k in kids.get(i, []) for j in (leaves(k) or [k])]
        phases = leaves(it)
        assert [evs[j].name for j in phases] == [
            "engine.schedule", "cocoa.pools", "cocoa.to_device",
            "cocoa.gather", "cocoa.scd_pass", "cocoa.merge",
            "cocoa.da_to_host", "cocoa.alpha_scatter", "cocoa.to_device",
            "cocoa.gap_to_host"]
        # the collector's passes are leaves too, where no phase holds them
        gcs = [e.dur for e in evs if e.name == "python.gc"
               and e.parent is not None and e.parent not in phases]
        assert sum(evs[j].dur for j in phases) + sum(gcs) >= \
            LEAVES_COVER * evs[it].dur

if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}")
