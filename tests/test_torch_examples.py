"""The port's CoCoA examples (examples/cocoa_svm_torch.py and
examples/load_balancing_torch.py) on the CPU against the JAX package's
solver and engine built as examples/cocoa_svm.py and
examples/load_balancing.py build them, at a reduced n: equal n_workers,
chunk_counts, task_times, sim_time and epoch per iteration, the duality gap
at rtol 1e-4 (tests/test_torch_train.py's tolerance), equal printed
schedule lines, and the example's own checks passing."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
from repro.data import make_svm_data

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cocoa_svm(n, iters):
    """examples/cocoa_svm.py's body at `n` samples."""
    x, y = make_svm_data(n, 128, seed=3)
    store = J.ChunkStore({"x": x, "y": y}, chunk_size=200)
    assignment = J.Assignment(store.n_chunks, 16, np.random.default_rng(0))
    policy = J.ElasticScalingPolicy(
        [J.ScaleEvent(i * 2.0, max(16 - 2 * i, 2)) for i in range(8)])
    solver = J.CoCoASolver(store, lam=1e-3)
    engine = J.UniTaskEngine(store, assignment, [policy])
    return engine.run(iters, lambda s, a, sh: solver.step(s, a, sh),
                      solver.metric)


def _jax_load_balancing(n, iters):
    """examples/load_balancing.py's body at `n` samples."""
    x, y = make_svm_data(n, 128, seed=1)
    store = J.ChunkStore({"x": x, "y": y}, chunk_size=100)
    assignment = J.Assignment(store.n_chunks, 16, np.random.default_rng(0))
    psts = [2.0] * 4 + [1.0] * 12
    policy = J.RebalancePolicy(window=2, max_moves_per_gap=24)
    solver = J.CoCoASolver(store, lam=1e-3)
    engine = J.UniTaskEngine(store, assignment, [policy],
                             node_pst=lambda w: psts[w % 16])
    return engine.run(iters, lambda s, a, sh: solver.step(s, a, sh),
                      solver.metric)


def _same_history(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        assert (a.iteration, a.n_workers, a.chunk_counts, a.task_times,
                a.sim_time, a.epoch) == (b.iteration, b.n_workers,
                                         b.chunk_counts, b.task_times,
                                         b.sim_time, b.epoch)
        np.testing.assert_allclose(b.metric, a.metric, rtol=1e-4)


@pytest.mark.parametrize("name,n,iters", [("cocoa_svm", 4000, 12),
                                          ("load_balancing", 6400, 12)])
def test_torch_example_matches_the_jax_example(name, n, iters, capsys):
    hj = {"cocoa_svm": _jax_cocoa_svm,
          "load_balancing": _jax_load_balancing}[name](n, iters)
    out = _example(f"{name}_torch").run("cpu", n=n, iters=iters)
    ht = out[0] if name == "cocoa_svm" else out
    _same_history(hj, ht)
    lines = capsys.readouterr().out.splitlines()
    if name == "cocoa_svm":
        assert [ln.split(" gap ")[0] for ln in lines[:-1]] == [
            f"iter {r.iteration:2d} epoch {r.epoch:5.2f} "
            f"workers {r.n_workers:2d}" for r in hj]
        assert lines[-1] == "CoCoA elastic SVM OK"
        assert out[1].state["alpha"].max() > 0
    else:
        want = [f"{r.iteration:4d} | {max(r.task_times.values()):13.1f} | "
                f"{sum(r.chunk_counts[:4]):16d} | "
                + " ".join(f"{r.task_times[w]:5.0f}" for w in range(16))
                for r in hj]
        assert lines[1:-1] == want
        assert lines[-1].startswith("load balancing OK")
