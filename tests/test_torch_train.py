"""The port's training slice on the CPU against the JAX package: the
uni-task engine with CoCoA/SCD across scale events and rebalancing, the
micro-task emulator, and local SGD (MLP and a smoke-size CNN) with the
weighted merge.  Same data, same seeds, same starting state:

- engine histories: equal n_workers, chunk_counts, sim_time, epoch and
  task_times; duality gap at rtol 1e-4; w and alpha at atol 1e-5;
- local SGD: losses at rtol 1e-4, params at atol 1e-5, equal
  per_worker_samples;
- CNN/MLP logits from `params_from_numpy` at 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs.chicle_paper import PAPER_LSGD, CNNConfig
from repro.core import nets as JN
from repro.data import make_classification, make_images, make_svm_data
from repro_torch.configs.chicle_paper import PAPER_LSGD as T_PAPER_LSGD
from repro_torch.configs.chicle_paper import CNNConfig as TCNNConfig
from repro_torch.core import metrics as TMET
from repro_torch.core import nets as TN
from repro_torch.data import make_classification as t_make_classification
from repro_torch.data import make_images as t_make_images
from repro_torch.data import make_svm_data as t_make_svm_data
from repro_torch.kernels.chunk_reduce import weighted_merge
from repro_torch.kernels.scd import scd_pass

SMOKE_CNN = CNNConfig(image_size=8)


def _jax_loss(logits, yb, reduce=True):
    lse = jax.nn.logsumexp(logits, axis=-1)
    per = lse - jnp.take_along_axis(logits, yb[:, None], axis=-1)[:, 0]
    return per.mean() if reduce else per


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# data and nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,tmake,args,kw", [
    (make_svm_data, t_make_svm_data, (300, 16), dict(seed=3)),
    (make_images, t_make_images, (20, 8, 3, 10), dict(seed=1, noise=1.5)),
    (make_classification, t_make_classification, (50, 16, 4), dict(seed=0)),
])
def test_synthetic_data_is_the_jax_packages(make, tmake, args, kw):
    for a, b in zip(make(*args, **kw), tmake(*args, **kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cnn_logits_match_jax():
    params = JN.cnn_init(SMOKE_CNN, jax.random.key(0))
    x, _ = make_images(16, 8, 3, 10, seed=2, noise=1.5)
    want = np.asarray(JN.cnn_apply(params, jnp.asarray(x)))
    got = TN.cnn_apply(TN.params_from_numpy(_numpy_tree(params), device="cpu"),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mlp_logits_match_jax():
    params = JN.mlp_init(jax.random.key(1), 16, 4, hidden=(32, 16))
    x, _ = make_classification(32, 16, 4, seed=5)
    want = np.asarray(JN.mlp_apply(params, jnp.asarray(x)))
    got = TN.mlp_apply(TN.params_from_numpy(_numpy_tree(params), device="cpu"),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["softmax_loss", "accuracy"])
@pytest.mark.parametrize("n,classes", [(1, 2), (37, 10)])
def test_nets_loss_and_accuracy_match_jax(fn, n, classes):
    """`nets.softmax_loss` (mean logsumexp less the labelled logit) and
    `nets.accuracy` (float32 mean of argmax == label) against the JAX
    package's, on logits with ties broken alike (distinct values)."""
    rng = np.random.default_rng(n)
    logits = (rng.standard_normal((n, classes)) * 3).astype(np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    labels[: n // 2] = logits[: n // 2].argmax(-1)  # some right answers
    want = np.asarray(getattr(JN, fn)(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    got = getattr(TN, fn)(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_port_init_has_the_jax_layouts_and_sizes():
    """The port's own initializers (explicit torch.Generator) give the
    paper CNN's 276,266 parameters at 32x32, and `params_from_numpy` maps
    the JAX tree onto exactly those shapes."""
    cfg = TCNNConfig(image_size=32)
    gen = torch.Generator().manual_seed(0)
    mine = TN.cnn_init(cfg, gen)
    assert sum(v.numel() for v in mine.values()) == 276_266
    ref = TN.params_from_numpy(_numpy_tree(JN.cnn_init(
        CNNConfig(image_size=32), jax.random.key(0))), device="cpu")
    assert {k: v.shape for k, v in mine.items()} \
        == {k: v.shape for k, v in ref.items()}
    mlp = TN.mlp_init(torch.Generator().manual_seed(0), 16, 4, hidden=(8,))
    assert {k: tuple(v.shape) for k, v in mlp.items()} == {
        "w0": (16, 8), "b0": (8,), "w1": (8, 4), "b1": (4,)}


# ---------------------------------------------------------------------------
# CoCoA on the uni-task engine
# ---------------------------------------------------------------------------


SVM = make_svm_data(2000, 16, seed=3)


def _cocoa(pkg, policies, *, node_pst=lambda w: 1.0, balance=False,
           iters=8, **solver_kw):
    x, y = SVM
    store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=50)
    a = pkg.Assignment(store.n_chunks, 8, np.random.default_rng(0))
    solver = pkg.CoCoASolver(store, lam=1e-3, **solver_kw)
    eng = pkg.UniTaskEngine(store, a, policies(pkg), node_pst=node_pst,
                            balance_processing=balance)
    hist = eng.run(iters, lambda s, asg, sh: solver.step(s, asg, sh),
                   solver.metric)
    return hist, solver, store


def _same_history(hj, ht, *, gap_rtol=1e-4):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        assert (a.iteration, a.n_workers, a.chunk_counts, a.sim_time,
                a.epoch, a.task_times, a.events) == \
            (b.iteration, b.n_workers, b.chunk_counts, b.sim_time,
             b.epoch, b.task_times, b.events)
        if a.metric is None:
            assert b.metric is None
        else:
            np.testing.assert_allclose(b.metric, a.metric, rtol=gap_rtol)


def _elastic(pkg):
    # scale-in 8 -> 2, one step per 250 sample-units of simulated time
    return [pkg.ElasticScalingPolicy(
        [pkg.ScaleEvent(i * 250.0, max(8 - 2 * i, 2)) for i in range(4)])]


def _rebalance(pkg):
    return [pkg.RebalancePolicy(window=2, max_moves_per_gap=6)]


PSTS = [2.0] * 2 + [1.0] * 6  # 2 of 8 workers at twice the per-sample time


@pytest.mark.parametrize("scenario", ["elastic", "rebalance",
                                      "rebalance_balanced"])
def test_cocoa_engine_matches_jax(scenario):
    kw = {"elastic": dict(policies=_elastic),
          "rebalance": dict(policies=_rebalance,
                            node_pst=lambda w: PSTS[w % 8]),
          "rebalance_balanced": dict(policies=_rebalance,
                                     node_pst=lambda w: PSTS[w % 8],
                                     balance=True)}[scenario]
    hj, sj, stj = _cocoa(J, **kw)
    launches = scd_pass.launches
    ht, st, stt = _cocoa(T, device="cpu", **kw)
    assert scd_pass.launches == launches  # CPU tensors: plain version
    _same_history(hj, ht)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.w), atol=1e-5)
    np.testing.assert_allclose(stt.state["alpha"], stj.state["alpha"],
                               atol=1e-5)
    assert ht[-1].metric < ht[0].metric  # the gap falls
    if scenario == "elastic":
        assert [r.n_workers for r in ht][-1] == 2
        assert stt.state["alpha"].max() > 0  # alpha rode along, not reset
    else:
        assert sum(ht[-1].chunk_counts[:2]) < sum(ht[0].chunk_counts[:2])
        assert max(ht[-1].task_times.values()) \
            < max(ht[0].task_times.values())


def test_cocoa_starts_from_given_state():
    """A starting w and alpha handed over as numpy give the JAX solver's
    next iterations (both packages start from the same state)."""
    rng = np.random.default_rng(0)
    x, y = SVM
    w0 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    a0 = rng.uniform(size=len(y)).astype(np.float32)
    out = {}
    for name, pkg in (("jax", J), ("torch", T)):
        store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=50)
        store.state["alpha"] = a0.copy()
        a = pkg.Assignment(store.n_chunks, 4, np.random.default_rng(0))
        if name == "jax":
            solver = J.CoCoASolver(store, lam=1e-3)
            solver.w = jnp.asarray(w0)
        else:
            solver = T.CoCoASolver(store, lam=1e-3, w0=w0, device="cpu")
        gaps = [solver.metric()]
        for _ in range(3):
            solver.step(store, a)
            gaps.append(solver.metric())
        out[name] = (np.asarray(solver.w), store.state["alpha"], gaps)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], atol=1e-5)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-5)
    np.testing.assert_allclose(out["torch"][2], out["jax"][2], rtol=1e-4)


def test_microtask_emulator_matches_jax():
    x, y = SVM
    hists = {}
    for name, pkg in (("jax", J), ("torch", T)):
        store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=50)
        kw = {} if name == "jax" else {"device": "cpu"}
        solver = pkg.CoCoASolver(store, lam=1e-3, **kw)
        emu = pkg.MicroTaskEmulator(
            store, 8, nodes_at=lambda t: 6 if t < 500 else 3,
            node_pst_pool=lambda i: 1.5 if i % 2 else 1.0)
        hists[name] = emu.run(5, lambda s, asg, sh: solver.step(s, asg, sh),
                              solver.metric, eval_every=2)
    _same_history(hists["jax"], hists["torch"])
    for fn in ("epochs_to_target", "time_to_target"):
        target = hists["jax"][3].metric
        assert getattr(T, fn)(hists["torch"], target * 1.0001,
                              higher_is_better=False) == getattr(J, fn)(
            hists["jax"], target * 1.0001, higher_is_better=False)


def test_engine_helpers_match_jax():
    for n, unit, psts in [(64, 0.25, [1.0] * 8 + [1.5] * 8),
                          (7, 1.0, [1.0, 2.0, 3.0]), (0, 1.0, [1.0])]:
        assert T.microtask_schedule_len(n, unit, psts) \
            == J.microtask_schedule_len(n, unit, psts)
    tracker = TMET.ConvergenceTracker(higher_is_better=True)
    for i, m in enumerate([None, 0.2, 0.5, 0.4, 0.8]):
        tracker.update(step=i, epoch=i / 2, sim_time=3.0 * i, metric=m)
    assert tracker.first_reaching(0.45) == 1.0
    assert tracker.first_reaching(0.45, key="sim_time") == 6.0
    assert tracker.best() == 0.8 and tracker.first_reaching(0.9) is None


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------


def _lsgd(kind):
    if kind == "mlp":
        x, y = make_classification(512, 16, 4, seed=0)
        xe, ye = make_classification(128, 16, 4, seed=1)
        p0 = JN.mlp_init(jax.random.key(0), 16, 4)
        apply = (JN.mlp_apply, TN.mlp_apply)
    else:
        x, y = make_images(512, 8, 3, 10, seed=0, noise=1.5)
        xe, ye = make_images(128, 8, 3, 10, seed=1, noise=1.5)
        p0 = JN.cnn_init(SMOKE_CNN, jax.random.key(0))
        apply = (JN.cnn_apply, TN.cnn_apply)
    tc = dataclasses.replace(PAPER_LSGD, local_steps=4, learning_rate=0.01)
    ttc = dataclasses.replace(T_PAPER_LSGD, local_steps=4,
                              learning_rate=0.01)
    out = {}
    for name, pkg in (("jax", J), ("torch", T)):
        store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=32)
        a = pkg.Assignment(store.n_chunks, 4, np.random.default_rng(0))
        pol = pkg.ElasticScalingPolicy([pkg.ScaleEvent(0, 4),
                                        pkg.ScaleEvent(60, 2)])
        eng = pkg.UniTaskEngine(store, a, [pol])
        if name == "jax":
            s = J.LocalSGDSolver(p0, apply[0], _jax_loss, tc,
                                 eval_data=jnp.asarray(xe),
                                 eval_labels=jnp.asarray(ye), seed=7)
            d, lab = jnp.asarray(x), jnp.asarray(y)
        else:
            s = T.LocalSGDSolver(TN.params_from_numpy(_numpy_tree(p0),
                                                       device="cpu"),
                                 apply[1], TN.loss_per_sample, ttc,
                                 eval_data=xe, eval_labels=ye, seed=7,
                                 device="cpu")
            d, lab = torch.from_numpy(x), torch.from_numpy(y)
        outs = []

        def step(st, asg, sh, s=s, d=d, lab=lab, outs=outs):
            outs.append(s.step(st, asg, d, lab, sh))
            return outs[-1]

        hist = eng.run(5, step, s.metric)
        out[name] = (hist, outs, s)
    return out


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_local_sgd_matches_jax(kind):
    launches = weighted_merge.launches
    out = _lsgd(kind)
    assert weighted_merge.launches == launches  # CPU: plain version
    (hj, oj, sj), (ht, ot, st) = out["jax"], out["torch"]
    _same_history(hj, ht, gap_rtol=1e-6)  # accuracy: equal predictions
    assert [r.n_workers for r in ht] == [4, 4, 2, 2, 2]
    np.testing.assert_allclose([o["loss"] for o in ot],
                               [o["loss"] for o in oj], rtol=1e-4)
    for a, b in zip(oj, ot):
        assert np.array_equal(a["per_worker_samples"],
                              b["per_worker_samples"])
        assert a["samples_processed"] == b["samples_processed"]
    want = TN.params_from_numpy(_numpy_tree(sj.params), device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(st.params[k].numpy(), v.numpy(),
                                   atol=1e-5)
    assert all(np.isfinite(o["loss"]) for o in ot)
