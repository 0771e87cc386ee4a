"""The port's LM training slice on the CPU against the JAX package: the
train step (sgdm, adamw, gradient accumulation), local SGD, the training
loop with elastic events, rebalancing and slow workers, the elastic
trainer, checkpoints, optimizers, schedules and the chunk batch pipeline.
The JAX parameter tree is carried across by `params_from_numpy`; tokens,
labels and weights are made with numpy from a seed.

Tolerances: losses and grad norms at rtol 1e-5 for one step (1e-4 over a
10-step loop, where the differences compound), parameters at atol 1e-5.
AdamW's first update is lr * g / (|g| + eps): where |g| is near eps a
gradient difference of one rounding moves it by up to lr, so its
parameters are held at 1e-5 where |g| > 1e-4 and its moments everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.compat import set_mesh
from repro.configs import TrainConfig, get_config, smoke_variant
from repro.core import Assignment, ChunkStore
from repro.data import ChunkBatchPipeline, make_lm_tokens
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import (adamw, apply_updates, init_opt_state, sgdm,
                         warmup_cosine)
from repro.sharding import AxisRules
from repro_torch import optim as TO
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import Assignment as TAssignment
from repro_torch.core import ChunkStore as TChunkStore
from repro_torch.data import ChunkBatchPipeline as TChunkBatchPipeline
from repro_torch.data import make_lm_tokens as t_make_lm_tokens
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.launch.elastic import ElasticTrainer
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCH = "h2o-danube-1.8b"  # smoke: 2 layers, grouped heads, window 16


def _flat(tree):
    """A JAX tree by the '/'-joined path (the port's `param_dict` keys)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def model():
    cfg = smoke_variant(get_config(ARCH))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(ARCH))
    return cfg, params, tcfg


def _port_params(tcfg, params):
    return TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "weights": rng.uniform(0.5, 1.5, B).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = np.asarray(JL.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    # bf16 logits: CE still in fp32
    want = np.asarray(JL.cross_entropy(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels)))
    got = TL.cross_entropy(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("optimizer,accum", [("sgdm", 1), ("adamw", 1),
                                             ("sgdm", 2)])
def test_train_step_matches_jax(model, optimizer, accum):
    cfg, params, tcfg = model
    b = _batch(cfg, 4, 32)
    tc = TrainConfig(learning_rate=1e-2, optimizer=optimizer,
                     accum_steps=accum, remat=True)
    mesh = make_host_mesh()
    with set_mesh(mesh):
        jp, jo, jm = jax.jit(JS.make_train_step(cfg, AxisRules(mesh), tc))(
            params, init_opt_state(params, optimizer=optimizer), _jb(b))
    tp = _port_params(tcfg, params)
    ttc = TTrainConfig(learning_rate=1e-2, optimizer=optimizer,
                       accum_steps=accum, remat=True)
    t_opt = TO.init_opt_state(TM.param_dict(tp), optimizer=optimizer)
    tp2, to2, tm = TS.make_train_step(tcfg, ttc)(tp, t_opt, _tb(b))
    assert tp2 is tp  # updated in place
    for k in ("loss", "aux_loss", "grad_norm"):
        assert tm[k].dtype == torch.float32
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert int(to2.step) == int(jo.step) == 1
    want, got = _flat(jp), TM.param_dict(tp2)
    assert set(want) == set(got)
    mu = _flat(jo.mu)
    for k, w in want.items():
        np.testing.assert_allclose(_np(to2.mu[k]), mu[k], atol=1e-5,
                                   err_msg=k)
        if optimizer == "adamw":
            np.testing.assert_allclose(_np(to2.nu[k]), _flat(jo.nu)[k],
                                       rtol=1e-4, atol=1e-9, err_msg=k)
            ok = np.abs(mu[k]) > 1e-4 * (1 - 0.9)  # mu = (1 - b1) g
            np.testing.assert_allclose(_np(got[k])[ok], w[ok], atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), w, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("H", [1, 4])
def test_lsgd_step_matches_jax(model, H):
    cfg, params, tcfg = model
    b = _batch(cfg, 2 * H, 32, seed=H)
    tc = TrainConfig(learning_rate=1e-2, local_steps=H, remat=False)
    mesh = make_host_mesh()
    mom0 = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, jnp.float32),
                        params)
    with set_mesh(mesh):
        jp, jmom, jm = jax.jit(JS.make_lsgd_train_step(
            cfg, AxisRules(mesh), tc))(params, mom0, _jb(b))
    tp = _port_params(tcfg, params)
    tmom = {k: torch.from_numpy(v.copy()) for k, v in _flat(mom0).items()}
    ttc = TTrainConfig(learning_rate=1e-2, local_steps=H, remat=False)
    tp2, tmom2, tm = TS.make_lsgd_train_step(tcfg, ttc)(tp, tmom, _tb(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want, wmom, got = _flat(jp), _flat(jmom), TM.param_dict(tp2)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(_np(tmom2[k]), wmom[k], atol=1e-5,
                                   err_msg=k)


def test_train_loop_matches_jax(model, monkeypatch):
    """`train(smoke, elastic, rebalance, hetero)`: the same workers, sim
    time and scale events at every step, losses at rtol 1e-4."""
    cfg, params, tcfg = model
    kw = dict(smoke=True, train_steps=10, global_batch=8, seq_len=32,
              workers=4, elastic="3:2,7:3", rebalance=True, hetero="2.0x2",
              log_every=100, lr=3e-3, seed=0)
    want = JT.train(ARCH, **kw)["history"]
    monkeypatch.setattr(TM, "init_params",
                        lambda c, gen, device: _port_params(c, params))
    got = TT.train(ARCH, device="cpu", **kw)["history"]
    assert [h["workers"] for h in got] == [h["workers"] for h in want]
    assert [h["workers"] for h in got] == [4] * 3 + [2] * 4 + [3] * 3
    assert [h["sim_time"] for h in got] == [h["sim_time"] for h in want]
    assert [h["events"] for h in got] == [h["events"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4)


def _trainer_batch(data, i):
    sl = slice(4 * i, 4 * (i + 1))
    return {"tokens": data["tokens"][sl], "labels": data["labels"][sl],
            "weights": np.ones((4,), np.float32)}


def test_elastic_trainer_state_survives_resize():
    cfg = t_smoke_variant(t_get_config("smollm-360m"))
    tc = TTrainConfig(learning_rate=5e-3, remat=False)
    trainer = ElasticTrainer(cfg, tc, device="cpu")
    assert trainer.k == 1
    data = t_make_lm_tokens(64, 32, cfg.vocab_size, seed=0)
    m0 = trainer.train_step(_trainer_batch(data, 0))
    before = trainer.params.embed.detach().clone()
    trainer.resize(4)  # clamps to the devices present
    assert trainer.k == 1
    m1 = trainer.train_step(_trainer_batch(data, 0))
    assert np.isfinite(m0["loss"]) and np.isfinite(m1["loss"])
    assert set(m1) == {"loss", "aux_loss", "grad_norm"}
    assert float((trainer.params.embed.detach() - before).abs().max()) > 0


@pytest.fixture
def deterministic():
    """Two runs are bit-equal only with deterministic kernels: the
    embedding's backward accumulates rows in thread order otherwise."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_elastic_trainer_suspend_resume_bit_identical(deterministic):
    """Scale-to-zero on the training path: park params and optimizer state
    on the host mid-run, resume, and land bit-identical to an uninterrupted
    run fed the same batches."""
    cfg = t_smoke_variant(t_get_config("smollm-360m"))
    tc = TTrainConfig(learning_rate=5e-3, remat=False)
    data = t_make_lm_tokens(64, 32, cfg.vocab_size, seed=0)
    ref = ElasticTrainer(cfg, tc, device="cpu")
    for i in range(4):
        ref.train_step(_trainer_batch(data, i))

    bumpy = ElasticTrainer(cfg, tc, device="cpu")
    bumpy.train_step(_trainer_batch(data, 0))
    bumpy.train_step(_trainer_batch(data, 1))
    saved = {k: v.detach().clone()
             for k, v in TM.param_dict(bumpy.params).items()}
    bumpy.suspend()
    assert bumpy.suspended and bumpy.k == 0
    with pytest.raises(RuntimeError):
        bumpy.train_step(_trainer_batch(data, 2))
    assert bumpy.params.embed.device.type == "cpu"
    bumpy.resume(1)
    assert not bumpy.suspended and bumpy.k == 1
    for k, v in TM.param_dict(bumpy.params).items():
        assert torch.equal(v, saved[k])
    bumpy.train_step(_trainer_batch(data, 2))
    bumpy.train_step(_trainer_batch(data, 3))
    want = TM.param_dict(ref.params)
    for k, v in TM.param_dict(bumpy.params).items():
        assert torch.equal(v, want[k]), k
    for k, v in bumpy.opt_state.mu.items():
        assert torch.equal(v, ref.opt_state.mu[k]), k
    assert int(bumpy.opt_state.step) == int(ref.opt_state.step) == 4


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_jax_checkpoint_loads_into_the_port(model, tmp_path, optimizer):
    cfg, params, tcfg = model
    opt = init_opt_state(params, optimizer=optimizer)
    opt = opt._replace(step=jnp.int32(5), mu=jax.tree.map(
        lambda p: jnp.full(p.shape, 0.25, jnp.float32), params))
    a = Assignment(8, 2, np.random.default_rng(0))
    alpha = np.random.default_rng(1).random(10).astype(np.float32)
    j_save(str(tmp_path), 7, params, opt, assignment=a,
           chunk_state={"alpha": alpha})
    assert latest_step(str(tmp_path)) == 7
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    t_opt = TO.init_opt_state(TM.param_dict(tp), optimizer=optimizer)
    p2, o2, meta = load_checkpoint(str(tmp_path), 7, tp, t_opt)
    want = _flat(params)
    got = TM.param_dict(p2)
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(_np(v), want[k]), k
    assert o2.step.dtype == torch.int32 and int(o2.step) == 5
    assert all(bool((m == 0.25).all()) for m in o2.mu.values())
    assert (o2.nu is None) == (optimizer == "sgdm")
    assert np.array_equal(meta["chunk_state"]["alpha"], alpha)
    assert meta["assignment"] == [list(map(int, w)) for w in a.workers]


def test_port_checkpoint_round_trips_and_loads_into_jax(model, tmp_path):
    cfg, params, tcfg = model
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    t_opt = TO.init_opt_state(TM.param_dict(tp), optimizer="adamw")
    t_opt = t_opt._replace(step=t_opt.step + 3)
    bf = {"w": torch.randn(4, 5).bfloat16()}
    save_checkpoint(str(tmp_path), 2, tp, t_opt,
                    chunk_state={"alpha": np.arange(4.0)})
    save_checkpoint(str(tmp_path / "bf16"), 1, bf)
    p2, o2, meta = load_checkpoint(str(tmp_path), 2, tp, t_opt)
    for k, v in TM.param_dict(p2).items():
        assert torch.equal(v, TM.param_dict(tp)[k]), k
    assert int(o2.step) == 3 and set(o2.nu) == set(t_opt.nu)
    assert np.array_equal(meta["chunk_state"]["alpha"], np.arange(4.0))
    b2, _, _ = load_checkpoint(str(tmp_path / "bf16"), 1, bf)
    assert b2["w"].dtype == torch.bfloat16 and torch.equal(b2["w"], bf["w"])
    # the JAX package reads the port's checkpoint leaf for leaf
    jp, jo, _ = j_load(str(tmp_path), 2, params,
                       init_opt_state(params, optimizer="adamw"))
    for k, v in _flat(jp).items():
        assert np.array_equal(v, _np(TM.param_dict(tp)[k])), k
    assert int(jo.step) == 3


def test_sgdm_momentum_math():
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    st = TO.init_opt_state(p)
    assert st.step.dtype == torch.int32 and st.nu is None
    u1, st = TO.sgdm(g, st, lr=0.1, momentum=0.9)
    np.testing.assert_allclose(u1["w"].numpy(), [-0.05, 0.05])
    u2, st = TO.sgdm(g, st, lr=0.1, momentum=0.9)
    # mu = 0.9*0.5 + 0.5 = 0.95
    np.testing.assert_allclose(u2["w"].numpy(), [-0.095, 0.095], rtol=1e-6)
    assert int(st.step) == 2


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_optimizers_match_jax(optimizer):
    """Five steps on the same nested tree and gradients, with weight decay
    and a bf16 leaf (fp32 moments, updates applied in fp32)."""
    rng = np.random.default_rng(4)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jp = {"a": jnp.asarray(p["a"]),
          "b": {"c": jnp.asarray(p["b"]["c"]).astype(jnp.bfloat16)}}
    tp = {"a": torch.from_numpy(p["a"]),
          "b": {"c": torch.from_numpy(p["b"]["c"]).bfloat16()}}
    js, ts = (init_opt_state(jp, optimizer=optimizer),
              TO.init_opt_state(tp, optimizer=optimizer))
    jfn, tfn = (adamw, TO.adamw) if optimizer == "adamw" else (sgdm, TO.sgdm)
    for _ in range(5):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
        ju, js = jfn(jax.tree.map(jnp.asarray, g), js, lr=0.05,
                     weight_decay=0.1, params=jp)
        tu, ts = tfn(TO.tree_map(torch.from_numpy, g), ts, lr=0.05,
                     weight_decay=0.1, params=tp)
        jp, tp = apply_updates(jp, ju), TO.apply_updates(tp, tu)
    assert tp["b"]["c"].dtype == torch.bfloat16
    for k, w in _flat(jp).items():
        got = tp["a"] if k == "a" else tp["b"]["c"]
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ts.mu["a"].numpy(), np.asarray(js.mu["a"]),
                               rtol=1e-5, atol=1e-7)
    assert int(ts.step) == int(js.step) == 5


def test_adamw_converges_quadratic():
    p = {"w": torch.tensor([5.0])}
    st = TO.init_opt_state(p, optimizer="adamw")
    for _ in range(300):
        u, st = TO.adamw({"w": 2 * p["w"]}, st, lr=0.1)
        p = TO.apply_updates(p, u)
    assert abs(float(p["w"][0])) < 0.1


def test_schedules_match_jax():
    fn, tfn = warmup_cosine(1.0, 10, 110), TO.warmup_cosine(1.0, 10, 110)
    assert float(tfn(0)) == 0.0
    assert abs(float(tfn(10)) - 1.0) < 1e-6
    assert float(tfn(109)) < 0.2
    for s in (0, 3, 10, 50, 109, 200):
        np.testing.assert_allclose(float(tfn(s)), float(fn(s)), rtol=1e-6)
    assert float(TO.constant_lr(0.3)(7)) == pytest.approx(0.3)
    assert TO.elastic_sqrt_k(0.1, 4) == pytest.approx(0.2)


def test_lm_tokens_and_pipeline_are_the_jax_packages():
    want = make_lm_tokens(64, 16, 97, seed=3)
    got = t_make_lm_tokens(64, 16, 97, seed=3)
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert np.array_equal(want[k], got[k])
    batches = []
    for store_cls, a_cls, pipe_cls in (
            (ChunkStore, Assignment, ChunkBatchPipeline),
            (TChunkStore, TAssignment, TChunkBatchPipeline)):
        store = store_cls(dict(want), chunk_size=4)
        a = a_cls(store.n_chunks, 4, np.random.default_rng(0))
        a.move_n(3, 1, 0, np.random.default_rng(1))  # worker 0 holds more
        pipe = pipe_cls(store, a, global_batch=24, seed=5)
        batches.append([pipe.next_batch() for _ in range(3)])
    for bj, bt in zip(*batches):
        assert set(bj) == set(bt) == {"tokens", "labels", "weights"}
        for k in bj:
            assert np.array_equal(bj[k], bt[k]), k
        assert bt["tokens"].shape == (24, 16)
        assert abs(float(bt["weights"].sum()) - 24.0) < 1e-3
