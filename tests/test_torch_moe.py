"""The port's moe family vs the JAX package on the same parameters, at the
smoke variants of grok-1-314b (4 experts, top-2) and arctic-480b (4
experts, top-2, plus the dense residual FFN at 2 d_model): `moe_ffn`'s
output and load-balance aux loss (at the config's capacity factor, and at
one small enough that the reference drops assignments), the full-sequence
forward, the loss with its aux term, the gradients of one train step, every
serving step (prefill, paged decode, chunk and verify through both paged
implementations, flat decode and verify) and the parameter tree's round
trip.  The JAX tree is carried across by `params_from_numpy`; inputs are
made with numpy from a seed.

Tolerance 1e-5 (fp32): the two frameworks sum matmuls in different orders,
and the combine's scatter-add sums at most K = 2 non-zero terms a token,
which is exact in either order.  The train step's parameters are held at
atol 1e-5, its loss, aux and grad norm at rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import TrainConfig, get_config, smoke_variant
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.optim import init_opt_state
from repro.sharding import AxisRules
from repro_torch import optim as TO
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

ARCHS = ["grok-1-314b", "arctic-480b"]
IMPLS = [("xla", "gather"), ("pallas", "kernel")]
TOL = dict(rtol=1e-5, atol=1e-5)
DROP_CF = 0.5  # a capacity factor at which the reference drops assignments


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    cfg = smoke_variant(get_config(request.param))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(request.param))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_variant_matches_the_reference(arch):
    cfg = smoke_variant(get_config(arch))
    tcfg = t_smoke_variant(t_get_config(arch))
    assert tcfg == type(tcfg)(**{f: getattr(cfg, f)
                                 for f in cfg.__dataclass_fields__})
    assert (tcfg.family, tcfg.num_experts, tcfg.experts_per_token) == (
        "moe", 4, 2)
    assert tcfg.moe_dense_residual == (arch == "arctic-480b")
    if tcfg.moe_dense_residual:
        assert tcfg.dense_residual_ff == 2 * tcfg.d_model


def _reference_drops(cfg, p, x):
    """Assignments the JAX moe_ffn drops: its own routing, counted per
    expert against its capacity."""
    T = x.shape[0] * x.shape[1]
    logits = jnp.einsum("td,de->te", x.reshape(T, -1), p["router"])
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32)),
                             cfg.experts_per_token)
    counts = np.bincount(np.asarray(top_e).reshape(-1),
                         minlength=cfg.num_experts)
    cap = max(int(cfg.moe_capacity_factor * cfg.experts_per_token
                  * T / cfg.num_experts), 4)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("cf", [None, DROP_CF], ids=["config_cf", "drops"])
def test_moe_ffn_matches_jax(pair, cf):
    cfg, params, tcfg, tparams = pair
    if cf is not None:  # both configs at the small capacity factor
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 24, cfg.d_model)).astype(np.float32)
    p = _layer0(params["blocks"]["moe"])
    want, want_aux = JMoE.moe_ffn(cfg, p, jnp.asarray(x), None)
    tp = tparams.layers()[0]["moe"]
    with torch.inference_mode():
        got, aux = TMoE.moe_ffn(tcfg, tp, torch.from_numpy(x))
        buf, _, _ = TMoE.route(tcfg, tp, torch.from_numpy(x).reshape(72, -1),
                               TMoE.capacity(tcfg, 72))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    drops = _reference_drops(cfg, p, jnp.asarray(x))
    assert 72 * tcfg.experts_per_token - int((buf >= 0).sum()) == drops
    if cf == DROP_CF:
        assert drops > 0  # the case really exercises drops
    else:
        assert drops == 0


def test_top_k_ties_take_the_lower_expert(pair):
    """Equal router scores: lax.top_k's order (lower index first)."""
    _, _, tcfg, tparams = pair
    p = dict(tparams.layers()[0]["moe"])
    p["router"] = torch.zeros_like(p["router"])  # every prob 1/E
    x = torch.randn(5, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    buf, wbuf, _ = TMoE.route(tcfg, p, x, 16)
    assert (buf[:tcfg.experts_per_token] >= 0).sum(1).tolist() == [5, 5]
    assert (buf[tcfg.experts_per_token:] < 0).all()
    np.testing.assert_allclose(wbuf[:2, :5].numpy(), 0.5)


def test_forward_and_loss_match_jax(pair):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                 np.int32),
             "weights": rng.uniform(0.5, 1.5, 2).astype(np.float32)}
    jl, jaux = JM.forward(cfg, params, jnp.asarray(toks), rules=None,
                          remat=False)
    jloss, jmet = JM.loss_fn(cfg, params,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             rules=None, remat=False)
    with torch.inference_mode():
        tl, taux = TM.forward(tcfg, tparams, torch.from_numpy(toks),
                              return_aux=True)
        tloss, tmet = TM.loss_fn(tcfg, tparams,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_jax(pair, remat):
    """One sgdm step: loss, aux, grad norm and every updated parameter
    (the experts' and the router's included)."""
    cfg, params, tcfg, _ = pair
    rng = np.random.default_rng(2)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
             np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
             np.int32),
         "weights": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    tc = TrainConfig(learning_rate=1e-1, optimizer="sgdm", remat=remat)
    mesh = make_host_mesh()
    with set_mesh(mesh):
        jp, _, jm = jax.jit(JS.make_train_step(cfg, AxisRules(mesh), tc))(
            params, init_opt_state(params, optimizer="sgdm"),
            {k: jnp.asarray(v) for k, v in b.items()})
    tp = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    ttc = TTrainConfig(learning_rate=1e-1, optimizer="sgdm", remat=remat)
    t_opt = TO.init_opt_state(TM.param_dict(tp), optimizer="sgdm")
    tp, _, tm = TS.make_train_step(tcfg, ttc)(
        tp, t_opt, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    want, got = _flat(jp), TM.param_dict(tp)
    assert set(want) == set(got)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, atol=1e-5,
                                   err_msg=k)
        moved += k.endswith("router") and not np.allclose(
            w, np.asarray(_flat(params)[k]), atol=0, rtol=0)
    assert moved  # the router learns (through the weights and the aux)


def test_params_from_numpy_round_trip(pair):
    cfg, params, tcfg, tparams = pair
    want = _flat(params)
    got = {k: v.numpy() for k, v in TM.param_dict(tparams).items()}
    assert set(got) == set(want)
    assert any(k.startswith("blocks/moe/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"]["moe"]["router"]
    with pytest.raises(ValueError):
        TM.params_from_numpy(tcfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["blocks"]["moe"]["gate"] = tree["blocks"]["moe"]["gate"][:, :2]
    with pytest.raises(ValueError):
        TM.params_from_numpy(tcfg, tree, device="cpu")


def test_init_params_follows_param_defs(pair):
    _, params, tcfg, _ = pair
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k.replace("/", "."): v.shape for k, v in _flat(params).items()}
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == want
    gate = p.blocks.moe.gate  # (nb, E, D, F): fan-in nb * E * D
    fan_in = gate.shape[0] * gate.shape[1] * gate.shape[2]
    assert abs(float(gate.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert abs(float(p.blocks.moe.router.std()) - 0.02) < 0.002


def test_sliced_draw_keeps_the_distribution(monkeypatch):
    """A leaf over DRAW_SLICE elements is drawn slice by slice along its
    leading dims, with the whole leaf's std."""
    from repro_torch.models import layers as TL
    monkeypatch.setattr(TL, "DRAW_SLICE", 1000)
    defs = {"w": TL.ParamDef((2, 4, 50, 60), (None,) * 4)}
    w = TL.init_tree(defs, torch.Generator().manual_seed(0), torch.float32,
                     torch.device("cpu"))["w"]
    assert abs(float(w.std()) * np.sqrt(2 * 4 * 50) - 1.0) < 0.05
    assert not torch.equal(w[0, 0], w[0, 1])  # each slice its own draw


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def _pools(cfg, rng, n_pages=9, ps=8):
    shape = (cfg.num_layers, n_pages, ps, cfg.kv_heads(), cfg.head_dim_())
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _run_jax(fn, kp, vp, *args, **kw):
    cache = {"blocks": {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}}
    logits, cache = fn(*args[:2], cache, *[jnp.asarray(a) for a in args[2:]],
                       rules=None, **kw)
    return (np.asarray(logits), np.asarray(cache["blocks"]["k"]),
            np.asarray(cache["blocks"]["v"]))


def _run_port(fn, kp, vp, *args, **kw):
    cache = {"blocks": {"k": torch.from_numpy(kp.copy()),
                        "v": torch.from_numpy(vp.copy())}}
    with torch.inference_mode():
        logits, cache = fn(*args[:2], cache,
                           *[torch.from_numpy(a) for a in args[2:]], **kw)
    return (logits.numpy(), cache["blocks"]["k"].numpy(),
            cache["blocks"]["v"].numpy())


def _same(got, want, live):
    # every row of a moe dispatch takes expert capacity, so the inactive
    # rows' outputs count too: they must agree wherever the kernel defines
    # them (live rows' logits, and the pages past the null page)
    np.testing.assert_allclose(got[0][live], want[0][live], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], **TOL)


def test_prefill_matches_jax(pair):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    true_len = np.array([16, 11, 4], np.int32)
    jl, jc = JM.prefill(cfg, params, jnp.asarray(toks), rules=None,
                        remat=False, cache_len=24,
                        true_len=jnp.asarray(true_len))
    with torch.inference_mode():
        tl, tc = TM.prefill(tcfg, tparams, torch.from_numpy(toks),
                            cache_len=24, true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)


@pytest.mark.parametrize("impls", IMPLS, ids=[t for _, t in IMPLS])
def test_paged_decode_step_matches_jax(pair, impls):
    """Eight rows (so routing can overflow the capacity of 4): live rows, a
    copy-on-write break and inactive rows with stale tokens."""
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(4)
    kp, vp = _pools(cfg, rng, n_pages=12)
    table = np.full((8, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [1, 2, 6]
    table[2, :1] = [7]
    table[4, :2] = [8, 9]
    table[5, :1] = [10]
    pos = np.array([13, 20, 2, 0, 9, 5, 0, 0], np.int32)
    lengths = np.array([14, 21, 3, 0, 10, 6, 0, 0], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (8, 1)).astype(np.int32)
    cow_src = np.array([0, 4, 0, 0, 0, 0, 0, 0], np.int32)
    cow_dst = np.array([0, 6, 0, 0, 0, 0, 0, 0], np.int32)
    want = _run_jax(lambda c, p, cache, *a, **kw: JM.paged_decode_step(
        c, p, cache, *a[:4], cow=(a[4], a[5]), **kw), kp, vp, cfg, params,
        tok, pos, table, lengths, cow_src, cow_dst, impl=impls[0])
    got = _run_port(lambda c, p, cache, *a, **kw: TM.paged_decode_step(
        c, p, cache, *a[:4], cow=(a[4], a[5]), **kw), kp, vp, tcfg, tparams,
        tok, pos, table, lengths, cow_src, cow_dst, impl=impls[1])
    _same(got, want, lengths > 0)


@pytest.mark.parametrize("impls", IMPLS, ids=[t for _, t in IMPLS])
def test_paged_prefill_chunk_matches_jax(pair, impls):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(5)
    kp, vp = _pools(cfg, rng)
    table = np.array([[3, 5, -1, -1], [1, -1, -1, -1], [-1, -1, -1, -1]],
                     np.int32)
    toks = rng.integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    offset = np.array([8, 0, 0], np.int32)
    chunk_end = np.array([14, 8, 0], np.int32)
    want = _run_jax(JM.paged_prefill_chunk, kp, vp, cfg, params, toks,
                    offset, chunk_end, table, impl=impls[0])
    got = _run_port(TM.paged_prefill_chunk, kp, vp, tcfg, tparams, toks,
                    offset, chunk_end, table, impl=impls[1])
    _same(got, want, chunk_end > 0)


@pytest.mark.parametrize("impls", IMPLS, ids=[t for _, t in IMPLS])
def test_paged_verify_step_matches_jax(pair, impls):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(6)
    kp, vp = _pools(cfg, rng)
    table = np.array([[3, 5, -1, -1], [1, 2, 6, -1], [-1, -1, -1, -1]],
                     np.int32)
    toks = rng.integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    pos = np.array([9, 17, 0], np.int32)
    lengths = np.array([14, 20, 0], np.int32)  # row 1: 3 of 5 real
    want = _run_jax(JM.paged_verify_step, kp, vp, cfg, params, toks, pos,
                    table, lengths, impl=impls[0])
    got = _run_port(TM.paged_verify_step, kp, vp, tcfg, tparams, toks, pos,
                    table, lengths, impl=impls[1])
    np.testing.assert_allclose(got[0][0], want[0][0], **TOL)
    np.testing.assert_allclose(got[0][1, :3], want[0][1, :3], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], **TOL)


def _flat_cache(cfg, rng, B, W):
    shape = (cfg.num_layers, B, W, cfg.kv_heads(), cfg.head_dim_())
    k_pos = np.where(np.arange(W)[None] < rng.integers(3, W - 6, B)[:, None],
                     np.arange(W)[None], -1).astype(np.int32)
    return {"blocks": {"k": rng.standard_normal(shape).astype(np.float32),
                       "v": rng.standard_normal(shape).astype(np.float32)},
            "k_pos": k_pos}


def _flat_step(fn, tfn, pair, cache, *args):
    cfg, params, tcfg, tparams = pair
    jc = jax.tree.map(jnp.asarray, cache)
    jl, jc = fn(cfg, params, jc, *[jnp.asarray(a) for a in args],
                rules=None)
    tc = {"blocks": {k: torch.from_numpy(v.copy())
                     for k, v in cache["blocks"].items()},
          "k_pos": torch.from_numpy(cache["k_pos"].copy())}
    with torch.inference_mode():
        tl, tc = tfn(tcfg, tparams, tc, *[torch.from_numpy(a) for a in args])
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)
    np.testing.assert_array_equal(tc["k_pos"].numpy(),
                                  np.asarray(jc["k_pos"]))
    return tl.numpy(), np.asarray(jl)


def test_flat_decode_step_matches_jax(pair):
    rng = np.random.default_rng(7)
    cache = _flat_cache(pair[0], rng, 6, 24)
    pos = (cache["k_pos"].max(1) + 1).astype(np.int32)
    tok = rng.integers(0, pair[0].vocab_size, (6, 1)).astype(np.int32)
    got, want = _flat_step(JM.decode_step, TM.decode_step, pair, cache, tok,
                           pos)
    np.testing.assert_allclose(got, want, **TOL)


def test_flat_verify_step_matches_jax(pair):
    rng = np.random.default_rng(8)
    cache = _flat_cache(pair[0], rng, 4, 24)
    pos = (cache["k_pos"].max(1) + 1).astype(np.int32)
    toks = rng.integers(0, pair[0].vocab_size, (4, 5)).astype(np.int32)
    n_new = np.array([5, 3, 0, 1], np.int32)
    got, want = _flat_step(JM.verify_step, TM.verify_step, pair, cache,
                           toks, pos, n_new)
    for b, n in enumerate(n_new):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_families_not_ported_still_raise(arch):
    """The dense/moe guard of serving: the ssm and hybrid families have
    their model (test_torch_families.py), but the engine and the paged
    cache refuse them, as the JAX package's do."""
    from repro_torch.serve import ServeEngine as TServeEngine
    tcfg = t_smoke_variant(t_get_config(arch))
    assert "blocks" in TM.param_defs(tcfg)
    with pytest.raises(NotImplementedError, match="ServeEngine supports"):
        TServeEngine(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="paged cache"):
        TM.init_paged_cache(tcfg, 4, 8, "cpu")
