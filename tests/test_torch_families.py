"""The remaining model families in the port against the JAX package:
rwkv6-1.6b (ssm), jamba-1.5-large-398b (hybrid: attention + mamba, moe
every other sub-layer), llama-3.2-vision-90b (vlm: cross-attention to
image patches) and whisper-small (audio: a bidirectional encoder over
frames, decoder blocks with cross-attention), each at its smoke variant.
The JAX parameter tree is carried across by `params_from_numpy`; the
vlm's `cross_gate` (zeros at init, which would switch the cross-attention
off) is set to 0.5 in that tree, so both packages run it.  Tokens,
labels, weights and the memory stream are made with numpy from a seed.

Here: the parameter tree, `forward` logits and aux, `loss_fn` and every
gradient, one `make_train_step` update, `init_cache` key for key; the
port's own run of `tests/test_arch_smoke.py`'s matrix over every
non-chicle arch; and the serving guard (both packages' `ServeEngine`
and paged cache refuse these four families).  Prefill, decode and the
training loop are in `test_torch_families_decode.py`.

Tolerances: logits, loss and aux at rtol/atol 1e-4 (`test_torch_model.py`'s
TOL); gradients and updated parameters at rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import TrainConfig, get_config, list_archs, smoke_variant
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.optim import init_opt_state
from repro.serve import ServeEngine as JServeEngine
from repro.sharding import AxisRules
from repro_torch import optim as TO
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine as TServeEngine

FAMILY_ARCHS = ["rwkv6-1.6b", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
                "whisper-small"]
ALL_ARCHS = [a for a in list_archs() if not a.startswith("chicle")]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64


def jax_params(cfg, seed=0):
    """The JAX init as a numpy tree; a vlm's cross gate set to 0.5."""
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(seed)))
    if cfg.family == "vlm":
        tree["blocks"]["cross_gate"] = np.full_like(
            tree["blocks"]["cross_gate"], 0.5)
    return tree


def memory(cfg, rng, batch=B):
    T = TS.memory_len(cfg)
    if not T:
        return None
    return (rng.standard_normal((batch, T, cfg.d_model)) * 0.02).astype(
        np.float32)


def lm_batch(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
             np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
             np.int32),
         "weights": rng.uniform(0.5, 1.5, batch).astype(np.float32)}
    mem = memory(cfg, rng, batch)
    if mem is not None:
        b["memory"] = mem
    return b


def flat(tree, prefix=""):
    """A nested dict by its '/'-joined paths (the port's `param_dict`)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, numpy tree) on the same weights."""
    cfg = smoke_variant(get_config(request.param))
    tree = jax_params(cfg)
    tcfg = t_smoke_variant(t_get_config(request.param))
    return cfg, jax.tree.map(jnp.asarray, tree), tcfg, tree


def port(tcfg, tree):
    return TM.params_from_numpy(tcfg, tree, device="cpu")


def _np(t):
    return t.detach().float().numpy()


def test_param_tree_matches_jax(pair):
    """Same paths and shapes, from `param_defs` and from `init_params`
    (the audio encoder subtree and the stacked sub-layers included)."""
    _, _, tcfg, tree = pair
    want = {k: v.shape for k, v in flat(tree).items()}
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in TM.param_dict(got).items()} \
        == want
    assert {k: tuple(v.shape) for k, v in
            TM.param_dict(port(tcfg, tree)).items()} == want


def test_forward_matches_jax(pair):
    cfg, params, tcfg, tree = pair
    b = lm_batch(cfg, 1)
    mem = b.get("memory")
    jl, jaux = JM.forward(cfg, params, jnp.asarray(b["tokens"]),
                          memory=None if mem is None else jnp.asarray(mem),
                          rules=None, remat=False)
    with torch.no_grad():
        tl, taux = TM.forward(tcfg, port(tcfg, tree),
                              torch.from_numpy(b["tokens"]),
                              memory=None if mem is None
                              else torch.from_numpy(mem), return_aux=True)
    assert tl.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if cfg.family == "hybrid":
        assert float(taux) > 0  # jamba's moe sub-layer


def test_loss_and_every_gradient_match_jax(pair):
    """`loss_fn` with remat (the port's per-block checkpoint, and per
    chunk inside the mamba scan) against `jax.value_and_grad`."""
    cfg, params, tcfg, tree = pair
    b = lm_batch(cfg, 2)

    def lf(p, batch):
        return JM.loss_fn(cfg, p, batch, rules=None, remat=True)

    (jtot, jm), jg = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    ttot, tm, tg = TS.value_and_grad(
        tcfg, port(tcfg, tree), {k: torch.from_numpy(v) for k, v in
                                 b.items()}, remat=True)
    np.testing.assert_allclose(float(ttot), float(jtot), **TOL)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    want = flat(jg)
    assert set(tg) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(_np(tg[k]), w, err_msg=k, **GRAD_TOL)
    if cfg.family == "vlm":
        assert abs(float(want["blocks/cross_gate"][0, 0])) > 0


def test_train_step_matches_jax(pair):
    """One sgdm step with remat: the metrics and every updated leaf."""
    cfg, params, tcfg, tree = pair
    b = lm_batch(cfg, 3)
    tc = TrainConfig(learning_rate=1e-2, remat=True)
    mesh = make_host_mesh()
    with set_mesh(mesh):
        jp, _, jm = jax.jit(JS.make_train_step(cfg, AxisRules(mesh), tc))(
            params, init_opt_state(params),
            {k: jnp.asarray(v) for k, v in b.items()})
    tp = port(tcfg, tree)
    step = TS.make_train_step(tcfg, TTrainConfig(learning_rate=1e-2,
                                                 remat=True))
    tp2, _, tm = step(tp, TO.init_opt_state(TM.param_dict(tp)),
                      {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    want, got = flat(jp), TM.param_dict(tp2)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), w, err_msg=k, **GRAD_TOL)
        moved += int(np.any(w != flat(tree)[k]))
    assert moved > len(want) // 2


@pytest.mark.parametrize("per_slot", [False, True])
def test_init_cache_matches_jax(pair, per_slot):
    """Key for key: shapes and dtypes (no k_pos for ssm; xk/xv at the
    memory length for vlm/audio; stacked mamba states for hybrid)."""
    cfg, _, tcfg, _ = pair
    T = TS.memory_len(cfg)
    want = JM.init_cache(cfg, 3, 40, cross_len=T, per_slot=per_slot)
    got = TM.init_cache(tcfg, 3, 40, "cpu", cross_len=T, per_slot=per_slot)
    assert set(got) == set(want)
    assert ("k_pos" in got) == (cfg.family != "ssm")
    pairs = [(got["blocks"][k], want["blocks"][k]) for k in want["blocks"]]
    assert set(got["blocks"]) == set(want["blocks"])
    if "k_pos" in want:
        pairs.append((got["k_pos"], want["k_pos"]))
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's matrix on the port (every non-chicle arch)
# ---------------------------------------------------------------------------


def _port_batch(cfg, seed=1):
    return {k: torch.from_numpy(v) for k, v in lm_batch(cfg, seed).items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_forward_shapes_and_finite(arch):
    cfg = t_smoke_variant(t_get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _port_batch(cfg)
    with torch.no_grad():
        logits, aux = TM.forward(cfg, params, b["tokens"],
                                 memory=b.get("memory"), return_aux=True)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_train_step(arch):
    cfg = t_smoke_variant(t_get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in TM.param_dict(params).items()}
    step = TS.make_train_step(cfg, TTrainConfig(learning_rate=1e-3,
                                                remat=False))
    params, _, metrics = step(params,
                              TO.init_opt_state(TM.param_dict(params)),
                              _port_batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert any(float((v.detach() - before[k]).abs().max()) > 0
               for k, v in TM.param_dict(params).items())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_port_decode_step(arch):
    cfg = t_smoke_variant(t_get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = TM.init_cache(cfg, B, 32, "cpu", cross_len=TS.memory_len(cfg))
    with torch.no_grad():
        logits, _ = TM.decode_step(cfg, params, cache,
                                   torch.zeros((B, 1), dtype=torch.int32), 0)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Serving stays dense/moe in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serving_refuses_the_other_families_in_both_packages(arch):
    """The engines and the paged cache refuse recurrent state and memory
    streams: the families serve through prefill and decode_step only."""
    cfg = smoke_variant(get_config(arch))
    tcfg = t_smoke_variant(t_get_config(arch))
    assert TServeEngine.__module__.startswith("repro_torch")
    with pytest.raises(NotImplementedError, match="ServeEngine supports"):
        JServeEngine(cfg)
    with pytest.raises(NotImplementedError, match="ServeEngine supports"):
        TServeEngine(tcfg, device="cpu")
    for kv_layout in ("flat", "paged"):
        with pytest.raises(NotImplementedError):
            TServeEngine(tcfg, device="cpu", kv_layout=kv_layout)
    with pytest.raises(NotImplementedError, match="paged cache"):
        JM.init_paged_cache(cfg, 4, 8)
    with pytest.raises(NotImplementedError, match="paged cache"):
        TM.init_paged_cache(tcfg, 4, 8, "cpu")
