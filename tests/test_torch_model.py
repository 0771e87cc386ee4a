"""The port's dense model vs the JAX package on the same parameters: the
JAX parameter tree is carried across by `params_from_numpy`, inputs are made
with numpy from a seed, and `prefill`, `paged_decode_step` and
`paged_prefill_chunk` logits (and the updated KV pages) must agree.

Configs: smoke variants of smollm-360m (grouped layout, g_pad 8, so 6 of 8
heads per group are padding and masked) and h2o-danube-1.8b (the same
layout plus a sliding window of 16), each through both paged
implementations ("gather" = JAX "xla", "kernel" = JAX "pallas" in
interpret mode; on the CPU the port's kernel wrapper runs its plain
version).  Tolerance 1e-4: two frameworks sum matmuls in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.models import model as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import attention as t_attn
from repro_torch.models import model as TM

ARCHS = ["smollm-360m", "h2o-danube-1.8b"]
IMPLS = [("xla", "gather"), ("pallas", "kernel")]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    cfg = smoke_variant(get_config(request.param))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(request.param))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


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


def test_head_layout_is_grouped_with_padding(pair):
    _, _, tcfg, _ = pair
    kind, hp, g_pad = t_attn.head_layout(tcfg)
    assert (kind, hp, g_pad) == ("grouped", 16, 8)
    _, mask = t_attn.head_maps(tcfg)
    assert int(mask.sum()) == tcfg.num_heads


def test_params_from_numpy_rejects_wrong_tree(pair):
    cfg, params, tcfg, _ = pair
    tree = jax.tree.map(np.asarray, params)
    del tree["final_ln"]
    with pytest.raises(ValueError):
        TM.params_from_numpy(tcfg, tree, device="cpu")


def test_init_params_follows_param_defs(pair):
    """Shapes from the defs; std = 1/sqrt(fan_in) with the stacked layer dim
    counted in fan_in, and 0.02 for the embedding."""
    _, params, tcfg, _ = pair
    p = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {".".join(k.key for k in path): tuple(v.shape) for path, v
            in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == want
    wq = p.blocks.attn.wq
    fan_in = wq.shape[0] * wq.shape[1] * wq.shape[2]
    assert abs(float(wq.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert abs(float(p.embed.std()) - 0.02) < 0.002


def test_prefill_matches_jax(pair):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    true_len = np.array([16, 11], np.int32)
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
    """Three rows: one writing into its last page, one breaking a
    copy-on-write share (page 4 -> 6) and one inactive."""
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(1)
    kp, vp = _pools(cfg, rng)
    table = np.array([[3, 5, -1, -1], [1, 2, 6, -1], [-1, -1, -1, -1]],
                     np.int32)
    pos = np.array([13, 20, 0], np.int32)
    lengths = np.array([14, 21, 0], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    cow_src, cow_dst = np.array([0, 4, 0], np.int32), np.array([0, 6, 0],
                                                              np.int32)
    want = _run_jax(lambda c, p, cache, *a, **kw: JM.paged_decode_step(
        c, p, cache, *a[:4], cow=(a[4], a[5]), **kw), kp, vp, cfg, params,
        tok, pos, table, lengths, cow_src, cow_dst, impl=impls[0])
    got = _run_port(lambda c, p, cache, *a, **kw: TM.paged_decode_step(
        c, p, cache, *a[:4], cow=(a[4], a[5]), **kw), kp, vp, tcfg, tparams,
        tok, pos, table, lengths, cow_src, cow_dst, impl=impls[1])
    np.testing.assert_allclose(got[0][:2], want[0][:2], **TOL)  # live rows
    for g, w in zip(got[1:], want[1:]):  # pages, past the null page
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], **TOL)


@pytest.mark.parametrize("impls", IMPLS, ids=[t for _, t in IMPLS])
def test_paged_prefill_chunk_matches_jax(pair, impls):
    """A chunk continuing a prompt past its first page, a first chunk, and
    an inert padding row."""
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(2)
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
    np.testing.assert_allclose(got[0][:2], want[0][:2], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], **TOL)
