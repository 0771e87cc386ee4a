"""The port's flat-cache decode and speculative verify steps vs the JAX
package on the same parameters: `decode_step` with a scalar position over
the shared k_pos of a lockstep prefill (plain and ring writes) and with
per-row positions over a slot pool's per-row k_pos, `verify_step` with
full, partial, empty and cache-overflowing spans, and `paged_verify_step`
through both paged implementations ("gather" = JAX "xla", "kernel" = JAX
"pallas" in interpret mode; the port's kernel wrapper runs its plain
version on the CPU).  Inputs are made with numpy from a seed.  Logits of
real positions agree at 1e-5 (fp32), cache rows at 1e-5 and key positions
exactly; position j of a verify span equals the j-th of sequential
`decode_step`s at 1e-5.

Configs: the smoke variants of smollm-360m and h2o-danube-1.8b (grouped
head layout; danube with a sliding window of 16) and a narrow smollm-360m
with its real 15 query heads over 5 KV heads (the flat head layout,
H_pad 16)."""
import dataclasses

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

TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = [("xla", "gather"), ("pallas", "kernel")]


def flat_heads(smoke):
    """smollm-360m's real head ratio (15 over 5) at the smoke width."""
    return dataclasses.replace(smoke, name="smollm-360m-flat-heads",
                               num_heads=15, num_kv_heads=5)


CONFIGS = {"smollm-360m": lambda s: s, "h2o-danube-1.8b": lambda s: s,
           "smollm-360m-flat-heads": flat_heads}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines here run thousands of tiny CPU ops: one intra-op thread
    each keeps them from contending with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    arch = request.param.replace("-flat-heads", "")
    cfg = CONFIGS[request.param](smoke_variant(get_config(arch)))
    tcfg = CONFIGS[request.param](t_smoke_variant(t_get_config(arch)))
    params = JM.init_params(cfg, jax.random.key(0))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


def _tcache(c):
    return {"blocks": {k: torch.from_numpy(np.array(v))
                       for k, v in c["blocks"].items()},
            "k_pos": torch.from_numpy(np.array(c["k_pos"]))}


def _np_cache(c):
    return {"k": np.asarray(c["blocks"]["k"]),
            "v": np.asarray(c["blocks"]["v"]),
            "k_pos": np.asarray(c["k_pos"])}


def _same_cache(got, want):
    np.testing.assert_array_equal(got["k_pos"], want["k_pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], **TOL)


def _prompts(cfg, rng, lens, S):
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks


def test_flat_heads_config_has_the_flat_head_layout(pair):
    _, _, tcfg, _ = pair
    kind, hp, _ = t_attn.head_layout(tcfg)
    if tcfg.num_heads == 15:
        assert (kind, hp) == ("flat", 16)
    else:
        assert kind == "grouped"


def test_prefill_k_pos_matches_jax(pair):
    """Without true_len one shared arange/-1 vector; with it, per row."""
    cfg, params, tcfg, tparams = pair
    toks = _prompts(cfg, np.random.default_rng(0), [9, 5], 12)
    for true_len in (None, np.array([9, 5], np.int32)):
        jl, jc = JM.prefill(cfg, params, jnp.asarray(toks), rules=None,
                            remat=False, cache_len=20,
                            true_len=None if true_len is None
                            else jnp.asarray(true_len))
        with torch.inference_mode():
            tl, tc = TM.prefill(tcfg, tparams, torch.from_numpy(toks),
                                cache_len=20,
                                true_len=None if true_len is None
                                else torch.from_numpy(true_len))
        np.testing.assert_array_equal(tc["k_pos"].numpy(),
                                      np.asarray(jc["k_pos"]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_step_scalar_pos_matches_jax(pair, ring):
    """A lockstep batch: one scalar position, the shared k_pos; three
    steps, the last of a ring cache wrapping onto row 0."""
    cfg, params, tcfg, tparams = pair
    toks = _prompts(cfg, np.random.default_rng(1), [10, 10], 10)
    W = 12
    _, jc = JM.prefill(cfg, params, jnp.asarray(toks), rules=None,
                       remat=False, cache_len=W)
    tc = _tcache(jax.tree.map(np.asarray, jc))
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 3))
    for step in range(3):
        t = tok[:, step: step + 1].astype(np.int32)
        jl, jc = JM.decode_step(cfg, params, jc, jnp.asarray(t),
                                jnp.int32(10 + step), rules=None, ring=ring)
        with torch.inference_mode():
            tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(t),
                                    10 + step, ring=ring)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _same_cache(_np_cache(tc), _np_cache(jc))


def test_decode_step_vector_pos_matches_jax(pair):
    """A slot pool: right-padded prompts (per-row k_pos from true_len),
    every row at its own position; an init_cache(per_slot=True) row that
    stays empty decodes garbage that is not compared."""
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(3)
    lens = np.array([9, 4, 12], np.int32)
    toks = _prompts(cfg, rng, lens, 12)
    W = 16
    _, jc = JM.prefill(cfg, params, jnp.asarray(toks), rules=None,
                       remat=False, cache_len=W, true_len=jnp.asarray(lens))
    tc = _tcache(jax.tree.map(np.asarray, jc))
    pos = lens.copy()
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = JM.decode_step(cfg, params, jc, jnp.asarray(t),
                                jnp.asarray(pos), rules=None)
        with torch.inference_mode():
            tl, tc = TM.decode_step(tcfg, tparams, tc, torch.from_numpy(t),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _same_cache(_np_cache(tc), _np_cache(jc))
        pos = pos + 1
    # an empty per-slot pool: init_cache agrees
    je = JM.init_cache(cfg, 2, W, per_slot=True)
    te = TM.init_cache(tcfg, 2, W, "cpu", per_slot=True)
    _same_cache(_np_cache(te), _np_cache(je))
    with pytest.raises(ValueError, match="per-row k_pos"):
        TM.decode_step(tcfg, tparams, TM.init_cache(tcfg, 2, W, "cpu"),
                       torch.zeros((2, 1), dtype=torch.int32),
                       torch.tensor([1, 2]))


def _verify_inputs(cfg, rng, W, Q):
    """A per-row pool after a right-padded prefill, and verify spans: a
    full span, a partial one (2 of Q real), an inactive row (0) and a span
    that runs past the cache's last row (its writes past W drop)."""
    lens = np.array([6, 9, 3, W - 2], np.int32)
    toks = _prompts(cfg, rng, lens, W)
    span = rng.integers(0, cfg.vocab_size, (4, Q)).astype(np.int32)
    n_new = np.array([Q, 2, 0, Q], np.int32)
    return toks, lens, span, n_new


@pytest.mark.parametrize("Q", [3, 5])
def test_verify_step_matches_jax(pair, Q):
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(4 + Q)
    W = 16
    toks, lens, span, n_new = _verify_inputs(cfg, rng, W, Q)
    _, jc = JM.prefill(cfg, params, jnp.asarray(toks), rules=None,
                       remat=False, cache_len=W, true_len=jnp.asarray(lens))
    tc = _tcache(jax.tree.map(np.asarray, jc))
    jl, jc = JM.verify_step(cfg, params, jc, jnp.asarray(span),
                            jnp.asarray(lens), jnp.asarray(n_new),
                            rules=None)
    with torch.inference_mode():
        tl, tc = TM.verify_step(tcfg, tparams, tc, torch.from_numpy(span),
                                torch.from_numpy(lens),
                                torch.from_numpy(n_new))
    real = np.arange(Q)[None] < n_new[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    _same_cache(_np_cache(tc), _np_cache(jc))
    # the overflowing row wrote its two in-range positions, nothing else
    assert _np_cache(tc)["k_pos"][3, -2:].tolist() == [W - 2, W - 1]


def test_verify_span_equals_sequential_decode_steps(pair):
    """Position j of one verify span == the j-th of j+1 sequential
    decode_steps over the same tokens (the lossless claim), and the span
    leaves the cache the steps leave."""
    cfg, params, tcfg, tparams = pair
    rng = np.random.default_rng(9)
    W, Q = 20, 4
    lens = np.array([7, 11], np.int32)
    toks = _prompts(cfg, rng, lens, 12)
    span = rng.integers(0, cfg.vocab_size, (2, Q)).astype(np.int32)
    with torch.inference_mode():
        _, c0 = TM.prefill(tcfg, tparams, torch.from_numpy(toks),
                           cache_len=W, true_len=torch.from_numpy(lens))
        c1 = {"blocks": {k: v.clone() for k, v in c0["blocks"].items()},
              "k_pos": c0["k_pos"].clone()}
        vl, c0 = TM.verify_step(tcfg, tparams, c0, torch.from_numpy(span),
                                torch.from_numpy(lens),
                                torch.full((2,), Q, dtype=torch.int32))
        for j in range(Q):
            dl, c1 = TM.decode_step(tcfg, tparams, c1,
                                    torch.from_numpy(span[:, j: j + 1]),
                                    torch.from_numpy(lens + j))
            np.testing.assert_allclose(vl[:, j].numpy(), dl[:, 0].numpy(),
                                       **TOL)
    _same_cache(_np_cache(c0), _np_cache(c1))


def _pools(cfg, rng, n_pages=9, ps=8):
    shape = (cfg.num_layers, n_pages, ps, cfg.kv_heads(), cfg.head_dim_())
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("impls", IMPLS, ids=[t for _, t in IMPLS])
def test_paged_verify_step_matches_jax(pair, impls):
    """Four rows: a full span crossing into a new page, a partial span
    (padding routed to the null page) breaking a copy-on-write share
    (page 4 -> 6), a span starting a page, and an inactive row."""
    cfg, params, tcfg, tparams = pair
    kind = t_attn.head_layout(tcfg)[0]
    if impls[1] == "kernel" and kind != "grouped":
        with pytest.raises(NotImplementedError, match="grouped head"):
            TM.paged_verify_step(
                tcfg, tparams,
                {"blocks": {k: torch.zeros(s) for k, s in zip(
                    "kv", [(tcfg.num_layers, 3, 8, tcfg.kv_heads(),
                            tcfg.head_dim_())] * 2)}},
                torch.zeros((1, 2), dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.int32),
                torch.ones(1, dtype=torch.int32), impl="kernel")
        return
    rng = np.random.default_rng(5)
    kp, vp = _pools(cfg, rng)
    Q = 5
    table = np.array([[3, 5, -1, -1], [1, 2, 6, -1], [7, 8, -1, -1],
                      [-1, -1, -1, -1]], np.int32)
    pos = np.array([6, 17, 8, 0], np.int32)
    lengths = np.array([11, 19, 13, 0], np.int32)  # pos + n_new
    tok = rng.integers(0, cfg.vocab_size, (4, Q)).astype(np.int32)
    cow_src = np.array([0, 4, 0, 0], np.int32)
    cow_dst = np.array([0, 6, 0, 0], np.int32)
    jl, jcache = JM.paged_verify_step(
        cfg, params, {"blocks": {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}},
        jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(table),
        jnp.asarray(lengths), rules=None, impl=impls[0],
        cow=(jnp.asarray(cow_src), jnp.asarray(cow_dst)))
    tcache = {"blocks": {"k": torch.from_numpy(kp.copy()),
                         "v": torch.from_numpy(vp.copy())}}
    with torch.inference_mode():
        tl, tcache = TM.paged_verify_step(
            tcfg, tparams, tcache, torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(table),
            torch.from_numpy(lengths), impl=impls[1],
            cow=(torch.from_numpy(cow_src), torch.from_numpy(cow_dst)))
    real = (pos[:, None] + np.arange(Q)[None]) < lengths[:, None]
    assert tl.shape == (4, Q, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    for name in ("k", "v"):  # pages, past the null page
        np.testing.assert_allclose(tcache["blocks"][name].numpy()[:, 1:],
                                   np.asarray(jcache["blocks"][name])[:, 1:],
                                   **TOL)
