"""Generation and the training loop of the remaining model families
(rwkv6-1.6b, jamba-1.5-large-398b, llama-3.2-vision-90b, whisper-small;
smoke variants) in the port against the JAX package: `prefill` caches
(headroom past S, and right-padded rows with `true_len`), eight flat-cache
`decode_step`s (logits and every cache entry after each), a 16-token
greedy stream through the generation entry points
(`launch.steps.make_prefill_step` / `make_serve_step`),
`tests/test_arch_smoke.py::test_prefill_matches_decode` on the port for
its three archs, and `launch.train --smoke` loss histories.  Weights and
inputs as in `test_torch_families.py`.

Tolerances: logits and caches at rtol/atol 1e-4; the greedy streams
equal; prefill-matches-decode at the reference test's rtol 2e-2, atol
1e-1 (chunked prefill against stepwise decode); loss histories at rtol
1e-4 (`test_torch_lm_train.py`'s loop tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models import model as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from test_torch_families import FAMILY_ARCHS, jax_params, memory

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def pair(request):
    cfg = smoke_variant(get_config(request.param))
    tree = jax_params(cfg)
    tcfg = t_smoke_variant(t_get_config(request.param))
    return (cfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TM.params_from_numpy(tcfg, tree, device="cpu"))


def _inputs(cfg, seed, S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, memory(cfg, rng)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _check_cache(got, want):
    assert set(got) == set(want)
    assert set(got["blocks"]) == set(want["blocks"])
    for k, w in want["blocks"].items():
        assert tuple(got["blocks"][k].shape) == w.shape, k
        np.testing.assert_allclose(got["blocks"][k].numpy(), np.asarray(w),
                                   err_msg=k, **TOL)
    if "k_pos" in want:
        assert np.array_equal(got["k_pos"].numpy(), np.asarray(want["k_pos"]))


@pytest.mark.parametrize("true_len", [False, True],
                         ids=["cache_len", "true_len"])
def test_prefill_matches_jax(pair, true_len):
    """A 16-token prompt into a 40-row cache (k/v zero-padded past the
    prompt, on seq axis 3 for vlm); with true_len, rows of 16 and 11 real
    tokens (per-row k_pos, logits at each row's last real token)."""
    cfg, params, tcfg, tparams = pair
    toks, mem = _inputs(cfg, 4, 16)
    tl = np.array([16, 11], np.int32) if true_len else None
    jl, jc = JM.prefill(cfg, params, jnp.asarray(toks), memory=_j(mem),
                        rules=None, remat=False, cache_len=40,
                        true_len=_j(tl))
    with torch.inference_mode():
        gl, gc = TM.prefill(tcfg, tparams, torch.from_numpy(toks),
                            memory=_t(mem), cache_len=40, true_len=_t(tl))
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl), **TOL)
    _check_cache(gc, jc)


def test_decode_steps_match_jax(pair):
    """Eight lockstep decode steps after a 16-token prefill into a 32-row
    cache: logits and every cache entry (k/v rows, k_pos, mamba conv/h,
    rwkv shift/wkv, xk/xv) after each step."""
    cfg, params, tcfg, tparams = pair
    toks, mem = _inputs(cfg, 5, 24)
    _, jc = JM.prefill(cfg, params, jnp.asarray(toks[:, :16]),
                       memory=_j(mem), rules=None, remat=False, cache_len=32)
    jstep = jax.jit(JS.make_serve_step(cfg, None))
    with torch.inference_mode():
        _, gc = TM.prefill(tcfg, tparams, torch.from_numpy(toks[:, :16]),
                           memory=_t(mem), cache_len=32)
        for t in range(16, 24):
            jl, jc = jstep(params, jc, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
            gl, gc = TM.decode_step(tcfg, tparams, gc,
                                    torch.from_numpy(toks[:, t:t + 1]), t)
            np.testing.assert_allclose(gl.numpy(), np.asarray(jl),
                                       err_msg=f"step {t}", **TOL)
            _check_cache(gc, jc)


def test_greedy_stream_matches_jax(pair):
    """The generation entry points: `make_prefill_step`'s logits over an
    8-token prompt, then 16 greedy tokens through `make_serve_step` from
    a prefill into 24 rows; the streams are equal."""
    cfg, params, tcfg, tparams = pair
    toks, mem = _inputs(cfg, 6, 8)
    batch = {"tokens": toks} if mem is None else {"tokens": toks,
                                                  "memory": mem}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, _ = JS.make_prefill_step(cfg, None)(params, jb)
    jstep = jax.jit(JS.make_serve_step(cfg, None))
    _, jc = JM.prefill(cfg, params, jb["tokens"], memory=jb.get("memory"),
                       rules=None, cache_len=24)
    want, logits = [], jl
    for t in range(8, 24):
        want.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
        logits, jc = jstep(params, jc, jnp.asarray(want[-1])[:, None],
                           jnp.int32(t))
    with torch.inference_mode():
        tl, _ = TS.make_prefill_step(tcfg)(tparams, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tstep = TS.make_serve_step(tcfg)
        _, tc = TM.prefill(tcfg, tparams, tb["tokens"],
                           memory=tb.get("memory"), cache_len=24)
        got, logits = [], tl
        for t in range(8, 24):
            got.append(logits[:, -1].argmax(-1).numpy())
            logits, tc = tstep(tparams, tc,
                               torch.from_numpy(got[-1])[:, None], t)
    assert np.stack(got, 1).shape == (B, 16)
    assert np.array_equal(np.stack(got, 1), np.stack(want, 1))


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b"])
def test_prefill_matches_decode(arch):
    """Prefill-then-decode == forward over the same tokens (last logits),
    on the port."""
    cfg = t_smoke_variant(t_get_config(arch))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 16)).astype(np.int32))
    with torch.inference_mode():
        full_logits = TM.forward(cfg, params, toks, remat=False)
        _, cache = TM.prefill(cfg, params, toks[:, :-1], cache_len=32)
        dec_logits, _ = TM.decode_step(cfg, params, cache, toks[:, -1:], 15)
    np.testing.assert_allclose(dec_logits[:, 0].numpy(),
                               full_logits[:, -1].numpy(),
                               rtol=2e-2, atol=1e-1)


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b"])
def test_launch_train_smoke_matches_jax(arch, monkeypatch):
    """`train(arch, smoke=True)`: the memory batch is stub zeros in both
    packages; the same workers and sim time at every step, losses at rtol
    1e-4.  The port starts from the JAX init (the loop's own seed)."""
    kw = dict(smoke=True, train_steps=4, global_batch=4, seq_len=64,
              workers=2, elastic="2:1", log_every=100, lr=3e-3, seed=0)
    want = JT.train(arch, **kw)["history"]
    cfg = smoke_variant(get_config(arch))
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))
    monkeypatch.setattr(TM, "init_params",
                        lambda c, gen, device: TM.params_from_numpy(
                            c, tree, device=device))
    got = TT.train(arch, device="cpu", **kw)["history"]
    assert [h["workers"] for h in got] == [h["workers"] for h in want] \
        == [2, 2, 1, 1]
    assert [h["sim_time"] for h in got] == [h["sim_time"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4)
