"""The port's SSM mixers (`repro_torch.models.ssm`) against the JAX
package's `repro.models.ssm`, function by function, on the same
parameters and inputs made with numpy from a seed, at the smoke widths of
jamba-1.5-large-398b (mamba: d_model 256, d_inner 512, state 16, conv 4)
and rwkv6-1.6b (d_model 256, 4 heads of 64).

S covers one partial chunk (16), exactly one chunk (64) and two chunks
(128), each from a zero state and from a random incoming state.  A
deep-decay case drives the mamba cumulative decay below -60, where the
clipped inverse stops cancelling the unclipped decay; the port must
reproduce the reference there too, not an exact scan.

Tolerance: fp32 at rtol 1e-4, atol 1e-4 (`test_torch_model.py`'s TOL;
two frameworks sum matmuls and cumsums in different orders), gradients
too.  The chunked-vs-sequential tests are `tests/test_substrate.py`'s
two, run on the port at their tolerances.  The last test shows the same
clip in the rwkv model: at a 64-token chunk's end `forward` leaves the
stepwise recurrence in both packages alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA_ARCH = "jamba-1.5-large-398b"
RWKV_ARCH = "rwkv6-1.6b"
SEQS = [16, 64, 128]
B = 2


def _cfgs(arch):
    return smoke_variant(get_config(arch)), t_smoke_variant(t_get_config(arch))


def _params(defs, seed=0, **overrides):
    """A JAX init of `defs` as numpy (with `overrides` added to leaves)
    and the same leaves as port tensors."""
    tree = jax.tree.map(np.asarray, JL.init_tree(defs, jax.random.key(seed),
                                                 jnp.float32))
    for k, delta in overrides.items():
        tree[k] = (tree[k] + delta).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _x(rng, *shape, scale=0.1):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _defs_table(defs):
    return {k: (d.shape, d.axes, d.init, d.scale) for k, d in defs.items()}


@pytest.mark.parametrize("arch,fn", [(MAMBA_ARCH, "mamba_defs"),
                                     (RWKV_ARCH, "rwkv_defs"),
                                     (RWKV_ARCH, "rwkv_ffn_defs")])
def test_defs_match_jax(arch, fn):
    cfg, tcfg = _cfgs(arch)
    assert _defs_table(getattr(TS, fn)(tcfg)) == \
        _defs_table(getattr(JS, fn)(cfg))


def test_chunk_sizes_match_jax():
    assert (TS.MAMBA_CHUNK, TS.RWKV_CHUNK) == (JS.MAMBA_CHUNK, JS.RWKV_CHUNK)
    assert TS.MAMBA_CHUNK == TS.RWKV_CHUNK == 64


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def _mamba_state(cfg, rng, with_state):
    if not with_state:
        return None, None
    di = cfg.ssm_expand * cfg.d_model
    conv = _x(rng, B, cfg.ssm_conv_width - 1, di)
    h = _x(rng, B, di, cfg.ssm_state_dim, scale=1.0)
    return ((jnp.asarray(conv), jnp.asarray(h)),
            (torch.from_numpy(conv), torch.from_numpy(h)))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", SEQS)
def test_mamba_scan_chunked_matches_jax(S, with_state):
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg))
    rng = np.random.default_rng(S)
    di = cfg.ssm_expand * cfg.d_model
    x = _x(rng, B, S, di, scale=1.0)
    h0 = (_x(rng, B, di, cfg.ssm_state_dim, scale=1.0) if with_state
          else np.zeros((B, di, cfg.ssm_state_dim), np.float32))
    wy, wh = JS.mamba_scan_chunked(cfg, jp, jnp.asarray(x), jnp.asarray(h0))
    with torch.no_grad():
        gy, gh = TS.mamba_scan_chunked(tcfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(h0))
    assert gy.dtype == torch.float32 and gh.dtype == torch.float32
    _close(gy, wy)
    _close(gh, wh)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", SEQS)
def test_mamba_forward_matches_jax(S, with_state):
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg))
    rng = np.random.default_rng(10 + S)
    x = _x(rng, B, S, cfg.d_model, scale=1.0)
    jst, tst = _mamba_state(cfg, rng, with_state)
    want, (wc, wh) = JS.mamba_forward(cfg, jp, jnp.asarray(x), jst)
    with torch.no_grad():
        got, (gc, gh) = TS.mamba_forward(tcfg, tp, torch.from_numpy(x), tst)
    _close(got, want)
    _close(gc, wc)
    _close(gh, wh)


def test_mamba_deep_decay_keeps_the_reference_clip():
    """a_log + 3: every step decays by ~exp(-20 dt), so the chunk's
    cumulative decay passes -60 within a few tokens and the clipped
    inverse no longer cancels; the port follows the reference."""
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg), a_log=3.0)
    rng = np.random.default_rng(7)
    x = _x(rng, B, 64, cfg.d_model, scale=1.0)
    jst, tst = _mamba_state(cfg, rng, True)
    want, (_, wh) = JS.mamba_forward(cfg, jp, jnp.asarray(x), jst)
    with torch.no_grad():
        got, (_, gh) = TS.mamba_forward(tcfg, tp, torch.from_numpy(x), tst)
    _close(got, want)
    _close(gh, wh)


def test_mamba_decode_matches_jax():
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg))
    rng = np.random.default_rng(3)
    jst, tst = _mamba_state(cfg, rng, True)
    for t in range(4):
        x = _x(rng, B, 1, cfg.d_model, scale=1.0)
        want, jst = JS.mamba_decode(cfg, jp, jnp.asarray(x), jst)
        with torch.no_grad():
            got, tst = TS.mamba_decode(tcfg, tp, torch.from_numpy(x), tst)
        _close(got, want)
        _close(tst[0], jst[0])
        _close(tst[1], jst[1])


def test_mamba_forward_grads_match_jax():
    """d(sum(out * ct) + sum(h * ct_h))/d(params, x, h0): the per-chunk
    checkpoint recomputes each chunk in backward."""
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg))
    rng = np.random.default_rng(5)
    x = _x(rng, B, 128, cfg.d_model, scale=1.0)
    jst, tst = _mamba_state(cfg, rng, True)
    ct = _x(rng, B, 128, cfg.d_model, scale=1.0)
    ct_h = _x(rng, *jst[1].shape, scale=1.0)

    def jloss(p, x, h0):
        out, (_, h) = JS.mamba_forward(cfg, p, x, (jst[0], h0))
        return jnp.sum(out * ct) + jnp.sum(h * ct_h)

    wg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jst[1])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    h0 = tst[1].clone().requires_grad_(True)
    out, (_, h) = TS.mamba_forward(tcfg, leaves, xt, (tst[0], h0))
    loss = (out * torch.from_numpy(ct)).sum() + (h * torch.from_numpy(
        ct_h)).sum()
    loss.backward()
    for k, g in wg[0].items():
        _close(leaves[k].grad, g, rtol=1e-4, atol=1e-4)
    _close(xt.grad, wg[1])
    _close(h0.grad, wg[2])


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def _rwkv_state(cfg, rng, with_state):
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    if not with_state:
        shift = np.zeros((B, 1, D), np.float32)
        wkv = np.zeros((B, D // hd, hd, hd), np.float32)
    else:
        shift = _x(rng, B, 1, D, scale=1.0)
        wkv = _x(rng, B, D // hd, hd, hd, scale=0.5)
    return shift, wkv


def test_token_shift_matches_jax():
    rng = np.random.default_rng(0)
    x, prev = _x(rng, B, 5, 8), _x(rng, B, 1, 8)
    _close(TS._token_shift(torch.from_numpy(x), torch.from_numpy(prev)),
           JS._token_shift(jnp.asarray(x), jnp.asarray(prev)), rtol=0,
           atol=0)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", SEQS)
def test_rwkv_wkv_chunked_matches_jax(S, with_state):
    cfg, _ = _cfgs(RWKV_ARCH)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    rng = np.random.default_rng(20 + S)
    r, k, v = (_x(rng, B, S, H, hd, scale=1.0) for _ in range(3))
    # decays exp(-exp(.)) from w0 + dd in [-8, 8]: log_w in [-e^8, -e^-8]
    log_w = -np.exp(rng.uniform(-4, 1, (B, S, H, hd))).astype(np.float32)
    u = _x(rng, H, hd, scale=0.5)
    _, s0 = _rwkv_state(cfg, rng, with_state)
    wo, ws = JS.rwkv_wkv_chunked(*(jnp.asarray(a) for a in
                                   (r, k, v, log_w, u, s0)))
    go, gs = TS.rwkv_wkv_chunked(*(torch.from_numpy(a) for a in
                                   (r, k, v, log_w, u, s0)))
    _close(go, wo)
    _close(gs, ws)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", SEQS)
def test_rwkv_time_mix_matches_jax(S, with_state):
    cfg, tcfg = _cfgs(RWKV_ARCH)
    jp, tp = _params(JS.rwkv_defs(cfg))
    rng = np.random.default_rng(30 + S)
    x = _x(rng, B, S, cfg.d_model, scale=1.0)
    shift, wkv = _rwkv_state(cfg, rng, with_state)
    want = JS.rwkv_time_mix(cfg, jp, jnp.asarray(x), jnp.asarray(shift),
                            jnp.asarray(wkv))
    with torch.no_grad():
        got = TS.rwkv_time_mix(tcfg, tp, torch.from_numpy(x),
                               torch.from_numpy(shift),
                               torch.from_numpy(wkv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", SEQS)
def test_rwkv_channel_mix_matches_jax(S, with_state):
    cfg, tcfg = _cfgs(RWKV_ARCH)
    jp, tp = _params(JS.rwkv_ffn_defs(cfg))
    rng = np.random.default_rng(40 + S)
    x = _x(rng, B, S, cfg.d_model, scale=1.0)
    shift, _ = _rwkv_state(cfg, rng, with_state)
    want = JS.rwkv_channel_mix(cfg, jp, jnp.asarray(x), jnp.asarray(shift))
    with torch.no_grad():
        got = TS.rwkv_channel_mix(tcfg, tp, torch.from_numpy(x),
                                  torch.from_numpy(shift))
    for g, w in zip(got, want):
        _close(g, w)


def test_rwkv_time_mix_grads_match_jax():
    cfg, tcfg = _cfgs(RWKV_ARCH)
    jp, tp = _params(JS.rwkv_defs(cfg))
    rng = np.random.default_rng(6)
    x = _x(rng, B, 128, cfg.d_model, scale=1.0)
    shift, wkv = _rwkv_state(cfg, rng, True)
    ct = _x(rng, B, 128, cfg.d_model, scale=1.0)
    ct_s = _x(rng, *wkv.shape, scale=1.0)

    def jloss(p, x, s0):
        out, _, s = JS.rwkv_time_mix(cfg, p, x, jnp.asarray(shift), s0)
        return jnp.sum(out * ct) + jnp.sum(s * ct_s)

    wg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                            jnp.asarray(wkv))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    s0 = torch.from_numpy(wkv).requires_grad_(True)
    out, _, s = TS.rwkv_time_mix(tcfg, leaves, xt, torch.from_numpy(shift),
                                 s0)
    ((out * torch.from_numpy(ct)).sum()
     + (s * torch.from_numpy(ct_s)).sum()).backward()
    for k, g in wg[0].items():
        _close(leaves[k].grad, g)
    _close(xt.grad, wg[1])
    _close(s0.grad, wg[2])


def test_both_packages_refuse_a_seq_not_divisible_by_the_chunk():
    """S = 100 is over one chunk of 64 and not a multiple of it."""
    cfg, tcfg = _cfgs(MAMBA_ARCH)
    jp, tp = _params(JS.mamba_defs(cfg))
    x = np.zeros((1, 100, cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="mamba chunk"):
        JS.mamba_forward(cfg, jp, jnp.asarray(x))
    with pytest.raises(AssertionError, match="mamba chunk"):
        TS.mamba_forward(tcfg, tp, torch.from_numpy(x))
    cfg, tcfg = _cfgs(RWKV_ARCH)
    jp, tp = _params(JS.rwkv_defs(cfg))
    shift, wkv = _rwkv_state(cfg, np.random.default_rng(0), False)
    x = np.zeros((B, 100, cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="rwkv chunk"):
        JS.rwkv_time_mix(cfg, jp, jnp.asarray(x), jnp.asarray(shift),
                         jnp.asarray(wkv))
    with pytest.raises(AssertionError, match="rwkv chunk"):
        TS.rwkv_time_mix(tcfg, tp, torch.from_numpy(x),
                         torch.from_numpy(shift), torch.from_numpy(wkv))


# ---------------------------------------------------------------------------
# tests/test_substrate.py's two, on the port
# ---------------------------------------------------------------------------


def test_mamba_chunked_equals_sequential():
    """Chunked scan == one-token-at-a-time recurrence (state handoff)."""
    cfg = t_smoke_variant(t_get_config(MAMBA_ARCH))
    p = TL.init_tree(TS.mamba_defs(cfg), torch.Generator().manual_seed(0),
                     torch.float32, torch.device("cpu"))
    S, D = 32, cfg.d_model
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        out_full, _ = TS.mamba_forward(cfg, p, x)
        di = cfg.ssm_expand * D
        state = (torch.zeros(B, cfg.ssm_conv_width - 1, di),
                 torch.zeros(B, di, cfg.ssm_state_dim))
        outs = []
        for t in range(S):
            o, state = TS.mamba_forward(cfg, p, x[:, t:t + 1], state)
            outs.append(o)
    np.testing.assert_allclose(out_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=1e-3, atol=1e-3)


def test_rwkv_chunked_equals_sequential():
    cfg = t_smoke_variant(t_get_config(RWKV_ARCH))
    p = TL.init_tree(TS.rwkv_defs(cfg), torch.Generator().manual_seed(0),
                     torch.float32, torch.device("cpu"))
    S, D = 32, cfg.d_model
    hd = cfg.rwkv_head_dim
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(1)) * 0.1
    shift0 = torch.zeros(B, 1, D)
    wkv0 = torch.zeros(B, D // hd, hd, hd)
    with torch.no_grad():
        out_full, _, _ = TS.rwkv_time_mix(cfg, p, x, shift0, wkv0)
        shift, wkv = shift0, wkv0
        outs = []
        for t in range(S):
            o, shift, wkv = TS.rwkv_time_mix(cfg, p, x[:, t:t + 1], shift,
                                             wkv)
            outs.append(o)
    np.testing.assert_allclose(out_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_rwkv_chunk_end_gap_is_the_references():
    """The chunked WKV clips its cumulative log decays at -60.  At the
    init's decay (about e^-1 a token) a 64-token chunk's last offsets pass
    it, so there `forward` is not the stepwise recurrence, in the JAX
    package itself.  rwkv6-1.6b's smoke variant, forward over 128 tokens
    against a 64-token prefill and 64 decode_steps: in both packages the
    logits agree (atol 1e-3) up to chunk offset 55 and miss the
    prefill-vs-decode tolerance (atol 1e-1) at the chunk's end, and the
    port's per-position gap is the reference's (atol 1e-3)."""
    from repro.models import model as JM
    from repro_torch.models import model as TM
    cfg, tcfg = _cfgs(RWKV_ARCH)
    params = JM.init_params(cfg, jax.random.key(0))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, 128)).astype(np.int32)
    full = JM.forward(cfg, params, jnp.asarray(toks), rules=None,
                      remat=False)[0]
    _, cache = JM.prefill(cfg, params, jnp.asarray(toks[:, :64]), rules=None,
                          remat=False)
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg, p, c, t, pos,
                                                       rules=None))
    want = []
    for t in range(64, 128):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        want.append(float(jnp.abs(lg[:, 0] - full[:, t]).max()))
    got = []
    with torch.inference_mode():
        tt = torch.from_numpy(toks)
        tfull = TM.forward(tcfg, tparams, tt)
        _, tcache = TM.prefill(tcfg, tparams, tt[:, :64])
        for t in range(64, 128):
            lg, tcache = TM.decode_step(tcfg, tparams, tcache,
                                        tt[:, t:t + 1], t)
            got.append(float((lg[:, 0] - tfull[:, t]).abs().max()))
    for gap in (want, got):
        assert max(gap[:56]) < 1e-3
        assert max(gap[60:]) > 1e-1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
