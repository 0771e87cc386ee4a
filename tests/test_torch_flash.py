"""The port's flash attention on the CPU against the JAX package: the plain
version (which the wrapper runs for CPU tensors) against the Pallas kernel
in interpret mode on `tests/test_kernels.py`'s cases plus h2o-danube's
head geometry (G=4, hd=80) with a sliding window, and the model-layout
entry point `ops.flash_attention` against the JAX one.  Inputs are made
with numpy from a seed.  Tolerances are the JAX kernel tests': fp32 2e-5,
bf16 2e-2.  The CUDA kernel itself is held to the plain version on the
card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

CASES = [
    # (B, S, KV, G, hd, window, causal, dtype): tests/test_kernels.py's
    (2, 128, 2, 2, 64, 0, True, "float32"),
    (1, 256, 1, 4, 32, 0, True, "float32"),
    (2, 128, 3, 1, 64, 32, True, "float32"),
    (1, 128, 2, 1, 64, 0, False, "float32"),
    (1, 128, 2, 2, 64, 64, True, "bfloat16"),
    # h2o-danube-1.8b's head geometry, narrow: G=4, hd=80, windowed
    (1, 128, 2, 4, 80, 48, True, "float32"),
    (1, 128, 2, 4, 80, 48, True, "bfloat16"),
    (1, 128, 2, 4, 80, 48, False, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_the_pallas_kernel(case):
    B, S, KV, G, hd, win, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B * KV * G, S, hd), (B * KV, S, hd), (B * KV, S, hd)], dtype, 0)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=win,
                               block_q=64, block_k=64, group_size=G,
                               interpret=True)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=win,
                              block_q=64, block_k=64, group_size=G)
    assert tfa.flash_attention.launches == launches  # CPU: plain version
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("G,hd,win", [(3, 32, 0), (4, 80, 48)])
def test_model_layout_entry_point_matches_jax(G, hd, win):
    B, S, KV = 2, 128, 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32", 1)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=win,
                                block_q=64, block_k=64)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=win,
                               block_q=64, block_k=64)
    assert got.shape == (B, S, KV, G, hd)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_entry_point_equals_blocked_attention():
    """The JAX docs call the kernel the drop-in for blocked_attention's
    inner block: on the grouped layout (padded heads masked) both give the
    same attention."""
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    kind, hp, g_pad = tattn.head_layout(cfg)
    assert kind == "grouped"
    B, S, KV, hd = 2, 64, cfg.kv_heads(), cfg.head_dim_()
    _, (q, k, v) = _inputs([(B, S, hp, hd), (B, S, KV, hd), (B, S, KV, hd)],
                           "float32", 2)
    want = tattn.blocked_attention(cfg, q, k, v, window=cfg.sliding_window,
                                   q_block=16)
    got = tops.flash_attention(q.reshape(B, S, KV, g_pad, hd), k, v,
                               causal=True, window=cfg.sliding_window)
    _, hmask = tattn.head_maps(cfg)
    got = got.reshape(B, S, hp, hd) * hmask[None, None, :, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_wrapper_checks_its_contract():
    q, k = torch.zeros(4, 96, 32), torch.zeros(2, 96, 32)
    with pytest.raises(ValueError, match="divide"):
        tfa.flash_attention(q, k, k, block_q=64, group_size=2)
    with pytest.raises(ValueError, match="group_size"):
        tfa.flash_attention(q, k, k, block_q=32, block_k=32, group_size=3)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k.double(), k.double(), block_q=32,
                            block_k=32, group_size=2)
    meta = [t.to("meta") for t in (q, k, k)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(*meta, block_q=32, block_k=32, group_size=2)


# (BHkv, S, G, hd, window, causal) for the plain backward
BWD_PLAIN_CASES = [(2, 64, 2, 32, 0, True), (1, 64, 4, 80, 24, True),
                   (2, 64, 1, 32, 20, False), (1, 64, 3, 16, 0, False)]


@pytest.mark.parametrize("case", BWD_PLAIN_CASES)
def test_flash_attention_bwd_plain_is_autograd_of_the_forward(case):
    """`flash_attention_bwd_plain` (what the backward wrapper runs on the
    CPU) from the forward's output and log-sum-exp equals autograd through
    `flash_attention_plain`, in fp32."""
    BHkv, S, G, hd, win, causal = case
    _, (q, k, v, do) = _inputs([(BHkv * G, S, hd), (BHkv, S, hd),
                                (BHkv, S, hd), (BHkv * G, S, hd)],
                               "float32", 3)
    kw = dict(causal=causal, window=win, group_size=G)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(out, (q, k, v), do)
    launches = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                  out.detach(), lse.detach(), do, **kw)
    assert tfa.flash_attention_bwd.launches == launches  # CPU: plain
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5)


def _danube_heads():
    """h2o-danube-1.8b's own heads (32 over 8 KV, hd 80, g_pad 4), in each
    package's config."""
    from repro.configs import get_config as j_get_config
    return j_get_config("h2o-danube-1.8b"), get_config("h2o-danube-1.8b")


def _smoke_heads():
    """smoke_variant(h2o-danube-1.8b): 4 heads over 2 KV, hd 32, g_pad 8 >
    g 2, so padded heads."""
    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_variant as j_smoke_variant
    return (j_smoke_variant(j_get_config("h2o-danube-1.8b")),
            smoke_variant(get_config("h2o-danube-1.8b")))


@pytest.mark.parametrize("heads", [_smoke_heads, _danube_heads],
                         ids=["smoke_padded", "danube"])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_route_gradients_match_jax_blocked_attention(heads, window):
    """The flash route's function (`flash_grouped_attention`, here on the
    kernels' plain versions) and its gradients through the backward's
    plain twin against `jax.grad` of the JAX package's blocked_attention,
    causal, with and without a window, padded heads included."""
    from repro.models import attention as jattn
    jcfg, cfg = heads()
    kind, hp, g_pad = tattn.head_layout(cfg)
    assert kind == "grouped" and jattn.head_layout(jcfg) == (kind, hp, g_pad)
    B, S, KV, hd = 2, 64, cfg.kv_heads(), cfg.head_dim_()
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(
        [(B, S, hp, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, hp, hd)],
        "float32", 4)

    def jloss(q, k, v):
        out = jattn.blocked_attention(jcfg, q, k, v, window=window,
                                      q_block=16)
        return jnp.sum(out * jdo), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    bwd = tfa.flash_attention_bwd.launches
    out = tattn.flash_grouped_attention(cfg, q, k, v, window=window)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert tfa.flash_attention_bwd.launches == bwd  # CPU: the plain twin
    np.testing.assert_allclose(_np(out.detach()), _np(jout), rtol=2e-5,
                               atol=2e-5)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)
    pad = ~tattn.head_maps(cfg)[1]
    assert not grads[0][:, :, pad].any()  # padded heads get no gradient


LAYOUT = ("grouped", 32, 4)  # h2o-danube-1.8b's: 32 heads over 8 KV
ROUTE_CASES = [
    (("cuda", torch.bfloat16, LAYOUT, 4096, 4096, 80), True),
    (("cpu", torch.bfloat16, LAYOUT, 4096, 4096, 80), False),
    (("cuda", torch.float32, LAYOUT, 4096, 4096, 80), False),
    (("cuda", torch.bfloat16, ("flat", 16, 0), 4096, 4096, 64), False),
    (("cuda", torch.bfloat16, ("grouped", 128, 128), 4096, 4096, 80), False),
    (("cuda", torch.bfloat16, LAYOUT, 4096, 1500, 80), False),
    (("cuda", torch.bfloat16, LAYOUT, 4096, 4096, 96), False),
    (("cuda", torch.bfloat16, LAYOUT, 4000, 4000, 80), False),
    (("cuda", torch.bfloat16, ("grouped", 48, 6), 256, 256, 128), True),
]


@pytest.mark.parametrize("args,takes", ROUTE_CASES,
                         ids=["danube_cuda_bf16", "cpu", "fp32", "flat",
                              "g_pad_over_64", "cross_attention", "hd_96",
                              "s_not_tile_multiple", "grok_heads"])
def test_flash_route_decision(args, takes):
    """The route is a pure function of (device type, dtype, layout, S, Sk,
    hd): one case per condition."""
    assert tattn.flash_route(*args) is takes


def test_blocked_attention_on_the_cpu_keeps_its_path():
    """On the CPU blocked_attention never reaches the flash wrappers."""
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    _, hp, _ = tattn.head_layout(cfg)
    _, (q, k) = _inputs([(1, 128, hp, 32), (1, 128, 2, 32)], "bfloat16", 5)
    called = []
    orig = tattn.flash_grouped_attention
    tattn.flash_grouped_attention = lambda *a, **kw: called.append(1)
    try:
        out = tattn.blocked_attention(cfg, q, k, k, window=16)
    finally:
        tattn.flash_grouped_attention = orig
    assert not called and out.shape == q.shape
