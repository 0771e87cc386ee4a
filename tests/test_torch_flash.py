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
