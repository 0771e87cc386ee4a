"""The flat decode step with a lockstep (shared) k_pos on meta tensors,
and on the CPU against the JAX package.  The step writes its k_pos entry
and its K/V rows through a 1-element index (`index_copy_`): a 0-d index
tensor is read on the host, which a meta tensor refuses and which costs
the card a device-to-host sync every step.

For the dense, moe, audio, vlm and hybrid smoke variants, at positions 3,
9 and 17 on an 8-row cache (in range, then clamped to the last row, or
as a ring at pos % 8): the step runs on meta tensors (logits of the CPU
step's shape), and on the CPU its logits and every cache entry equal the
JAX package's at rtol/atol 1e-4, k_pos exactly.  Weights are the JAX
init (`test_torch_families.jax_params`); a vlm/audio cache holds random
memory K/V as a prefill would leave them.
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
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from test_torch_families import jax_params

DECODE_ARCHS = ["qwen3-4b", "grok-1-314b", "whisper-small",
                "llama-3.2-vision-90b", "jamba-1.5-large-398b"]
W = 8  # cache rows


@pytest.mark.parametrize("ring", [False, True], ids=["clamped", "ring"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_flat_decode_runs_on_meta_and_matches_reference(arch, ring):
    cfg = smoke_variant(get_config(arch))
    tcfg = t_smoke_variant(t_get_config(arch))
    tree = jax_params(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = TM.params_from_numpy(tcfg, tree, device="cpu")
    B, X = 2, TS.memory_len(tcfg)
    rng = np.random.default_rng(3)
    cache = JM.init_cache(cfg, B, W, cross_len=X)
    tcache = TM.init_cache(tcfg, B, W, "cpu", cross_len=X)
    if X:  # the memory's K/V, as a prefill leaves them
        for k in ("xk", "xv"):
            a = (rng.standard_normal(cache["blocks"][k].shape) * 0.1
                 ).astype(np.float32)
            cache["blocks"][k] = jnp.asarray(a)
            tcache["blocks"][k].copy_(torch.from_numpy(a))
    meta = TM.cache_sds(tcfg, B, W, cross_len=X)
    mparams = TM.Transformer(tcfg, TM.param_sds(tcfg))
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(
        cfg, p, c, t, pos, rules=None, ring=ring))
    for pos in (3, 9, 17):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.int32(pos))
        tlogits, tcache = TM.decode_step(
            tcfg, tparams, tcache, torch.from_numpy(tok),
            torch.tensor(pos, dtype=torch.int32), ring=ring)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
        assert np.array_equal(tcache["k_pos"].numpy(),
                              np.asarray(cache["k_pos"]))
        for k, v in cache["blocks"].items():
            np.testing.assert_allclose(tcache["blocks"][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        mlogits, meta = TM.decode_step(
            tcfg, mparams, meta, torch.empty((B, 1), dtype=torch.int32,
                                             device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"), ring=ring)
        assert mlogits.device.type == "meta"
        assert mlogits.shape == tlogits.shape
        assert meta["k_pos"].shape == (W,)
    kp = tcache["k_pos"].numpy()
    if ring:  # rows 3 and 1 (9 % 8, then 17 % 8 over it)
        assert kp[3] == 3 and kp[1] == 17
    else:  # row 7 holds the last clamped write
        assert kp[3] == 3 and kp[7] == 17
