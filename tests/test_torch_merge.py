"""The port's weighted merge (CPU tensors, so the wrapper's plain version)
against the JAX package's Pallas kernel in interpret mode, its oracle
`ref.weighted_merge_ref` and `ops.merge_pytree`: f32 at 1e-5 and bf16 at
3e-2, the JAX kernel test's tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_reduce, ops, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.chunk_reduce import (weighted_merge,
                                              weighted_merge_plain)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.uniform(size=k).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1, 7), (3, 128), (8, 2048), (8, 5001),
                                 (16, 5001)])
def test_weighted_merge_matches_pallas_interpret_and_ref(k, n, dtype):
    u, w = _inputs(k, n, seed=k * n)
    ju = jnp.asarray(u).astype(dtype)
    want_pal = chunk_reduce.weighted_merge(ju, jnp.asarray(w), block_n=512,
                                           interpret=True)
    want_ref = ref.weighted_merge_ref(ju, jnp.asarray(w))
    # the same (rounded) inputs on both sides
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = weighted_merge(tu, torch.from_numpy(w))
    assert got.dtype == tu.dtype and got.shape == (n,)
    for want in (want_pal, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_merge_pytree_matches_jax_merge_pytree():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 2, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 5)).astype(np.float32),
            "c": rng.standard_normal((4, 3, 2, 2)).astype(np.float32)}
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    want = ops.merge_pytree(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    got = tops.merge_pytree({k: torch.from_numpy(v) for k, v in tree.items()},
                            torch.from_numpy(w))
    assert set(got) == set(want)
    for k in tree:
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_merge_updates_is_weighted_merge():
    u, w = _inputs(5, 300, seed=2)
    got = tops.merge_updates(torch.from_numpy(u), torch.from_numpy(w))
    want = ops.merge_updates(jnp.asarray(u), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["rank", "weights", "dtype"])
def test_weighted_merge_checks_inputs(bad):
    u, w = (torch.from_numpy(a) for a in _inputs(3, 10, seed=0))
    if bad == "rank":
        u = u[None]
    elif bad == "weights":
        w = w[:2]
    else:
        u = u.double()
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        weighted_merge(u, w)


def test_plain_version_is_the_cpu_path():
    u, w = (torch.from_numpy(a) for a in _inputs(4, 33, seed=3))
    before = weighted_merge.launches
    torch.testing.assert_close(weighted_merge(u, w),
                               weighted_merge_plain(u, w), rtol=0, atol=0)
    assert weighted_merge.launches == before
