"""The port's SCD pass (CPU tensors, so the wrapper's plain version) against
the JAX package's Pallas kernel in interpret mode and its oracle
`ref.scd_pass_ref`, on the shapes of the JAX kernel's property test
(K <= 4, M in {16, 64}, F in {8, 32}, masked tails), at its tolerance
(rtol/atol 1e-5); the CUDA blocked kernel's CPU twin
`scd_pass_blocked_plain` against both at the same tolerance; and the CoCoA
update dw_k = (v_end_k - w) / sigma_k against the JAX solver's `_scd_pass`
dw."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cocoa import _scd_pass
from repro.kernels import ref, scd
from repro_torch.kernels import ops as tops
from repro_torch.kernels.scd import (scd_pass, scd_pass_blocked_plain,
                                     scd_pass_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(k, m, f, masked, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, m, f)) * 0.3).astype(np.float32)
    y = np.sign(rng.standard_normal((k, m))).astype(np.float32)
    alpha = rng.uniform(size=(k, m)).astype(np.float32)
    w = (rng.standard_normal(f) * 0.1).astype(np.float32)
    mask = np.ones((k, m), np.float32)
    if masked:
        mask[:, m - masked:] = 0.0
    sigma = np.full(k, float(k), np.float32)
    return x, y, alpha, w, mask, sigma


# (K, M, F, masked tail): the JAX property test's ranges
CASES = [(1, 16, 8, 0), (2, 64, 32, 5), (3, 16, 32, 2), (4, 64, 8, 5),
         (4, 16, 8, 0), (1, 64, 32, 3), (3, 64, 8, 1), (2, 16, 32, 4)]


@pytest.mark.parametrize("case", CASES)
def test_scd_pass_matches_pallas_interpret_and_ref(case):
    k, m, f, masked = case
    x, y, alpha, w, mask, sigma = _inputs(k, m, f, masked, seed=sum(case))
    lam_n = 10.0
    jargs = [jnp.asarray(a) for a in (x, y, alpha, w, mask)]
    v_pal, da_pal = scd.scd_pass(*jargs, jnp.float32(lam_n),
                                 jnp.asarray(sigma), interpret=True)
    v_ref, da_ref = ref.scd_pass_ref(*jargs, jnp.float32(lam_n),
                                     jnp.asarray(sigma))
    targs = [torch.from_numpy(a) for a in (x, y, alpha, w, mask)]
    v, da = scd_pass(*targs, lam_n, torch.from_numpy(sigma))
    for want_v, want_da in ((v_pal, da_pal), (v_ref, da_ref)):
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **TOL)
        np.testing.assert_allclose(da.numpy(), np.asarray(want_da), **TOL)
    if masked:
        assert np.all(da.numpy()[:, m - masked:] == 0.0)


@functools.lru_cache(maxsize=None)
def _jax_scd(k, m, f, masked, seed):
    """Inputs, and the JAX Pallas kernel's (interpret mode) and oracle's
    outputs on them, once per shape."""
    x, y, alpha, w, mask, sigma = _inputs(k, m, f, masked, seed)
    jargs = [jnp.asarray(a) for a in (x, y, alpha, w, mask)]
    pal = scd.scd_pass(*jargs, jnp.float32(10.0), jnp.asarray(sigma),
                       interpret=True)
    oracle = ref.scd_pass_ref(*jargs, jnp.float32(10.0), jnp.asarray(sigma))
    return (x, y, alpha, w, mask, sigma), [tuple(np.asarray(t) for t in r)
                                           for r in (pal, oracle)]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("f", [8, 28, 100])
@pytest.mark.parametrize("m", [16, 100, 257])
@pytest.mark.parametrize("block", [8, 32])
def test_scd_blocked_twin_matches_pallas_interpret_and_ref(block, m, f, k):
    """The blocked kernel's arithmetic (base dots, Gram terms, per-step
    broadcast, zero-padded tail block) gives the sequential pass: M not a
    multiple of the block included, masked tails exactly 0."""
    masked = m // 8 + 1
    inputs, wants = _jax_scd(k, m, f, masked, seed=m + f + k)
    x, y, alpha, w, mask, sigma = (torch.from_numpy(a) for a in inputs)
    v, da = scd_pass_blocked_plain(x, y, alpha, w, mask, 10.0, sigma,
                                   block=block)
    for want_v, want_da in wants:
        np.testing.assert_allclose(v.numpy(), want_v, **TOL)
        np.testing.assert_allclose(da.numpy(), want_da, **TOL)
    assert np.all(da.numpy()[:, m - masked:] == 0.0)


def test_scd_masked_samples_untouched():
    """The JAX kernel's masked-tail case: rows past the mask give da
    exactly 0, and v only moves by the unmasked rows."""
    K, M, F = 2, 32, 16
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((K, M, F)).astype(np.float32))
    y = torch.from_numpy(np.sign(rng.standard_normal((K, M))).astype(
        np.float32))
    alpha = torch.zeros(K, M)
    w = torch.zeros(F)
    mask = torch.zeros(K, M)
    mask[:, :8] = 1.0
    sigma = torch.full((K,), 2.0)
    v, da = scd_pass(x, y, alpha, w, mask, 5.0, sigma)
    assert torch.all(da[:, 8:] == 0.0)
    v8, da8 = scd_pass(x[:, :8].contiguous(), y[:, :8].contiguous(),
                       alpha[:, :8].contiguous(), w, mask[:, :8].contiguous(),
                       5.0, sigma)
    torch.testing.assert_close(v, v8, rtol=0, atol=0)
    torch.testing.assert_close(da[:, :8], da8, rtol=0, atol=0)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_cocoa_update_matches_jax_scd_pass_dw(K):
    """dw_k = (v_end_k - w) / sigma_k from the kernel's outputs equals the
    JAX solver's `_scd_pass` dw, on gathered workers with padded tails."""
    rng = np.random.default_rng(K)
    n, F, lam = 300, 12, 1e-2
    X = rng.standard_normal((n, F)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.where(rng.standard_normal(n) > 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.uniform(size=n).astype(np.float32)
    w = (rng.standard_normal(F) * 0.2).astype(np.float32)
    perm = rng.permutation(n)
    pools = np.array_split(perm, K)
    M = max(len(p) for p in pools) + 3  # padded tails on every worker
    idx = np.zeros((K, M), np.int32)
    mask = np.zeros((K, M), np.float32)
    for k, p in enumerate(pools):
        idx[k, :len(p)] = p
        mask[k, :len(p)] = 1.0
    dw_jax, da_jax = _scd_pass(jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(alpha), jnp.asarray(w),
                               jnp.asarray(idx), jnp.asarray(mask),
                               jnp.float32(lam), n_total=n)
    lam_n = float(np.float32(lam) * np.float32(n))
    sigma = np.float32(n) / np.maximum(mask.sum(1), np.float32(1))
    ti = torch.from_numpy(idx).long()
    tw = torch.from_numpy(w)
    ts = torch.from_numpy(sigma)
    v_end, da = tops.scd_local_pass(
        torch.from_numpy(X)[ti], torch.from_numpy(y)[ti],
        torch.from_numpy(alpha)[ti], tw, torch.from_numpy(mask), lam_n, ts)
    dw = (v_end - tw) / ts[:, None]
    np.testing.assert_allclose(da.numpy(), np.asarray(da_jax), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_jax), **TOL)


@pytest.mark.parametrize("bad", ["y_shape", "sigma_shape", "dtype"])
def test_scd_pass_checks_inputs(bad):
    x, y, alpha, w, mask, sigma = (torch.from_numpy(a) for a in
                                   _inputs(2, 16, 8, 0, seed=0))
    if bad == "y_shape":
        y = y[:, :8]
    elif bad == "sigma_shape":
        sigma = sigma[:1]
    else:
        x = x.double()
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        scd_pass(x, y, alpha, w, mask, 10.0, sigma)


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the wrapper IS the plain version, and launches no
    kernel."""
    args = [torch.from_numpy(a) for a in _inputs(3, 16, 8, 2, seed=9)]
    before = scd_pass.launches
    got = scd_pass(*args[:5], 7.0, args[5])
    want = scd_pass_plain(*args[:5], 7.0, args[5])
    assert scd_pass.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
