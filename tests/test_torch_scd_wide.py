"""The SCD pass at wide rows (F > 64, the wide CUDA kernel's route) on the
CPU: the port's wrapper (CPU tensors, so its plain version) and the wide
kernel's CPU twin `scd_pass_wide_plain` against the JAX package's Pallas
kernel in interpret mode and its oracle `ref.scd_pass_ref`, at the JAX
kernel test's tolerance (rtol/atol 1e-5); M not a multiple of the
kernel's block, masked tails exactly 0; every block size the launcher can
take; the CoCoA update dw_k = (v_end_k - w) / sigma_k against the JAX
solver's `_scd_pass` dw at the paper's widths (F = 128, 256); the
launcher's routing rules (`takes_blocked`, `takes_wide`, `takes_row`,
`wide_rows`); and, past the wide kernel (F > 4096, the row kernel's
route), the wrapper against the Pallas kernel and the port's CoCoA solver
against the JAX solver at F = 4100."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.cocoa import _scd_pass
from repro.data import make_svm_data
from repro.kernels import ref, scd
from repro_torch.kernels import ops as tops
from repro_torch.kernels.scd import (WIDE_BF, WIDE_MAX_F, scd_pass,
                                     scd_pass_plain, scd_pass_wide_plain,
                                     takes_blocked, takes_row, takes_wide,
                                     wide_rows)

TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_scd.py's


def _inputs(k, m, f, masked, seed):
    """The JAX kernel test's distribution (x ~ 0.3 N(0, 1): steps that
    rarely clip, so the dots matter)."""
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


@functools.lru_cache(maxsize=None)
def _jax(k, m, f, masked, seed):
    """Inputs, and the JAX Pallas kernel's (interpret mode) and oracle's
    outputs on them, once per case."""
    x, y, alpha, w, mask, sigma = _inputs(k, m, f, masked, seed)
    jargs = [jnp.asarray(a) for a in (x, y, alpha, w, mask)]
    pal = scd.scd_pass(*jargs, jnp.float32(10.0), jnp.asarray(sigma),
                       interpret=True)
    oracle = ref.scd_pass_ref(*jargs, jnp.float32(10.0), jnp.asarray(sigma))
    return (x, y, alpha, w, mask, sigma), [tuple(np.asarray(t) for t in r)
                                           for r in (pal, oracle)]


# (K, M, F, masked tail): F over the wide route's widths, K over 1, 2 and
# the path's 16, M never a multiple of the block (wide_rows(F): 32 up to
# F = 512, 8 at 1100 and 2048)
CASES = [(1, 45, 65, 3), (2, 70, 100, 5), (16, 37, 128, 4), (2, 50, 128, 1),
         (1, 33, 256, 2), (16, 41, 256, 6), (2, 21, 1100, 3),
         (16, 11, 1100, 2), (1, 13, 2048, 4), (2, 10, 2048, 1)]


@pytest.mark.parametrize("fn", ["scd_pass", "scd_pass_wide_plain"])
@pytest.mark.parametrize("case", CASES)
def test_wide_rows_match_pallas_interpret_and_ref(case, fn):
    k, m, f, masked = case
    assert takes_wide(f) and m % wide_rows(f)
    inputs, wants = _jax(k, m, f, masked, seed=m + f + k)
    args = [torch.from_numpy(a) for a in inputs]
    run = scd_pass if fn == "scd_pass" else scd_pass_wide_plain
    v, da = run(*args[:5], 10.0, args[5])
    for want_v, want_da in wants:
        np.testing.assert_allclose(v.numpy(), want_v, **TOL)
        np.testing.assert_allclose(da.numpy(), want_da, **TOL)
    assert np.all(da.numpy()[:, m - masked:] == 0.0)


@pytest.mark.parametrize("block", [4, 8, 16, 32])
def test_wide_twin_at_every_block_size(block):
    """Each block size the launcher takes (32 down to 4 as F grows), here
    at one width: the base dots, Gram terms and block-end v update give
    the sequential pass, with the last block partial."""
    k, m, f, masked = 2, 2 * block + 3, 100, 2
    inputs, wants = _jax(k, m, f, masked, seed=block)
    args = [torch.from_numpy(a) for a in inputs]
    v, da = scd_pass_wide_plain(*args[:5], 10.0, args[5], block=block)
    for want_v, want_da in wants:
        np.testing.assert_allclose(v.numpy(), want_v, **TOL)
        np.testing.assert_allclose(da.numpy(), want_da, **TOL)
    assert np.all(da.numpy()[:, m - masked:] == 0.0)


@pytest.mark.parametrize("F", [128, 256])
@pytest.mark.parametrize("K", [1, 2, 16])
def test_cocoa_update_matches_jax_scd_pass_dw_at_paper_widths(K, F):
    """dw_k = (v_end_k - w) / sigma_k from the wrapper's and the wide
    twin's outputs equals the JAX solver's `_scd_pass` dw on gathered
    workers with padded tails, at examples/cocoa_svm.py's F = 128 and the
    paper GLM's F = 256 (unit rows, lambda 1e-2, as make_svm_data)."""
    rng = np.random.default_rng(K + F)
    n, lam = 40 * K + 7, 1e-2
    X = rng.standard_normal((n, F)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.where(rng.standard_normal(n) > 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.uniform(size=n).astype(np.float32)
    w = (rng.standard_normal(F) * 0.2).astype(np.float32)
    pools = np.array_split(rng.permutation(n), K)
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
    sigma = torch.from_numpy(np.float32(n) / np.maximum(
        mask.sum(1), np.float32(1)))
    ti = torch.from_numpy(idx).long()
    tw = torch.from_numpy(w)
    args = (torch.from_numpy(X)[ti], torch.from_numpy(y)[ti],
            torch.from_numpy(alpha)[ti], tw, torch.from_numpy(mask))
    for run in (tops.scd_local_pass, scd_pass_wide_plain):
        v_end, da = run(*args, lam_n, sigma)
        dw = (v_end - tw) / sigma[:, None]
        np.testing.assert_allclose(da.numpy(), np.asarray(da_jax), **TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(dw_jax), **TOL)


def test_routing_rules():
    """The launcher's rules as the tests' copies state them: rows padded
    to a multiple of 4; F <= 64 blocked, 64 < F <= WIDE_MAX_F wide, in
    blocks of 32 halved while B F > WIDE_BF, wider rows the row kernel;
    exactly one route takes every F up to 70,000, and the paths' widths
    take the expected route."""
    assert WIDE_MAX_F == 4096 == WIDE_BF // 4
    for F in range(1, 70_001):
        Fp = -(-F // 4) * 4
        assert takes_blocked(F) == (Fp <= 64)
        assert takes_wide(F) == (64 < Fp <= WIDE_MAX_F)
        assert takes_row(F) == (Fp > WIDE_MAX_F)
        assert takes_blocked(F) + takes_wide(F) + takes_row(F) == 1
        if takes_wide(F):
            b = wide_rows(F)
            assert b in (4, 8, 16, 32) and b * Fp <= WIDE_BF
            assert b == 32 or 2 * b * Fp > WIDE_BF
    assert [wide_rows(f) for f in (65, 128, 256, 512, 516, 1100, 2000,
                                   2048, 4096)] == [32, 32, 32, 32, 16, 8,
                                                    8, 8, 4]
    assert takes_blocked(28) and takes_blocked(30) and takes_blocked(64)
    assert not takes_wide(64) and takes_wide(65) and not takes_wide(4097)
    assert not takes_row(4096) and takes_row(4097) and takes_row(65536)


def test_plain_version_is_the_cpu_path_at_wide_rows():
    """On CPU tensors the wrapper IS the plain version at wide rows too,
    and counts no launch on either route."""
    args = [torch.from_numpy(a) for a in _inputs(2, 40, 256, 3, seed=5)]
    before = (scd_pass.launches, scd_pass.launches_blocked,
              scd_pass.launches_wide, scd_pass.launches_row)
    got = scd_pass(*args[:5], 7.0, args[5])
    want = scd_pass_plain(*args[:5], 7.0, args[5])
    assert (scd_pass.launches, scd_pass.launches_blocked,
            scd_pass.launches_wide, scd_pass.launches_row) == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("F", [4097, 4100])
def test_rows_past_the_wide_kernel_match_pallas_interpret_and_ref(F):
    """Rows wider than the wide kernel takes (the row kernel's route on the
    card, which runs `scd_pass_plain`'s loop): the wrapper against the
    Pallas kernel in interpret mode and the oracle, masked tail 0."""
    assert takes_row(F)
    k, m, masked = 2, 23, 3
    inputs, wants = _jax(k, m, F, masked, seed=F)
    args = [torch.from_numpy(a) for a in inputs]
    v, da = scd_pass(*args[:5], 10.0, args[5])
    for want_v, want_da in wants:
        np.testing.assert_allclose(v.numpy(), want_v, **TOL)
        np.testing.assert_allclose(da.numpy(), want_da, **TOL)
    assert np.all(da.numpy()[:, m - masked:] == 0.0)


def test_cocoa_solver_past_the_wide_kernel_matches_jax():
    """The port's CoCoASolver (CPU: the kernels' plain versions) against
    the JAX solver at F = 4100, past the wide kernel's 4096, K = 2 over
    300 samples in 6 chunks: w, alpha, the primal (hinge) loss and the
    duality gap after each of 3 iterations at 1e-5."""
    x, y = make_svm_data(300, 4100, seed=0)
    out = {}
    for name, pkg in (("jax", J), ("torch", T)):
        store = pkg.ChunkStore({"x": x, "y": y}, chunk_size=50)
        a = pkg.Assignment(store.n_chunks, 2, np.random.default_rng(0))
        kw = {} if name == "jax" else {"device": "cpu"}
        solver = pkg.CoCoASolver(store, lam=1e-3, **kw)
        rows = []
        for _ in range(3):
            solver.step(store, a)
            w = np.asarray(solver.w, np.float64)
            loss = 5e-4 * w @ w + np.maximum(1.0 - y * (x @ w), 0.0).mean()
            rows.append((w, store.state["alpha"].copy(), loss,
                         solver.metric()))
        out[name] = rows
    for (wj, aj, lj, gj), (wt, at, lt, gt) in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(wt, wj, **TOL)
        np.testing.assert_allclose(at, aj, **TOL)
        np.testing.assert_allclose(lt, lj, **TOL)
        np.testing.assert_allclose(gt, gj, **TOL)
    assert out["torch"][-1][3] < out["torch"][0][3]  # the gap fell
