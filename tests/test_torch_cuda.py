"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on an NVIDIA GPU.  This file imports torch only (no jax),
so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips.  Tolerances are the JAX package's kernel
tolerances (tests/test_kernels.py): fp32 2e-5 with TF32 off, bf16 2e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)

# (B, KV, G, hd, ps, P, window, q_span): the JAX kernel's self-test cases,
# then the full-width h2o-danube-1.8b decode and chunk shapes
CASES = [(3, 2, 4, 32, 8, 4, 0, 1), (2, 1, 8, 64, 16, 3, 0, 1),
         (4, 2, 2, 32, 8, 8, 16, 1), (3, 2, 4, 32, 8, 4, 0, 3),
         (2, 2, 2, 32, 8, 6, 16, 4), (8, 8, 4, 80, 16, 128, 4096, 1),
         (2, 8, 4, 80, 16, 128, 4096, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(case, dtype, seed=0):
    B, KV, G, hd, ps, P, _, Q = case
    rng = np.random.default_rng(seed)
    N = B * P + 1
    lengths = rng.integers(Q, P * ps + 1, size=B).astype(np.int32)
    if Q == 1:
        lengths[rng.integers(B)] = 0  # an inactive row
    perm = rng.permutation(np.arange(1, N))
    table = np.full((B, P), -1, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = perm[used: used + n]
        used += n

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)

    return (randn(B, KV, Q * G, hd), randn(N, ps, KV, hd),
            randn(N, ps, KV, hd), torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", CASES)
def test_paged_attention_kernel_matches_plain(cuda, case, dtype, tol):
    win, Q = case[6], case[7]
    q, kp, vp, table, lengths = _inputs(case, dtype)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, table, lengths, window=win, q_span=Q)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(q, kp, vp, table, lengths, window=win,
                                 q_span=Q)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[lengths == 0].any()  # inactive rows are zeros


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_cpu_fallback(cuda):
    """A CUDA tensor never silently takes the plain path: a bad launch
    raises."""
    q, kp, vp, table, lengths = _inputs(CASES[0], torch.float32)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, table.cpu(), lengths)
