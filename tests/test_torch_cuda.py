"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on an NVIDIA GPU, the training solvers launching their
kernels, and the LM trainer's suspend/resume round trip.  This file
imports torch only (no jax), so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips.  Tolerances are the JAX package's kernel
tolerances (tests/test_kernels.py) with TF32 off: paged and flash
attention fp32 2e-5 and bf16 2e-2; SCD 1e-5; weighted merge f32 1e-5 and
bf16 3e-2.  The bf16 attention outputs are also held within one bf16 ulp
of the plain version run on the fp32-cast inputs,
|got - want| <= 2^-7 |want| + 1e-5: the TPU kernels' P.V is fp32, so a
kernel that rounded P to bf16 would miss it."""
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config, smoke_variant
from repro_torch.configs.chicle_paper import PAPER_LSGD
from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                              ElasticScalingPolicy, LocalSGDSolver, ScaleEvent,
                              UniTaskEngine)
from repro_torch.core.nets import loss_per_sample, mlp_apply, mlp_init
from repro_torch.data import (make_classification, make_lm_tokens,
                              make_svm_data)
from repro_torch.kernels import ops
from repro_torch.kernels.chunk_reduce import (weighted_merge,
                                              weighted_merge_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.launch.elastic import ElasticTrainer
from repro_torch.models import model as M
from repro_torch.kernels.paged_attention import (
    paged_attention, paged_attention_plain, paged_attention_split_plain,
    VERIFY_KEYS, route)
from repro_torch.kernels import scd as scd_mod
from repro_torch.kernels.scd import scd_pass, scd_pass_plain

# (B, KV, G, hd, ps, P, window, q_span): the JAX kernel's self-test cases,
# then the full-width h2o-danube-1.8b decode, chunk and speculative verify
# (spec_k 4: q_span 5, QG 20; bf16 on the tensor cores, fp32 on the CUDA
# cores) shapes, then grok-1-314b's (G 6, hd 128): decode (QG 6, split),
# the verify span at spec_shrink and at spec_k 4 (QG 18 and 30) and a
# 256-token chunk (QG 1536)
CASES = [(3, 2, 4, 32, 8, 4, 0, 1), (2, 1, 8, 64, 16, 3, 0, 1),
         (4, 2, 2, 32, 8, 8, 16, 1), (3, 2, 4, 32, 8, 4, 0, 3),
         (2, 2, 2, 32, 8, 6, 16, 4), (8, 8, 4, 80, 16, 128, 4096, 1),
         (2, 8, 4, 80, 16, 128, 4096, 256), (8, 8, 4, 80, 16, 128, 4096, 5),
         (8, 8, 6, 128, 16, 128, 0, 1), (8, 8, 6, 128, 16, 128, 0, 3),
         (8, 8, 6, 128, 16, 128, 0, 5), (4, 8, 6, 128, 16, 128, 0, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# head dims the tensor-core kernels are built for (the launchers' rule)
PAGED_TC_DIMS = (64, 80, 128)
FLASH_TC_DIMS = (32, 64, 80, 128)


def _tc(dtype, rows, hd, dims):
    """Whether the flash launcher's rule sends a call to its tensor-core
    kernel: bf16, at least 16 rows (flash always has them) and hd one of
    the kernel's `dims`."""
    return dtype == torch.bfloat16 and rows >= 16 and hd in dims


def _paged_counts():
    return (paged_attention.launches, paged_attention.launches_tc,
            paged_attention.launches_split, paged_attention.launches_verify)


def _counted(name):
    """The counts `_paged_counts` gains from one launch on route `name`
    ("tc", "split", "verify" or "cuda_core")."""
    return (1, name == "tc", name == "split", name == "verify")


def _after(before, name):
    return tuple(b + d for b, d in zip(before, _counted(name)))


def _one_ulp_excess(got, want):
    """max of |got - want| - (2^-7 |want| + 1e-5): <= 0 when every bf16
    element is within one ulp of the fp32 result."""
    want = want.float()
    return float(((got.float() - want).abs()
                  - (2.0 ** -7 * want.abs() + 1e-5)).max())


def _inputs(case, dtype, seed=0, lengths=None):
    B, KV, G, hd, ps, P, _, Q = case
    rng = np.random.default_rng(seed)
    N = B * P + 1
    if lengths is None:
        lengths = rng.integers(Q, P * ps + 1, size=B)
        if Q == 1:
            lengths[rng.integers(B)] = 0  # an inactive row
    lengths = np.asarray(lengths, np.int32)
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
    before = _paged_counts()
    got = paged_attention(q, kp, vp, table, lengths, window=win, q_span=Q)
    torch.cuda.synchronize()
    assert _paged_counts() == _after(before, route(dtype, Q * case[2],
                                                   case[2], case[3]))
    want = paged_attention_plain(q, kp, vp, table, lengths, window=win,
                                 q_span=Q)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[lengths == 0].any()  # inactive rows are zeros


# (B, KV, G, hd, ps, P, window, q_span) of bf16 spans of >= 16 rows (the
# tensor-core kernels: the verify route for spans of G < QG <= 32 rows,
# the chunk kernel for the rest): QG 16, 64 and 1024, hd 64, 80 and 128, a
# window that starts inside a key step, and lengths whose last page is
# ragged; then the served speculative verify span (h2o-danube-1.8b,
# spec_k 4: q_span 5, QG 20)
TC_PAGED_CASES = [(3, 2, 4, 64, 16, 8, 0, 4), (2, 2, 4, 80, 16, 16, 0, 16),
                  (2, 2, 1, 128, 16, 8, 0, 64),
                  (2, 2, 4, 64, 16, 16, 40, 16),
                  (2, 8, 4, 80, 16, 128, 4096, 256),
                  (2, 2, 8, 64, 8, 40, 0, 2),
                  (8, 8, 4, 80, 16, 128, 4096, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_PAGED_CASES)
def test_paged_attention_tensor_core_spans(cuda, case):
    """Spans of >= 16 rows in bf16 take a tensor-core kernel (the verify
    route's where the rule names it, else the chunk kernel) and match
    the plain version at 2e-2 and within one ulp of its fp32 result; an
    inactive row (length 0) gives zeros."""
    B, KV, G, hd, ps, P, win, Q = case
    rng = np.random.default_rng(sum(case))
    lengths = rng.integers(Q, P * ps + 1, size=B)
    lengths[lengths % ps == 0] += 1  # ragged last pages
    lengths = np.minimum(lengths, P * ps - 1)
    lengths[-1] = 0
    q, kp, vp, table, lens = _inputs(case, torch.bfloat16, lengths=lengths)
    before = _paged_counts()
    got = paged_attention(q, kp, vp, table, lens, window=win, q_span=Q)
    torch.cuda.synchronize()
    name = route(torch.bfloat16, Q * G, G, hd)
    assert Q * G >= 16 and name in ("tc", "verify")
    assert _paged_counts() == _after(before, name)
    want = paged_attention_plain(q, kp, vp, table, lens, window=win,
                                 q_span=Q)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    want32 = paged_attention_plain(q.float(), kp.float(), vp.float(), table,
                                   lens, window=win, q_span=Q)
    assert _one_ulp_excess(got, want32) <= 0
    assert not got[lens == 0].any()


# (B, KV, G, hd, ps, P, window, q_span), lengths: spans of <= 16 rows (the
# split route, runs of 64 keys): an inactive row, a length shorter than one
# run, exactly one run and exactly P * ps; a window whose first visible key
# falls inside a run; q_span 3 and 4; hd 128 and hd 32 with pages of 8;
# 16 rows at hd 64 (split in fp32, tensor cores in bf16); then the served
# decode shape (h2o-danube-1.8b, one inactive row); in bf16 the spans of
# G < QG <= 32 rows at hd 64, 80 or 128 take the verify route instead
SPLIT_CASES = [((4, 2, 4, 80, 16, 8, 0, 1), [0, 5, 64, 128]),
               ((3, 2, 4, 80, 16, 16, 40, 1), [200, 77, 256]),
               ((3, 2, 4, 64, 16, 8, 0, 3), [3, 70, 128]),
               ((2, 2, 4, 32, 8, 20, 24, 4), [9, 160]),
               ((2, 2, 8, 128, 16, 8, 0, 1), [100, 33]),
               ((2, 1, 16, 64, 4, 64, 0, 1), [1, 256]),
               ((8, 8, 4, 80, 16, 128, 4096, 1), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,lengths", SPLIT_CASES)
def test_paged_attention_split_route_matches_plain(cuda, case, lengths):
    """The split route against the plain version (in bf16, the route the
    rule names): fp32 at 2e-5, bf16 at 2e-2 and within one bf16 ulp of the
    plain version on the fp32-cast inputs; length-0 rows are zeros."""
    B, KV, G, hd, ps, P, win, Q = case
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, kp, vp, table, lens = _inputs(case, dtype, seed=sum(case),
                                         lengths=lengths)
        before = _paged_counts()
        got = paged_attention(q, kp, vp, table, lens, window=win, q_span=Q)
        torch.cuda.synchronize()
        name = route(dtype, Q * G, G, hd)
        assert dtype == torch.bfloat16 or name == "split"
        assert _paged_counts() == _after(before, name)
        want = paged_attention_plain(q, kp, vp, table, lens, window=win,
                                     q_span=Q)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.bfloat16:
            want32 = paged_attention_plain(q.float(), kp.float(), vp.float(),
                                           table, lens, window=win, q_span=Q)
            assert _one_ulp_excess(got, want32) <= 0
        assert not got[lens == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_split_route_is_deterministic(cuda, dtype):
    """The runs' partials are merged in run order, not in the order the
    blocks finish: two calls give bitwise-equal outputs."""
    case = (8, 8, 4, 80, 16, 128, 4096, 1)
    q, kp, vp, table, lengths = _inputs(case, dtype, seed=5)
    before = paged_attention.launches_split
    outs = [paged_attention(q, kp, vp, table, lengths, window=4096)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert paged_attention.launches_split == before + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_paged_attention_decode_takes_the_split_route(cuda):
    """Decode (G rows) and other spans of at most 16 rows that the
    tensor-core kernels do not take (fp32; bf16 at a head dim they are not
    built for) take the split route, never the tensor cores; fp32 spans of
    more than 16 rows, and bf16 ones at such a head dim, keep the CUDA-core
    kernel."""
    for case, dtype, name in (
            ((8, 8, 4, 80, 16, 128, 4096, 1), torch.bfloat16, "split"),
            ((8, 8, 4, 80, 16, 128, 4096, 1), torch.float32, "split"),
            ((2, 2, 4, 64, 16, 8, 0, 4), torch.float32, "split"),
            ((2, 2, 4, 32, 16, 8, 0, 4), torch.bfloat16, "split"),
            ((2, 2, 4, 64, 16, 8, 0, 8), torch.float32, "cuda_core"),
            ((2, 2, 4, 32, 16, 8, 0, 8), torch.bfloat16, "cuda_core")):
        q, kp, vp, table, lengths = _inputs(case, dtype)
        before = _paged_counts()
        paged_attention(q, kp, vp, table, lengths, window=case[6],
                        q_span=case[7])
        torch.cuda.synchronize()
        assert _paged_counts() == _after(before, name)


# (B, KV, G, hd, ps, P, window, q_span), lengths: bf16 spans of G < QG <=
# 32 rows (the verify route: runs of 512 keys in stages of 128): the four
# served verify spans (h2o-danube-1.8b's q_span 5 and 3, grok-1-314b's
# heads, G 6, hd 128, at q_span 5 and 3); an inactive row, a length
# shorter than one stage, exactly one run and exactly P * ps; windows
# whose first visible key falls inside a run; QG 32 at hd 64 and 128;
# q_span 2
VERIFY_CASES = [((8, 8, 4, 80, 16, 128, 4096, 5), None),
                ((8, 8, 4, 80, 16, 128, 4096, 3), None),
                ((8, 8, 6, 128, 16, 128, 0, 5), None),
                ((8, 8, 6, 128, 16, 128, 0, 3), None),
                ((4, 2, 4, 80, 16, 64, 0, 5), [0, 7, 512, 1024]),
                ((3, 2, 4, 80, 16, 40, 300, 2), [640, 333, 257]),
                ((3, 2, 8, 64, 16, 24, 0, 4), [384, 4, 200]),
                ((2, 2, 16, 128, 16, 40, 0, 2), [129, 640]),
                ((3, 2, 6, 128, 16, 64, 100, 3), [0, 700, 512])]


@pytest.mark.cuda
@pytest.mark.parametrize("case,lengths", VERIFY_CASES)
def test_paged_attention_verify_route_matches_plain(cuda, case, lengths):
    """bf16 spans of G < QG <= 32 rows take the verify route and match the
    plain version at 2e-2, within one bf16 ulp of its result on the
    fp32-cast inputs, and the route's arithmetic in fp32
    (`paged_attention_split_plain` at its run length) at 2e-2; length-0
    rows are zeros."""
    B, KV, G, hd, ps, P, win, Q = case
    q, kp, vp, table, lens = _inputs(case, torch.bfloat16, seed=sum(case),
                                     lengths=lengths)
    before = _paged_counts()
    got = paged_attention(q, kp, vp, table, lens, window=win, q_span=Q)
    torch.cuda.synchronize()
    assert route(torch.bfloat16, Q * G, G, hd) == "verify"
    assert _paged_counts() == _after(before, "verify")
    want = paged_attention_plain(q, kp, vp, table, lens, window=win,
                                 q_span=Q)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    f32 = (q.float(), kp.float(), vp.float(), table, lens)
    want32 = paged_attention_plain(*f32, window=win, q_span=Q)
    assert _one_ulp_excess(got, want32) <= 0
    runs = paged_attention_split_plain(*f32, window=win, q_span=Q,
                                       split_keys=VERIFY_KEYS)
    torch.testing.assert_close(got.float(), runs, rtol=2e-2, atol=2e-2)
    assert not got[lens == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [VERIFY_CASES[0][0], VERIFY_CASES[2][0]])
def test_paged_attention_verify_route_is_deterministic(cuda, case):
    """The runs' partials are merged in run order, not in the order the
    blocks finish: two calls give bitwise-equal outputs."""
    q, kp, vp, table, lengths = _inputs(case, torch.bfloat16, seed=5)
    before = paged_attention.launches_verify
    outs = [paged_attention(q, kp, vp, table, lengths, window=case[6],
                            q_span=case[7]) for _ in range(3)]
    torch.cuda.synchronize()
    assert paged_attention.launches_verify == before + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_paged_attention_verify_route_takes_only_verify_spans(cuda):
    """The verify route takes bf16 spans of two or more positions up to 32
    rows; decode (QG = G) keeps the split route, 256-token chunks and
    spans over 32 rows the chunk kernel, fp32 spans their fp32 routes, and
    bf16 spans at a head dim the tensor-core kernels are not built for
    the split or CUDA-core kernel."""
    for case, dtype, name in (
            ((8, 8, 4, 80, 16, 128, 4096, 5), torch.bfloat16, "verify"),
            ((8, 8, 4, 80, 16, 128, 4096, 1), torch.bfloat16, "split"),
            ((2, 2, 16, 64, 16, 8, 0, 1), torch.bfloat16, "tc"),
            ((2, 8, 4, 80, 16, 128, 4096, 256), torch.bfloat16, "tc"),
            ((2, 2, 4, 64, 16, 16, 0, 9), torch.bfloat16, "tc"),
            ((8, 8, 4, 80, 16, 128, 4096, 5), torch.float32, "cuda_core"),
            ((8, 8, 4, 80, 16, 128, 4096, 3), torch.float32, "split"),
            ((2, 2, 4, 32, 16, 8, 0, 3), torch.bfloat16, "split"),
            ((2, 2, 4, 32, 16, 8, 0, 5), torch.bfloat16, "cuda_core")):
        q, kp, vp, table, lengths = _inputs(case, dtype)
        before = _paged_counts()
        paged_attention(q, kp, vp, table, lengths, window=case[6],
                        q_span=case[7])
        torch.cuda.synchronize()
        assert route(dtype, case[7] * case[2], case[2], case[3]) == name
        assert _paged_counts() == _after(before, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case,name", [(VERIFY_CASES[1][0], "split"),
                                       (VERIFY_CASES[0][0], "cuda_core")])
def test_paged_attention_unaligned_q_leaves_the_verify_route(cuda, case,
                                                             name):
    """A bf16 verify span whose q is not 16-byte aligned leaves the verify
    and tensor-core kernels: 12 rows take the split route (the wrapper
    sizes the workspace for it), 20 the CUDA-core kernel; both match the
    plain version at 2e-2."""
    B, KV, G, hd, ps, P, win, Q = case
    q, kp, vp, table, lens = _inputs(case, torch.bfloat16, seed=3)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device="cuda")
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    before = _paged_counts()
    got = paged_attention(q_off, kp, vp, table, lens, window=win, q_span=Q)
    torch.cuda.synchronize()
    assert _paged_counts() == _after(before, name)
    want = paged_attention_plain(q, kp, vp, table, lens, window=win,
                                 q_span=Q)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_paged_attention_split_route_refuses_misaligned_pools(cuda):
    """Pools whose base is not 16-byte aligned (the route's cp.async
    gathers) raise; a CUDA tensor never takes the plain version."""
    q, kp, vp, table, lengths = _inputs(CASES[0], torch.float32)
    flat = torch.zeros(kp.numel() + 1, device="cuda")
    kp_off = flat[1:].view(kp.shape)
    kp_off.copy_(kp)
    before = _paged_counts()
    with pytest.raises(ValueError):
        paged_attention(q, kp_off, vp, table, lengths)
    assert _paged_counts() == before


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_cpu_fallback(cuda):
    """A CUDA tensor never silently takes the plain path: a bad launch
    raises."""
    q, kp, vp, table, lengths = _inputs(CASES[0], torch.float32)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, table.cpu(), lengths)


# (K, M, F, masked tail, lam*n, x offset bytes): the JAX SCD test's
# shapes, the CoCoA path's widths (F=28 at HIGGS's lambda*n; the paper's
# F=128 and 256), widths past the wide kernel's 32-row blocks (F=1024: 16
# rows, 1100 and 2048: 8, 4096, its widest: 4), F not a multiple of 32 or
# of 4 (padded with zero columns), then a long chain at the path's width
# and lambda*n (the blocked kernel's base dots and Gram terms round
# differently from a direct dot: held over 32,768 steps), the row kernel's
# widths (F > 4096: v in shared memory, and at F = 65,536 in the worker's
# v_out row), M not a multiple
# of the block, the blocked kernel's widest instantiation (F=64), and x
# views 4 bytes past 16-byte alignment, which TMA cannot stage (copied
# into an aligned buffer by the wrapper)
SCD_CASES = [(1, 16, 8, 0, 10.0, 0), (3, 64, 32, 5, 10.0, 0),
             (4, 64, 8, 2, 10.0, 0), (16, 512, 28, 7, 11000.0, 0),
             (16, 256, 256, 0, 11000.0, 0), (16, 300, 128, 5, 11000.0, 0),
             (2, 64, 1024, 3, 100.0, 0), (2, 70, 1100, 3, 100.0, 0),
             (2, 45, 2048, 2, 100.0, 0), (1, 21, 4096, 2, 100.0, 0),
             (2, 96, 100, 1, 100.0, 0), (2, 77, 65, 4, 100.0, 0),
             (2, 32_768, 28, 0, 11000.0, 0), (3, 1001, 28, 9, 11000.0, 0),
             (2, 200, 64, 4, 100.0, 0), (2, 200, 30, 3, 100.0, 0),
             (3, 1001, 28, 9, 11000.0, 4), (2, 200, 64, 4, 100.0, 4),
             (2, 301, 256, 9, 11000.0, 4), (2, 99, 66, 3, 100.0, 0),
             (1, 64, 4097, 3, 100.0, 0), (2, 200, 4100, 5, 11000.0, 0),
             (2, 256, 8192, 0, 100.0, 0), (2, 128, 65536, 4, 11000.0, 0),
             (2, 100, 4100, 2, 100.0, 4)]


def _scd_inputs(K, M, F, masked, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, M, F)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.where(rng.standard_normal((K, M)) > 0, 1.0, -1.0).astype(
        np.float32)
    alpha = rng.uniform(size=(K, M)).astype(np.float32)
    w = (rng.standard_normal(F) * 0.1).astype(np.float32)
    mask = np.ones((K, M), np.float32)
    if masked:
        mask[:, M - masked:] = 0.0
    sigma = np.full(K, float(K), np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, y, alpha, w, mask,
                                                 sigma)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCD_CASES)
def test_scd_kernel_matches_plain(cuda, case):
    K, M, F, masked, lam_n, offset = case
    x, y, alpha, w, mask, sigma = _scd_inputs(K, M, F, masked)
    if offset:  # the same rows in a contiguous view at base + offset
        flat = torch.empty(x.numel() + offset // 4, device="cuda")
        flat[offset // 4:] = x.flatten()
        x = flat[offset // 4:].view(K, M, F)
        assert x.data_ptr() % 16 == offset
    before = (scd_pass.launches, scd_pass.launches_blocked,
              scd_pass.launches_wide, scd_pass.launches_row)
    v, da = scd_pass(x, y, alpha, w, mask, lam_n, sigma)
    torch.cuda.synchronize()
    # every launch takes the kernel the launcher's rule names
    assert (scd_pass.launches, scd_pass.launches_blocked,
            scd_pass.launches_wide, scd_pass.launches_row) == (
        before[0] + 1, before[1] + scd_mod.takes_blocked(F),
        before[2] + scd_mod.takes_wide(F), before[3] + scd_mod.takes_row(F))
    v_want, da_want = scd_pass_plain(x, y, alpha, w, mask, lam_n, sigma)
    torch.testing.assert_close(v, v_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(da, da_want, rtol=1e-5, atol=1e-5)
    if masked:
        assert not da[:, M - masked:].any()  # masked rows: exactly 0


@pytest.mark.cuda
def test_scd_row_kernel_matches_plain_past_the_wide_kernel(cuda):
    """Past the wide kernel's limit (blocks of 4 rows of F floats, three
    to a ring in shared memory) rows of F > 4096 take the row kernel and
    match the plain version at 1e-5, v in shared memory up to F = 57,856
    and in the worker's v_out row past it (F = 60,000)."""
    for K, M, F in ((1, 4, 4097), (2, 90, 60_000)):
        x, y, alpha, w, mask, sigma = _scd_inputs(K, M, F, 1)
        before = scd_pass.launches_row
        v, da = scd_pass(x, y, alpha, w, mask, 10.0, sigma)
        torch.cuda.synchronize()
        assert scd_pass.launches_row == before + 1
        v_want, da_want = scd_pass_plain(x, y, alpha, w, mask, 10.0, sigma)
        torch.testing.assert_close(v, v_want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(da, da_want, rtol=1e-5, atol=1e-5)
        assert not da[:, -1].any()


# every row-alignment class of the kernel: N = 1, 2, 3 (mod 4) and, for
# bf16, N = 4 (mod 8) (4,100), at K around the 16/8/4/2/1-row chunks up to
# the path's K = 16; then K > 16
MERGE_NS = (5001, 5002, 5003, 276_266, 276_267, 4_100)
MERGE_CASES = sorted(
    {(K, N) for K in (1, 5, 16) for N in (1, 7, 5001, 276_266)}
    | {(K, N) for K in (1, 7, 8, 9, 16) for N in MERGE_NS})
MERGE_WIDE_CASES = [(K, N) for K in (17, 64, 1024) for N in MERGE_NS]


def _merge_launch(K, N, dtype):
    gen = torch.Generator(device="cuda").manual_seed(K * N)
    u = torch.randn(K, N, device="cuda", generator=gen).to(dtype)
    w = torch.rand(K, device="cuda", generator=gen)
    before = weighted_merge.launches
    got = weighted_merge(u, w)
    torch.cuda.synchronize()
    assert weighted_merge.launches == before + 1
    assert got.dtype == dtype and got.shape == (N,)
    return u, w, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("K,N", MERGE_CASES)
def test_weighted_merge_kernel_matches_plain(cuda, K, N, dtype, tol):
    u, w, got = _merge_launch(K, N, dtype)
    torch.testing.assert_close(got.float(),
                               weighted_merge_plain(u, w).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("K,N", MERGE_WIDE_CASES)
def test_weighted_merge_kernel_matches_exact_sum_beyond_16_rows(
        cuda, K, N, dtype, tol):
    """K > 16 (no training path merges that many): held to the sum taken
    in fp64, i.e. exactly, because at K = 1024 an fp32 sum in any order
    (the plain version's own cuBLAS one included) is off by more than 1e-5
    near zero crossings."""
    u, w, got = _merge_launch(K, N, dtype)
    torch.testing.assert_close(got.double(),
                               torch.einsum("k,kn->n", w.double(),
                                            u.double()),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_weighted_merge_kernel_on_misaligned_rows(cuda):
    """A (K, N) view whose base is not 16-byte aligned takes the element
    path on every row and still matches."""
    K, N = 4, 1001
    flat = torch.randn(K * N + 1, device="cuda")
    u = flat[1:].view(K, N)  # contiguous, base 4 bytes past alignment
    w = torch.rand(K, device="cuda")
    torch.testing.assert_close(weighted_merge(u, w),
                               weighted_merge_plain(u, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_training_solvers_launch_their_kernels_every_iteration(cuda):
    """CoCoA and local SGD on the card launch the SCD and merge kernels
    once per iteration and land where the same runs on the CPU land
    (tolerance 1e-4: card and CPU sum in different orders)."""
    x, y = make_svm_data(2000, 16, seed=3)
    res = {}
    for dev in ("cuda", "cpu"):
        store = ChunkStore({"x": x, "y": y}, chunk_size=50)
        a = Assignment(store.n_chunks, 4, np.random.default_rng(0))
        solver = CoCoASolver(store, lam=1e-3, device=dev)
        eng = UniTaskEngine(store, a, [], balance_processing=False)
        before = scd_pass.launches
        hist = eng.run(3, solver.step, solver.metric)
        res[dev] = (scd_pass.launches - before, solver.w.cpu(),
                    [h.metric for h in hist])
    assert res["cuda"][0] == 3 and res["cpu"][0] == 0
    torch.testing.assert_close(res["cuda"][1], res["cpu"][1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res["cuda"][2], res["cpu"][2], rtol=1e-4)

    xs, ys = make_classification(512, 16, 4, seed=0)
    tc = dataclasses.replace(PAPER_LSGD, local_steps=4, learning_rate=0.01)
    p0 = mlp_init(torch.Generator().manual_seed(0), 16, 4)
    res = {}
    for dev in ("cuda", "cpu"):
        store = ChunkStore({"x": xs, "y": ys}, chunk_size=32)
        a = Assignment(store.n_chunks, 4, np.random.default_rng(0))
        solver = LocalSGDSolver(p0, mlp_apply, loss_per_sample, tc,
                                eval_data=xs, eval_labels=ys, seed=7,
                                device=dev)
        eng = UniTaskEngine(store, a, [])
        data = torch.from_numpy(xs).to(dev)
        labels = torch.from_numpy(ys).to(dev)
        before = weighted_merge.launches
        eng.run(3, lambda s, asg, sh: solver.step(s, asg, data, labels, sh),
                solver.metric)
        res[dev] = (weighted_merge.launches - before,
                    {k: v.cpu() for k, v in solver.params.items()})
    assert res["cuda"][0] == 3 and res["cpu"][0] == 0
    for k, v in res["cpu"][1].items():
        torch.testing.assert_close(res["cuda"][1][k], v, rtol=1e-4,
                                   atol=1e-4)


COCOA_FIXTURE = (Path(__file__).resolve().parent / "data"
                 / "cocoa_history_f28.json")


@pytest.mark.cuda
def test_cocoa_gap_history_on_the_card_holds_the_jax_fixture(cuda):
    """The port's CoCoA on the card, every pass through the blocked SCD
    kernel (F=28), against the JAX package's gap history on the CPU at the
    same shape and schedule (the fixture, written by
    tests/test_torch_cocoa_history.py): equal K trajectory, and each gap
    within 1e-3 relative plus 1e-6 absolute (the gap is the difference of
    two fp32 values of ~0.69, known to a few of their 6e-8 ulps; the CPU
    port differs by at most 4 ulps).  The worst difference is printed."""
    obj = json.loads(COCOA_FIXTURE.read_text())
    c, want = obj["shape"], obj["history"]
    x, y = make_svm_data(c["n"], c["features"], seed=c["seed"])
    store = ChunkStore({"x": x, "y": y}, chunk_size=c["chunk_size"])
    a = Assignment(store.n_chunks, c["k0"], np.random.default_rng(0))
    solver = CoCoASolver(store, lam=c["lam"], device="cuda")
    unit = c["n"] // c["k0"]
    pol = ElasticScalingPolicy([ScaleEvent(2 * i * unit, max(c["k0"] - 2 * i,
                                                              2))
                                for i in range(c["k0"] // 2)])
    eng = UniTaskEngine(store, a, [pol], balance_processing=False)
    before = scd_pass.launches, scd_pass.launches_blocked
    hist = eng.run(c["iters"], solver.step, solver.metric)
    assert (scd_pass.launches - before[0],
            scd_pass.launches_blocked - before[1]) == (c["iters"],) * 2
    assert [h.n_workers for h in hist] == [k for k, _ in want]
    diff = [abs(h.metric - g) for h, (_, g) in zip(hist, want)]
    print(f"cocoa gap history vs the JAX fixture: max abs diff "
          f"{max(diff):.3e}, per iteration {[f'{d:.1e}' for d in diff]}")
    for d, (_, g) in zip(diff, want):
        assert d <= 1e-3 * abs(g) + 1e-6


# (B, S, KV, G, hd, window, causal): tests/test_kernels.py's flash cases,
# h2o-danube-1.8b's head geometry (G=4, hd=80) at windows 0, 1024 and 4096,
# a bidirectional windowed case, a tile of 8 rows (fewer than the
# CUDA-core kernel's 16 thread-rows), and hd 40 (bf16 on the CUDA cores:
# not a multiple of 16)
FLASH_CASES = [(2, 128, 2, 2, 64, 0, True), (1, 256, 1, 4, 32, 0, True),
               (2, 128, 3, 1, 64, 32, True), (1, 128, 2, 1, 64, 0, False),
               (1, 128, 2, 2, 64, 64, True), (1, 2048, 8, 4, 80, 0, True),
               (1, 2048, 8, 4, 80, 1024, True),
               (1, 4096, 8, 4, 80, 4096, True),
               (1, 512, 2, 4, 80, 100, False), (2, 8, 2, 1, 32, 0, True),
               (1, 256, 2, 4, 40, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol):
    B, S, KV, G, hd, win, causal = case
    gen = torch.Generator(device="cuda").manual_seed(S + G)
    q = torch.randn(B * KV * G, S, hd, device="cuda", generator=gen)
    k = torch.randn(B * KV, S, hd, device="cuda", generator=gen)
    v = torch.randn(B * KV, S, hd, device="cuda", generator=gen)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = flash_attention.launches, flash_attention.launches_tc
    got = flash_attention(q, k, v, causal=causal, window=win, block_q=64,
                          block_k=64, group_size=G)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_tc) == (
        before[0] + 1, before[1] + _tc(dtype, 16, hd, FLASH_TC_DIMS))
    assert got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=win,
                                 group_size=G)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, S, KV, G, hd, window, causal) for the tensor-core kernel: hd 64 and
# 128 at G 1 and 8, S shorter than one block's 128 rows (16 positions at
# G 1, 8 at G 4), windows that start inside a key step, bidirectional
TC_FLASH_CASES = [(2, 256, 2, 1, 64, 0, True), (1, 256, 2, 8, 64, 0, True),
                  (2, 256, 2, 1, 128, 0, True),
                  (1, 256, 2, 8, 128, 0, True), (2, 16, 2, 1, 80, 0, True),
                  (2, 8, 3, 4, 64, 0, False), (1, 640, 2, 4, 80, 100, True),
                  (1, 384, 2, 8, 64, 37, True),
                  (1, 384, 2, 2, 128, 70, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_FLASH_CASES)
def test_flash_attention_tensor_core_kernel(cuda, case):
    """bf16 with hd a multiple of 16 takes the tensor-core kernel and
    matches the plain version at 2e-2 and within one ulp of its fp32
    result."""
    B, S, KV, G, hd, win, causal = case
    gen = torch.Generator(device="cuda").manual_seed(S * G + hd)
    q, k, v = (torch.randn(n, S, hd, device="cuda", generator=gen).to(
        torch.bfloat16) for n in (B * KV * G, B * KV, B * KV))
    before = flash_attention.launches, flash_attention.launches_tc
    got = flash_attention(q, k, v, causal=causal, window=win, block_q=S,
                          block_k=S, group_size=G)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_tc) == (
        before[0] + 1, before[1] + 1)
    kw = dict(causal=causal, window=win, group_size=G)
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, **kw).float(),
        rtol=2e-2, atol=2e-2)
    want32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert _one_ulp_excess(got, want32) <= 0


@pytest.mark.cuda
def test_bf16_attention_within_one_ulp_at_the_path_shapes(cuda):
    """The two tensor-core paths at the main path's shapes: flash at
    h2o-danube-1.8b's B=4, S=4096, KV=8, G=4, hd=80, causal, window 4096;
    paged at its 256-token prefill chunk (B=4, QG=1024) over 4352 live
    tokens.  Every bf16 element within one ulp of the fp32 result."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, KV, G, hd = 4, 4096, 8, 4, 80
    q, k, v = (torch.randn(n, S, hd, device="cuda", generator=gen).to(
        torch.bfloat16) for n in (B * KV * G, B * KV, B * KV))
    before = flash_attention.launches_tc
    got = flash_attention(q, k, v, causal=True, window=4096, group_size=G)
    torch.cuda.synchronize()
    assert flash_attention.launches_tc == before + 1
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                 window=4096, group_size=G)
    assert _one_ulp_excess(got, want) <= 0
    del q, k, v, got, want
    case = (4, 8, 4, 80, 16, 128, 4096, 256)
    q, kp, vp, table, lengths = _inputs(
        case, torch.bfloat16, lengths=[512, 1280, 1024, 1536])
    before = paged_attention.launches_tc
    got = paged_attention(q, kp, vp, table, lengths, window=4096, q_span=256)
    torch.cuda.synchronize()
    assert paged_attention.launches_tc == before + 1
    want = paged_attention_plain(q.float(), kp.float(), vp.float(), table,
                                 lengths, window=4096, q_span=256)
    assert _one_ulp_excess(got, want) <= 0


@pytest.mark.cuda
def test_flash_model_layout_wrapper_on_the_card(cuda):
    B, S, KV, G, hd = 2, 128, 2, 3, 32
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, KV, G, hd, device="cuda", generator=gen)
    k = torch.randn(B, S, KV, hd, device="cuda", generator=gen)
    v = torch.randn(B, S, KV, hd, device="cuda", generator=gen)
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                               block_q=64, block_k=64)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


# (B, S, KV, G, hd, window, causal) for the flash backward: h2o-danube's
# heads (G 4, hd 80) at one tile (S 128), with its window of 4096 and with
# a window shorter than S, G 1 and G 8, hd 128 bidirectional with a window,
# grok-1's G 6 (tiles of 21 positions, 126 rows) and hd 32
BWD_CASES = [(1, 128, 2, 4, 80, 0, True), (2, 512, 2, 4, 80, 4096, True),
             (1, 512, 2, 4, 80, 100, True), (2, 256, 2, 1, 64, 0, True),
             (1, 256, 2, 8, 64, 0, True), (1, 384, 2, 2, 128, 70, False),
             (1, 256, 2, 6, 128, 0, True), (1, 256, 1, 4, 32, 0, True)]


def _bwd_inputs(case, seed):
    """bf16 q, k, v, the tensor-core forward's output and log-sum-exp, and
    an output gradient, on the card."""
    B, S, KV, G, hd, win, causal = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(n, S, hd, device="cuda", generator=gen).to(
        torch.bfloat16) for n in (B * KV * G, B * KV, B * KV, B * KV * G))
    out, lse = flash_attention(q, k, v, causal=causal, window=win,
                               group_size=G, return_lse=True)
    return q, k, v, out, lse, do, dict(causal=causal, window=win,
                                       group_size=G)


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, case):
    """The backward kernel against its plain version on the fp32-cast
    inputs: dq, dk and dv within 2^-7 of their largest element (bf16
    outputs hold 2^-8; P enters dV in bf16, as the blocked path's does),
    and the forward's log-sum-exp within 1e-4 of the plain scores'."""
    q, k, v, out, lse, do, kw = _bwd_inputs(case, sum(case[:5]))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    _, want_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                        return_lse=True, **kw)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     out.float(), want_lse, do.float(), **kw)
    for name, g, w, ref in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape
        err = _rel_err(g, w)
        print(f"{case} d{name}: max abs err / max abs {err:.2e}")
        assert err <= 2.0 ** -7, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[6]])
def test_flash_attention_bwd_kernel_is_deterministic(cuda, case):
    """Two calls on the same inputs give bit-equal gradients (no float
    atomics: every output element is summed by one thread in one order)."""
    q, k, v, out, lse, do, kw = _bwd_inputs(case, 3)
    a = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    b = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_attention_bwd_at_the_cell_shape(cuda):
    """h2o-danube-1.8b's training shape, B=12, S=4096, KV=8, G=4, hd=80,
    causal, window 4096: the kernel against its plain version, one batch
    row at a time for the plain version's memory."""
    B, S, KV, G, hd = 12, 4096, 8, 4, 80
    q, k, v, out, lse, do, kw = _bwd_inputs((B, S, KV, G, hd, 4096, True), 9)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for b in (0, B - 1):
        qs, ks = slice(b * KV * G, (b + 1) * KV * G), slice(b * KV,
                                                            (b + 1) * KV)
        want = flash_attention_bwd_plain(
            q[qs].float(), k[ks].float(), v[ks].float(), out[qs].float(),
            lse[qs], do[qs].float(), **kw)
        for name, g, w in zip("qkv", (got[0][qs], got[1][ks], got[2][ks]),
                              want):
            err = _rel_err(g, w)
            print(f"row {b} d{name}: max abs err / max abs {err:.2e}")
            assert err <= 2.0 ** -7, (name, err)
        del want
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [("h2o-danube-1.8b", 0),
                                         ("h2o-danube-1.8b", 100),
                                         ("grok-1-314b", 0)])
def test_blocked_attention_flash_route_matches_the_blocked_path(
        cuda, arch, window):
    """blocked_attention on bf16 CUDA inputs takes the flash route (one
    forward on the tensor cores, one backward launch) and its output and
    gradients match the query-blocked path's in bf16 within 2^-6 of each
    one's largest element: the two paths round differently (the blocked
    path's P is bf16 before P.V and its dP is a bf16 product)."""
    from repro_torch.models import attention as attn
    cfg = get_config(arch)
    kind, hp, g_pad = attn.head_layout(cfg)
    assert kind == "grouped"
    B, S, KV, hd = 2, 256, cfg.kv_heads(), cfg.head_dim_()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(B, S, n, hd, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_() for n in (hp, KV, KV))
    do = torch.randn(B, S, hp, hd, device="cuda", generator=gen).to(
        torch.bfloat16)
    n0 = (flash_attention.launches_tc, flash_attention_bwd.launches)
    got = attn.blocked_attention(cfg, q, k, v, window=window)
    g_got = torch.autograd.grad(got, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches_tc, flash_attention_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = attn._blocked_attention(cfg, q, k, v, causal=True, window=window,
                                   q_block=128)
    g_want = torch.autograd.grad(want, (q, k, v), do)
    assert (flash_attention.launches_tc, flash_attention_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got, *g_got),
                          (want, *g_want)):
        err = _rel_err(g, w)
        print(f"{arch} window {window} {name}: max abs err / max abs "
              f"{err:.2e}")
        assert err <= 2.0 ** -6, (name, err)


@pytest.mark.cuda
def test_flash_route_keeps_fp32_on_the_blocked_path(cuda):
    """fp32 on the card stays on the query-blocked path: no flash launch."""
    from repro_torch.models import attention as attn
    cfg = get_config("h2o-danube-1.8b")
    _, hp, _ = attn.head_layout(cfg)
    q = torch.randn(1, 128, hp, 80, device="cuda", requires_grad=True)
    k = torch.randn(1, 128, 8, 80, device="cuda")
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    out = attn.blocked_attention(cfg, q, k, k, window=4096)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0


@pytest.mark.cuda
def test_elastic_trainer_round_trip_on_the_card(cuda):
    """suspend() parks the state on the host and resume() brings it back
    to the card bit for bit; training goes on with finite losses."""
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    trainer = ElasticTrainer(cfg, TrainConfig(learning_rate=5e-3))
    assert trainer.params.embed.device.type == "cuda" and trainer.k == 1
    data = make_lm_tokens(16, 64, cfg.vocab_size, seed=0)
    batch = {"tokens": data["tokens"][:4], "labels": data["labels"][:4],
             "weights": np.ones(4, np.float32)}
    losses = [trainer.train_step(batch)["loss"] for _ in range(2)]
    before = {k: v.detach().clone()
              for k, v in M.param_dict(trainer.params).items()}
    mu = {k: v.clone() for k, v in trainer.opt_state.mu.items()}
    trainer.suspend()
    assert trainer.params.embed.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in trainer.opt_state.mu.values())
    trainer.resume(1)
    for k, v in M.param_dict(trainer.params).items():
        assert v.device.type == "cuda" and torch.equal(v, before[k]), k
    for k, v in trainer.opt_state.mu.items():
        assert torch.equal(v, mu[k]), k
    losses.append(trainer.train_step(batch)["loss"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _grouped_small(dtype):
    """h2o-danube-1.8b's head geometry (32 heads over 8 KV heads, G 4) at
    2 layers and d_model 256 (so hd 8): small, and its verify spans are
    q_span x 4 rows, as at full width."""
    return dataclasses.replace(
        get_config("h2o-danube-1.8b"), num_layers=2, d_model=256,
        d_ff=512, vocab_size=512, dtype=dtype)


def _serve_burst(vocab, n=6, seed=3):
    from repro_torch.serve import synthetic_requests
    return synthetic_requests(n, vocab_size=vocab, arrivals=np.zeros(n),
                              prompt_len=(20, 70), max_new_tokens=(6, 12),
                              rng=np.random.default_rng(seed))


SERVE_KW = dict(capacity=4, cache_len=128, prefill_bucket=16, page_size=16,
                prefill_chunk=32, kv_layout="paged", paged_impl="kernel",
                seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, arch):
    """fp32 (TF32 off): the moe FFN's routing (the token in every expert
    slot) is the CPU's, at the config's capacity factor and at one that
    drops assignments, and its output and aux loss agree at 1e-5."""
    from repro_torch.models import moe
    cfg = smoke_variant(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params.layers()[0]["moe"]
    pc = {k: v.cuda() for k, v in p.items()}
    x = torch.randn(4, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    for c in (cfg, dataclasses.replace(cfg, moe_capacity_factor=0.5)):
        want, want_aux = moe.moe_ffn(c, p, x)
        got, aux = moe.moe_ffn(c, pc, x.cuda())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5,
                                   atol=1e-5)
        cap = moe.capacity(c, 128)
        buf = moe.route(c, p, x.reshape(128, -1), cap)[0]
        assert torch.equal(
            moe.route(c, pc, x.cuda().reshape(128, -1), cap)[0].cpu(),
            buf)
        if c is not cfg:
            assert int((buf >= 0).sum()) < 128 * cfg.experts_per_token


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_engine_on_the_card_matches_the_cpu(cuda, arch):
    """fp32: the moe smoke variants served through the kernel on the card
    give the streams of the same engine on the CPU (a moe row's output
    depends on its whole call, so this holds the card's routing of every
    dispatch, padding and free slots included, to the CPU's)."""
    from repro_torch.serve import ServeEngine
    cfg = smoke_variant(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(SERVE_KW, capacity=8)
    want = ServeEngine(cfg, params=params, device="cpu", **kw).run(
        _serve_burst(cfg.vocab_size, n=8))
    before = paged_attention.launches
    got = ServeEngine(cfg, params=params.to("cuda"), **kw).run(
        _serve_burst(cfg.vocab_size, n=8))
    assert paged_attention.launches > before
    assert {r.rid: r.generated for r in got.requests} == \
        {r.rid: r.generated for r in want.requests}


@pytest.mark.cuda
def test_crash_recovery_on_the_card_matches_the_fault_free_run(cuda):
    """fp32 (TF32 off): a crash while prompts are mid-chunked-prefill and a
    crash mid-decode restart their requests from the prompt; every stream
    equals the fault-free run on the card, through the kernel."""
    from repro_torch.faults import FaultInjector, FaultPlan, worker_crash
    from repro_torch.serve import ServeEngine
    cfg = _grouped_small("float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    want = ServeEngine(cfg, params=params, **SERVE_KW).run(
        _serve_burst(cfg.vocab_size))
    inj = FaultInjector(FaultPlan([worker_crash(1), worker_crash(6)]))
    eng = ServeEngine(cfg, params=params, n_workers=2, fault_injector=inj,
                      debug_checks=True, **SERVE_KW)
    before = paged_attention.launches
    got = eng.run(_serve_burst(cfg.vocab_size))
    assert paged_attention.launches > before
    s = got.summarize()
    assert (s["crashes_total"], s["recoveries"], s["shed_requests"]) == \
        (2, 2, 0)
    assert {r.rid: r.generated for r in got.requests} == \
        {r.rid: r.generated for r in want.requests}


@pytest.mark.cuda
def test_brownout_spec_shrink_verifies_12_rows_on_the_split_route(cuda):
    """bf16 at the ladder's spec_shrink level (spec_k 4 halved to 2): every
    verify span is q_span 3 x G 4 = 12 rows, under the tensor-core
    kernel's 16 and at a head dim (8) the verify route does not take, so
    the launcher sends it to the split route; the streams equal an engine
    configured with spec_k 2 from the start."""
    from repro_torch.serve import DegradationLadder, ServeEngine
    import repro_torch.kernels.paged_attention as paged_mod

    class Pinned(DegradationLadder):
        def update(self, attainment, queue_depth, capacity):
            self.level = 1
            return 1

    cfg = _grouped_small("bfloat16")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    want = ServeEngine(cfg, params=params, spec="ngram", spec_k=2,
                       **SERVE_KW).run(_serve_burst(cfg.vocab_size))
    real, log = paged_mod._launch, []

    def recorded(q, *args):
        before = _paged_counts()
        out = real(q, *args)
        after = _paged_counts()
        log.append((q.shape[2], tuple(a - b for a, b in
                                      zip(after[1:], before[1:]))))
        return out

    paged_mod._launch = recorded
    try:
        eng = ServeEngine(cfg, params=params, spec="ngram", spec_k=4,
                          brownout="auto", ladder=Pinned(), **SERVE_KW)
        got = eng.run(_serve_burst(cfg.vocab_size))
    finally:
        paged_mod._launch = real
    assert eng.spec_k == 2
    verify = [counts for rows, counts in log if rows == 12]
    s = got.summarize()
    assert len(verify) == cfg.num_layers * s["decode_dispatches"] > 0
    # hd 8, a head dim no tensor-core kernel is built for: split
    assert route(torch.bfloat16, 12, 4, cfg.head_dim_()) == "split"
    assert all(counts == _counted("split")[1:] for counts in verify)
    assert {r.rid: r.generated for r in got.requests} == \
        {r.rid: r.generated for r in want.requests}


@pytest.mark.cuda
def test_meta_packer_ring_waits_for_its_copies(cuda):
    """Hold the stream with a device sleep and pack RING + 4 buffers of
    distinct contents behind it: the ring wraps while the first copies
    still wait in the stream, and `pack` must wait on a buffer's event
    before it rewrites that buffer, so every copy arrives intact."""
    from repro_torch.serve.engine import _MetaPacker
    packer = _MetaPacker(torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # >= 0.1 s at any SM clock <= 2 GHz
    outs = [packer.pack([np.full(4096, i, np.int32)])
            for i in range(packer.RING + 4)]
    assert all(bool((o == i).all()) for i, o in enumerate(outs))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_overlapped_streams_equal_sync_on_the_card(cuda, layout, spec):
    """fp32 (TF32 off), on both KV layouts, paged through the kernel: the
    overlapped tick gives the synchronous tick's streams, with and without
    speculation.  On the flat layout the window holds the deferred prefill
    and its row inserts behind the in-flight step."""
    from repro_torch.serve import ServeEngine
    cfg = _grouped_small("float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    kw = SERVE_KW if layout == "paged" else dict(
        capacity=4, cache_len=128, prefill_bucket=16, kv_layout="flat",
        seed=0)
    want = ServeEngine(cfg, params=params, spec=spec, **kw).run(
        _serve_burst(cfg.vocab_size))
    eng = ServeEngine(cfg, params=params, spec=spec, overlap=True,
                      debug_checks=True, **kw)
    before = paged_attention.launches
    got = eng.run(_serve_burst(cfg.vocab_size))
    assert (paged_attention.launches > before) == (layout == "paged")
    assert {r.rid: r.generated for r in got.requests} == \
        {r.rid: r.generated for r in want.requests}


@pytest.mark.cuda
def test_overlapped_decode_settle_does_not_wait_for_window_work(cuda):
    """At tick 3 an `overlap_hook` enqueues >= 0.1 s of device sleep in the
    window, after the decode step, as a prefill would: the step's settle
    waits on the event behind the step's own token copy, so its host time
    stays well under the sleep (a blocking `.cpu()` would wait it out)."""
    from repro_torch.serve import ServeEngine
    cfg = _grouped_small("bfloat16")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    eng = ServeEngine(cfg, params=params, overlap=True, **SERVE_KW)
    eng.overlap_hook = lambda: (torch.cuda._sleep(200_000_000)
                                if eng._tick == 3 else None)
    waits = {}
    launch = eng._decode_launch

    def timed_launch(active):
        settle = launch(active)

        def timed_settle():
            t0 = time.perf_counter()
            out = settle()
            waits[eng._tick] = time.perf_counter() - t0
            return out
        return timed_settle

    eng._decode_launch = timed_launch
    eng.run(_serve_burst(cfg.vocab_size))
    assert 3 in waits
    assert waits[3] < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_disagg_streams_equal_monolithic_on_the_card(cuda, overlap):
    """fp32 (TF32 off), paged through the kernel: DisaggEngine (two
    workers) gives the monolithic engine's streams, synchronous and
    overlapped; both halves hold one params module (the same storage);
    the prefill pool launches paged_attention only on chunk-shaped spans
    (prefill_chunk x G rows) and the decode pool only on decode spans (G
    rows)."""
    from repro_torch.serve import DisaggEngine, ServeEngine
    import repro_torch.kernels.paged_attention as paged_mod
    cfg = _grouped_small("float32")
    G = cfg.num_heads // cfg.kv_heads()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    want = ServeEngine(cfg, params=params, **SERVE_KW).run(
        _serve_burst(cfg.vocab_size))
    kw = {k: v for k, v in SERVE_KW.items() if k != "kv_layout"}
    dis = DisaggEngine(cfg, params=params, n_workers=2, overlap=overlap,
                       debug_checks=True, **kw)
    assert dis.prefill.params is dis.decode.params is params
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
        dis.prefill.params.parameters(), dis.decode.params.parameters()))
    rows = {"prefill": [], "decode": []}
    pool = []
    real = paged_mod._launch

    def recorded(q, *args):
        rows[pool[-1]].append(q.shape[2])
        return real(q, *args)

    for name in rows:
        half = getattr(dis, name)

        def tick(tick=half.tick, name=name):
            pool.append(name)
            try:
                return tick()
            finally:
                pool.pop()
        half.tick = tick
    paged_mod._launch = recorded
    try:
        got = dis.run(_serve_burst(cfg.vocab_size))
    finally:
        paged_mod._launch = real
    assert {r.rid: r.generated for r in got.requests} == \
        {r.rid: r.generated for r in want.requests}
    assert got.handoffs == len(want.requests)
    chunk = SERVE_KW["prefill_chunk"] * G
    assert rows["prefill"] and set(rows["prefill"]) == {chunk}
    assert rows["decode"] and set(rows["decode"]) == {G}
    assert len(rows["prefill"]) == cfg.num_layers * got.prefill.summarize()[
        "prefill_dispatches_total"]
    assert len(rows["decode"]) == cfg.num_layers * got.decode.summarize()[
        "decode_dispatches"]


@pytest.mark.cuda
def test_cluster_contention_on_the_card(cuda):
    """fp32 (TF32 off): a ServeJob (paged, through the kernel) squeezed by
    a higher-priority CoCoA job (F = 28, the blocked SCD kernel) on a pool
    of simulated nodes of the card.  The server's streams equal a solo
    ServeEngine's on the same requests and params, the CoCoA gap curve,
    alpha and w equal a solo run's bit for bit, and both kernels were
    launched by the orchestrated run."""
    from repro_torch import cluster as C
    from repro_torch.serve import ServeEngine
    import repro_torch.kernels.paged_attention as paged_mod
    cfg = _grouped_small("float32")
    kw = dict(capacity=4, cache_len=128, prefill_bucket=32, page_size=16)

    def trainer(name):
        return C.cocoa_train_job(name, iterations=4, k_tasks=4, n=4000, f=28,
                                 chunk=100, priority=1, max_nodes=2, seed=0)

    srv = C.ServeJob(C.JobSpec("svc", "serve", max_nodes=3), cfg,
                     kv_layout="paged", seed=0, **kw)
    tr = trainer("train")
    assert srv.engine.device.type == "cuda" and tr.solver.w.is_cuda
    trace = C.ClusterTrace([
        C.arrive(0.0, "svc"),
        C.burst(0.0, "svc", 6, prompt_len=[20, 70], max_new_tokens=[6, 12],
                seed=3),
        C.arrive(1.0, "train")])
    orch = C.ClusterOrchestrator(C.DevicePool(3), [srv, tr], trace)
    assert orch.pool.devices[0].type == "cuda"
    paged_mod.paged_attention.launches = scd_pass.launches = 0
    rep = orch.run()
    torch.cuda.synchronize()
    assert paged_mod.paged_attention.launches > 0 and scd_pass.launches > 0
    assert {j["state"] for j in rep.jobs.values()} == {"finished"}
    assert rep.preemptions >= 1
    want = ServeEngine(cfg, params=srv.engine.params, kv_layout="paged",
                       seed=0, **kw).run(_serve_burst(cfg.vocab_size))
    assert {r.rid: r.generated for r in srv.engine.metrics.requests} == \
        {r.rid: r.generated for r in want.requests}
    solo = trainer("solo")
    C.ClusterOrchestrator(C.DevicePool(3), [solo],
                          C.ClusterTrace([C.arrive(0.0, "solo")])).run()
    assert solo.loss_curve() == tr.loss_curve()
    assert np.array_equal(solo.solver.store.state["alpha"],
                          tr.solver.store.state["alpha"])
    assert torch.equal(solo.solver.w, tr.solver.w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_family_on_the_card_matches_the_cpu(cuda, arch):
    """fp32 (TF32 off), each remaining family's smoke variant: `forward`,
    `prefill` of 64 tokens (two mamba/rwkv chunks; a memory stream for
    vlm/audio) and 4 `decode_step`s on the card give the CPU's logits and
    caches at 1e-5."""
    from repro_torch.launch.steps import memory_len
    cfg = smoke_variant(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":  # zeros at init would switch cross-attn off
        with torch.no_grad():
            params.blocks.cross_gate.fill_(0.5)
    card = M.params_from_paths(cfg, {k: v.cuda() for k, v in
                                     M.param_dict(params).items()})
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 68), generator=gen)
    T = memory_len(cfg)
    mem = torch.randn(2, T, cfg.d_model, generator=gen) * 0.02 if T else None

    def run(p, dev):
        on = (lambda t: None if t is None else t.to(dev))
        with torch.inference_mode():
            out = [M.forward(cfg, p, on(toks[:, :64]), memory=on(mem))]
            logits, cache = M.prefill(cfg, p, on(toks[:, :64]),
                                      memory=on(mem), cache_len=72)
            out.append(logits)
            for t in range(64, 68):
                logits, cache = M.decode_step(cfg, p, cache,
                                              on(toks[:, t:t + 1]), t)
                out.append(logits)
            out += [cache["blocks"][k] for k in sorted(cache["blocks"])]
        return [o.cpu() for o in out]

    for got, want in zip(run(card, "cuda"), run(params, "cpu")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
