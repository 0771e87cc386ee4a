"""Paged attention in the PyTorch port vs the JAX package: the port's plain
version against the Pallas kernel (interpret mode, as tests/test_paged.py
runs it) and against `kernels.ref.paged_attention_ref`, on the kernel's
self-test cases plus wider spans; the split route's arithmetic
(`paged_attention_split_plain`: runs of keys, per-run (m, l, acc), merged
in run order) against the same, on those cases, the served decode shape
and the route's edge cases; the same arithmetic at the verify route's run
length on verify spans (q_span 3-8, hd 64 and 80); the launcher's rule
(`route`) over every rows/group/head-dim triple; the self-test entry
point on the CPU; and the wrapper's input checks.  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.

Tolerances are the reference's (tests/test_kernels.py): fp32 2e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels.paged_attention import (SPLIT_KEYS,
                                                 paged_attention,
                                                 paged_attention_plain,
                                                 paged_attention_split_plain,
                                                 VERIFY_KEYS, route)

# (B, KV, G, hd, ps, P, window, q_span): the five cases of the JAX kernel's
# _selftest, then an hd that is not a power of two and a wide windowed span
SELFTEST_CASES = [(3, 2, 4, 32, 8, 4, 0, 1),
                  (2, 1, 8, 64, 16, 3, 0, 1),
                  (4, 2, 2, 32, 8, 8, 16, 1),
                  (3, 2, 4, 32, 8, 4, 0, 3),
                  (2, 2, 2, 32, 8, 6, 16, 4)]
CASES = SELFTEST_CASES + [(2, 2, 4, 80, 16, 4, 0, 1),
                          (2, 2, 4, 32, 8, 6, 12, 8)]


def make_inputs(case, seed=0, lengths=None):
    """numpy inputs laid out as the JAX self-test lays them out: shuffled
    physical pages, one inactive row in decode cases, -1 past live
    (`lengths` given: those instead of random ones)."""
    B, KV, G, hd, ps, P, _, Q = case
    rng = np.random.default_rng(seed)
    N = B * P + 1
    q = rng.standard_normal((B, KV, Q * G, hd)).astype(np.float32)
    kp = rng.standard_normal((N, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((N, ps, KV, hd)).astype(np.float32)
    if lengths is not None:
        lengths = np.asarray(lengths, np.int32)
    else:
        lengths = rng.integers(Q, P * ps + 1, size=B).astype(np.int32)
        if Q == 1:
            lengths[rng.integers(B)] = 0
    perm = rng.permutation(np.arange(1, N))
    table = np.full((B, P), -1, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = perm[used: used + n]
        used += n
    return q, kp, vp, table, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_and_ref(case):
    """All cases against the JAX oracle; the self-test cases also against
    the Pallas kernel itself (interpret mode costs seconds per shape)."""
    win, Q = case[6], case[7]
    q, kp, vp, table, lengths = make_inputs(case)
    jx = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    got = paged_attention(*_torch(q, kp, vp, table, lengths), window=win,
                          q_span=Q).numpy()
    want_ref = np.asarray(ref.paged_attention_ref(*jx, window=win,
                                                  q_span=Q))
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    if case in SELFTEST_CASES:
        want_kernel = np.asarray(jax_paged(*jx, window=win, q_span=Q,
                                           interpret=True))
        np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    inactive = lengths == 0
    assert not got[inactive].any()  # length-0 rows are zeros


def test_explicit_q_start_matches_jax_ref():
    """A span whose first query is not the contiguous tail (q_start given)."""
    case = (2, 2, 4, 32, 8, 4, 0, 4)
    q, kp, vp, table, lengths = make_inputs(case, seed=3)
    q_start = np.maximum(lengths - 6, 0).astype(np.int32)
    jx = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    want = np.asarray(ref.paged_attention_ref(
        *jx, q_span=4, q_start=jnp.asarray(q_start)))
    got = paged_attention(*_torch(q, kp, vp, table, lengths), q_span=4,
                          q_start=torch.from_numpy(q_start)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# (case, lengths) of the split route (spans of <= 16 rows): the served
# decode shape (h2o-danube-1.8b: hd 80, page_size 16, P 128, window 4096,
# one inactive row); then length 0, a length shorter than one run, one run
# and exactly P * ps; a window whose first visible key falls inside a run;
# q_span 3 (12 rows) and q_span 4 (16 rows)
SPLIT_CASES = ([(c, None) for c in SELFTEST_CASES]
               + [((8, 8, 4, 80, 16, 128, 4096, 1), None),
                  ((4, 2, 4, 80, 16, 8, 0, 1), [0, 5, 64, 128]),
                  ((3, 2, 4, 80, 16, 16, 40, 1), [200, 77, 256]),
                  ((3, 2, 4, 64, 16, 8, 0, 3), [3, 70, 128]),
                  ((2, 2, 4, 32, 8, 20, 24, 4), [9, 160])])


@pytest.mark.parametrize("split_keys", [SPLIT_KEYS, 8])
@pytest.mark.parametrize("case,lengths", SPLIT_CASES)
def test_split_arithmetic_matches_jax_kernel_and_ref(case, lengths,
                                                     split_keys):
    """The split route's arithmetic, at the kernel's runs of SPLIT_KEYS keys
    and at runs of 8 (so the self-test cases' short tables are cut into
    several runs too), against the JAX oracle, and on the self-test cases
    against the Pallas kernel; length-0 rows are zeros."""
    win, Q = case[6], case[7]
    q, kp, vp, table, lengths = make_inputs(case, seed=sum(case),
                                            lengths=lengths)
    jx = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    got = paged_attention_split_plain(
        *_torch(q, kp, vp, table, lengths), window=win, q_span=Q,
        split_keys=split_keys).numpy()
    want = np.asarray(ref.paged_attention_ref(*jx, window=win, q_span=Q))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if case in SELFTEST_CASES:
        want_kernel = np.asarray(jax_paged(*jx, window=win, q_span=Q,
                                           interpret=True))
        np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    assert not got[lengths == 0].any()


def test_split_arithmetic_with_explicit_q_start():
    """A span whose first query is not the contiguous tail (q_start given),
    cut into runs of 8 keys, against the JAX oracle."""
    case = (2, 2, 4, 32, 8, 4, 0, 4)
    q, kp, vp, table, lengths = make_inputs(case, seed=3)
    q_start = np.maximum(lengths - 6, 0).astype(np.int32)
    jx = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    want = np.asarray(ref.paged_attention_ref(
        *jx, q_span=4, q_start=jnp.asarray(q_start)))
    got = paged_attention_split_plain(
        *_torch(q, kp, vp, table, lengths), q_span=4,
        q_start=torch.from_numpy(q_start), split_keys=8).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["dtype", "table_dtype", "shape",
                                 "contiguity", "q_span"])
def test_wrapper_rejects_bad_inputs(bad):
    q, kp, vp, table, lengths = _torch(*make_inputs(CASES[0]))
    kw = {}
    if bad == "dtype":
        q = q.double()
    elif bad == "table_dtype":
        table = table.long()
    elif bad == "shape":
        kp = kp[:, :, :1]
    elif bad == "contiguity":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        kw["q_span"] = 3  # 4 rows per sequence is not a multiple of 3
    with pytest.raises((TypeError, ValueError)):
        paged_attention(q, kp, vp, table, lengths, **kw)



# (case, lengths) of bf16 verify spans (the verify route: G < QG <= 32,
# runs of VERIFY_KEYS = 512 keys): q_span 3 to 8, hd 64 and 80, over
# tables of 1-2 runs; an inactive row, a length shorter than a stage,
# exactly one run and exactly P * ps; windows whose first visible key
# falls inside a run; QG 32 (G 8, q_span 4; G 4, q_span 8)
VERIFY_CASES = [((2, 2, 4, 64, 16, 40, 0, 3), None),
                ((2, 2, 4, 80, 16, 36, 0, 5), [0, 576]),
                ((3, 1, 4, 80, 16, 40, 300, 4), [640, 7, 512]),
                ((2, 2, 8, 64, 16, 24, 0, 4), [384, 200]),
                ((2, 1, 4, 80, 16, 20, 100, 8), [310, 320]),
                ((2, 2, 2, 64, 16, 34, 0, 6), [530, 41])]


@pytest.mark.parametrize("case,lengths", VERIFY_CASES)
def test_verify_arithmetic_matches_jax_kernel_and_plain(case, lengths):
    """The verify route's arithmetic (`paged_attention_split_plain` at its
    run length) on verify spans, in fp32 at 2e-5, against the port's
    plain version, the JAX oracle and the Pallas kernel in interpret mode;
    length-0 rows are zeros."""
    B, KV, G, hd, ps, P, win, Q = case
    assert route(torch.bfloat16, Q * G, G, hd) == "verify"
    q, kp, vp, table, lengths = make_inputs(case, seed=sum(case),
                                            lengths=lengths)
    args = _torch(q, kp, vp, table, lengths)
    got = paged_attention_split_plain(*args, window=win, q_span=Q,
                                      split_keys=VERIFY_KEYS).numpy()
    plain = paged_attention_plain(*args, window=win, q_span=Q).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)
    jx = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    want = np.asarray(ref.paged_attention_ref(*jx, window=win, q_span=Q))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    want_kernel = np.asarray(jax_paged(*jx, window=win, q_span=Q,
                                       interpret=True))
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    assert not got[lengths == 0].any()


def test_launcher_rule_over_every_shape():
    """`route`, the C launcher's rule as the wrapper states it: bf16 spans
    of G < QG <= 32 rows at hd 64, 80 or 128 take the verify route; other
    bf16 spans of >= 16 rows at those head dims the chunk kernel; every
    other span of <= 16 rows the split route; the rest the CUDA-core
    kernel.  Checked over every group up to 32, q_span up to 40 and head
    dim (multiples of 8 up to 128) in both dtypes, and at the served
    shapes."""
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for G in range(1, 33):
            for q_span in range(1, 41):
                QG = G * q_span
                for hd in range(8, 129, 8):
                    tc = dtype == torch.bfloat16 and hd in (64, 80, 128)
                    want = ("verify" if tc and q_span >= 2 and QG <= 32
                            else "tc" if tc and QG >= 16
                            else "split" if QG <= 16 else "cuda_core")
                    got = route(dtype, QG, G, hd)
                    assert got == want, (dtype, G, q_span, hd)
                    seen.add(got)
    assert seen == {"verify", "tc", "split", "cuda_core"}
    bf16, f32 = torch.bfloat16, torch.float32
    # h2o-danube-1.8b (G 4, hd 80): decode, verify at q_span 5 and 3, chunk
    assert [route(bf16, q * 4, 4, 80) for q in (1, 5, 3, 256)] == [
        "split", "verify", "verify", "tc"]
    assert [route(f32, q * 4, 4, 80) for q in (1, 5, 3, 256)] == [
        "split", "cuda_core", "split", "cuda_core"]
    # grok-1-314b (G 6, hd 128): decode, verify at q_span 5 and 3, chunk
    assert [route(bf16, q * 6, 6, 128) for q in (1, 5, 3, 256)] == [
        "split", "verify", "verify", "tc"]
    assert VERIFY_KEYS == 512


def test_selftest_entry_point_on_the_cpu(capsys):
    """`python -m repro_torch.kernels.paged_attention --selftest --device
    cpu`: the JAX self-test's five cases (its draws: the same lengths)
    through the wrapper and each route's arithmetic, one line a case."""
    paged_mod._selftest("cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(SELFTEST_CASES) == 5
    assert all(ln.startswith("paged_attention parity OK (cpu)")
               for ln in lines)
    assert "lengths=[0, 23, 17]" in lines[0]  # the JAX self-test's draws
    assert "lengths=[25, 39]" in lines[-1]
