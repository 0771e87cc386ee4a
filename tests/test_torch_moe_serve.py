"""The port's ServeEngine on the moe family against the JAX ServeEngine:
the smoke variants of grok-1-314b and arctic-480b (4 experts, top-2;
arctic with its dense residual FFN) in fp32 on the same parameters (the
JAX tree carried across by `params_from_numpy`), on the paged layout
through both attention implementations with whole-prompt and chunked
prefill, and on the flat layout.  Token streams and every wall-time-free
`summarize` counter must be equal.

A moe row's output depends on the other rows of its dispatch: each expert
has a fixed capacity per call and the assignments past it are dropped in
token order (`models.moe`).  Eight decode slots give a decode capacity of
5 per expert for 16 assignments, so decode steps drop assignments too,
and the bytes the engine gives padding rows, bucket padding and free
slots (their stale tokens) take capacity: equal streams need them equal
to the JAX engine's.  Every run asserts that the port's routing dropped
assignments, so the comparison is sensitive to those bytes.

The same sensitivity makes a moe stream depend on the serving path, in
the JAX engine as in the port (the chunked-prefill test says how).
Resize(k), speculative decoding, the overlapped tick, a
crash plan and the launcher are in test_torch_moe_paths.py."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.models import model as JM
from repro.serve import ServeEngine, synthetic_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.core import ElasticScalingPolicy as TElasticScalingPolicy
from repro_torch.core import ScaleEvent as TScaleEvent
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

from test_torch_faults import COUNTERS

ARCHS = ["grok-1-314b", "arctic-480b"]
KW = dict(capacity=8, cache_len=64, prefill_bucket=16, page_size=8, seed=0)
JAX_SIDE = (synthetic_requests, ElasticScalingPolicy, ScaleEvent)
PORT_SIDE = (t_synthetic_requests, TElasticScalingPolicy, TScaleEvent)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = smoke_variant(get_config(request.param))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(request.param))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture
def drops(monkeypatch):
    """Assignments the port's routing dropped: [all, in decode steps]."""
    seen = [0, 0]
    route = TMoE.route

    def counting(cfg, p, xt, cap):
        buf, wbuf, aux = route(cfg, p, xt, cap)
        n = xt.shape[0] * cfg.experts_per_token - int((buf >= 0).sum())
        seen[0] += n
        seen[1] += n if xt.shape[0] == KW["capacity"] else 0
        return buf, wbuf, aux

    monkeypatch.setattr(TMoE, "route", counting)
    return seen


def _burst(side, vocab, n=8, seed=0, prompt=(6, 32), max_new=(5, 9)):
    return side[0](n, vocab_size=vocab, arrivals=np.zeros(n),
                   prompt_len=prompt, max_new_tokens=max_new,
                   rng=np.random.default_rng(seed))


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _run(model, side, events=None, workload=_burst, **kw):
    cfg, params, tcfg, tparams = model
    port = side is PORT_SIDE
    c, p = (tcfg, tparams) if port else (cfg, params)
    pol = ([side[1]([side[2](*e) for e in events])] if events else [])
    extra = dict(device="cpu", debug_checks=True) if port else {}
    eng = (TServeEngine if port else ServeEngine)(
        c, params=p, policies=pol, **{**KW, **kw}, **extra)
    return eng, eng.run(workload(side, c.vocab_size))


def _run_both(model, **kw):
    _, jm = _run(model, JAX_SIDE, **kw)
    teng, tm = _run(model, PORT_SIDE, **kw)
    assert _streams(tm) == _streams(jm)
    js, ts = jm.summarize(), tm.summarize()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["requests_finished"] == len(tm.requests)
    if teng.pages is not None:
        teng.pages.check_invariants()
        assert teng.pages.n_used == 0
    return jm, tm


PATHS = {
    "paged_kernel_whole": dict(kv_layout="paged", paged_impl="pallas",
                               chunked_prefill=False),
    "paged_gather_whole": dict(kv_layout="paged", paged_impl="xla",
                               chunked_prefill=False),
    "flat": dict(kv_layout="flat"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_moe_engine_matches_jax_engine(model, path, drops):
    _run_both(model, **PATHS[path])
    assert drops[0] > 0 and drops[1] > 0  # decode steps dropped too


def _long(side, vocab):
    return _burst(side, vocab, prompt=(6, 60), max_new=(8, 16))


CHUNKED = dict(kv_layout="paged", workload=_long, cache_len=96,
               prefill_bucket=16, prefill_chunk=16)


def test_moe_chunked_prefill_matches_jax_through_both_impls(model, drops):
    """Chunked prefill through the kernel and through the gather path,
    each against the JAX engine's run of the same implementation.

    The two implementations need not give equal moe streams, in the JAX
    engine as in the port: the kernel returns zeros for a row of length 0
    and the gather path an average over the null page, so a free slot
    routes differently and can take a live row's expert capacity.  Nor
    need whole-prompt and chunked prefill, which batch other tokens into
    one call.  So each run is held only to the JAX engine's."""
    for impl in ("pallas", "xla"):
        _, tm = _run_both(model, paged_impl=impl, **CHUNKED)
        assert tm.summarize()["prefill_chunks_total"] > 0
    assert drops[0] > 0 and drops[1] > 0
