"""`ServeEngine.defrag` through both packages: the reference's two defrag
tests of tests/test_paged.py (defrag while slots are mid-prefill and pages
are shared, the allocator and prefix index checked after every move; defrag
mid-run on an unchunked paged engine against the flat layout's streams),
each run on the JAX engine and on the port's (CPU, the JAX init's params),
on one simulated clock so both see the same ticks: equal streams, equal
block tables after every move, equal counts of moves."""
import jax
import numpy as np
import pytest

from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.models import model as JM
from repro.serve import ServeEngine, synthetic_requests
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import model as TM
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import synthetic_requests as t_synthetic_requests

ARCH = "smollm-360m"  # tests/test_paged.py's
DT = 0.01  # simulated seconds a tick


@pytest.fixture(scope="module")
def model():
    cfg = smoke_variant(get_config(ARCH))
    params = JM.init_params(cfg, jax.random.key(0))
    tcfg = t_smoke_variant(t_get_config(ARCH))
    tparams = TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return cfg, params, tcfg, tparams


def _engine(model, jax_side, **kw):
    """An engine of either package on the simulated clock `eng._t`."""
    cfg, params, tcfg, tparams = model
    t = [0.0]
    if jax_side:
        eng = ServeEngine(cfg, params=params, clock=lambda: t[0], **kw)
    else:
        eng = TServeEngine(tcfg, params=tparams, device="cpu",
                           clock=lambda: t[0], **kw)
    eng._t = t
    return eng


def _tick(eng, jax_side):
    if jax_side:
        with set_mesh(eng.mesh):
            eng.tick()
    else:
        eng.tick()
    eng._t[0] += DT


def _busy(eng):
    return bool(eng._by_slot or eng._prefilling
                or eng.scheduler.has_pending)


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _tables(eng):
    return {s: eng.pages.table(s) for s in sorted(
        set(eng._by_slot) | set(eng._prefilling))}


def _shared_burst(make, vocab):
    head = np.random.default_rng(7).integers(0, vocab, size=16)
    return make(4, vocab_size=vocab,
                arrivals=np.array([0.0, 0.02, 0.3, 0.32]),
                prompt_len=(18, 24), max_new_tokens=(3, 5),
                shared_prefix=head, rng=np.random.default_rng(8))


PREFILL_KW = dict(capacity=4, cache_len=64, prefill_bucket=8, n_workers=1,
                  seed=0, kv_layout="paged", prefill_chunk=8,
                  debug_checks=True)


def _mid_prefill(model, jax_side):
    """tests/test_paged.py::test_defrag_mid_prefill_with_shared_pages on
    one package: the no-defrag streams, then a run that defrags after
    every tick that leaves a slot mid-prefill, checking the allocator's
    exact coverage and the prefix index right after each move."""
    make = synthetic_requests if jax_side else t_synthetic_requests
    vocab = model[0].vocab_size
    ref = _engine(model, jax_side, **PREFILL_KW)
    ref.submit(_shared_burst(make, vocab))
    ref._now()
    while _busy(ref):
        _tick(ref, jax_side)
    eng = _engine(model, jax_side, **PREFILL_KW)
    eng.submit(_shared_burst(make, vocab))
    eng._now()
    moves = []
    for i in range(200):
        if not _busy(eng):
            break
        _tick(eng, jax_side)
        if eng._prefilling:  # defrag DURING a prefill
            if eng.defrag():
                moves.append((i, _tables(eng)))
            live = {s: int(eng.scheduler.pool.pos[s]) for s in eng._by_slot}
            live.update({s: off for s, (_, off) in eng._prefilling.items()})
            eng.mem.check(live)
    assert eng.mem.stats()["shared_page_hits"] > 0  # sharing was in play
    assert eng.pages.n_used == 0
    return _streams(ref.metrics), _streams(eng.metrics), moves


def test_defrag_mid_prefill_with_shared_pages(model):
    j_want, j_got, j_moves = _mid_prefill(model, True)
    t_want, t_got, t_moves = _mid_prefill(model, False)
    assert j_moves, "no defrag ran while mid-prefill"
    assert j_got == j_want  # the reference's own assertion
    assert t_got == t_want == j_want
    assert t_moves == j_moves  # same ticks, same remapped tables


def _burst(make, vocab):
    return make(8, vocab_size=vocab, arrivals=np.zeros(8),
                prompt_len=(6, 16), max_new_tokens=(5, 9),
                rng=np.random.default_rng(0))


def _mid_run(model, jax_side):
    """tests/test_paged.py::test_defrag_mid_run_preserves_streams on one
    package: the flat layout's streams, then an unchunked paged run with
    defrag after ticks 2 and 5 and the allocator's invariants checked."""
    make = synthetic_requests if jax_side else t_synthetic_requests
    vocab = model[0].vocab_size
    flat = _engine(model, jax_side, capacity=4, cache_len=32,
                   prefill_bucket=8, n_workers=1, seed=0)
    flat.submit(_burst(make, vocab))
    flat._now()
    while _busy(flat):
        _tick(flat, jax_side)
    eng = _engine(model, jax_side, capacity=4, cache_len=32,
                  prefill_bucket=8, n_workers=1, seed=0, kv_layout="paged",
                  chunked_prefill=False)
    eng.submit(_burst(make, vocab))
    eng._now()
    moved = []
    for i in range(12):
        if not _busy(eng):
            break
        _tick(eng, jax_side)
        if i in (2, 5):
            moved.append((i, eng.defrag(), _tables(eng)))
            eng.pages.check_invariants()
    while _busy(eng):
        _tick(eng, jax_side)
    assert not flat.defrag()  # the flat layout has no pages to move
    return _streams(flat.metrics), _streams(eng.metrics), moved


def test_defrag_mid_run_preserves_streams(model):
    j_want, j_got, j_moved = _mid_run(model, True)
    t_want, t_got, t_moved = _mid_run(model, False)
    assert j_got == j_want  # the reference's own assertion
    assert t_got == t_want == j_want
    assert t_moved == j_moved
