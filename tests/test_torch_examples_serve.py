"""The port's serving examples (examples/serve_decode_torch.py and
disagg_serve_torch.py --fast) on the CPU against the bodies of the JAX
examples (examples/serve_decode.py and disagg_serve.py --fast) rebuilt
here.  Both sides run on a tick clock (one tick, one simulated second:
the port example's `clock`, a one-element list it sets before each tick)
with the JAX engines' parameters carried across by `params_from_numpy`,
so every count is deterministic.

serve_decode: equal token streams, scale events and requests finished.
disagg_serve: the port's disaggregated streams equal the port's flat
oracle and the JAX example's disaggregated streams; handoffs, handoff
bytes and split events equal the JAX run's.  On the CPU the
paged-attention wrapper runs its plain version.  Each example also runs
once on the wall clock, as its command line runs it, and makes its own
checks there."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import get_config, smoke_variant
from repro.core import ElasticScalingPolicy, ScaleEvent
from repro.serve import (DisaggEngine, QueueSplitPolicy, ServeEngine,
                         poisson_arrivals, synthetic_requests,
                         trace_arrivals)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import model as TM

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines run thousands of tiny CPU ops: one intra-op thread
    keeps them from contending with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _tick_engine(cls, cfg, **kw):
    """A JAX engine on a tick clock: it reads `eng._clk`, which `_drive`
    sets to the tick index before each tick."""
    holder = {}
    eng = cls(cfg, clock=lambda: holder["e"]._clk, **kw)
    eng._clk = 0.0
    holder["e"] = eng
    return eng


def _drive(eng, reqs):
    eng.submit(reqs)
    disagg = isinstance(eng, DisaggEngine)
    while (not eng.drained if disagg else (
            eng.scheduler.has_pending or eng._by_slot or eng._prefilling
            or eng._retrying)):
        eng._clk = float(eng._tick)
        if disagg:
            eng.tick()
        else:
            with set_mesh(eng.mesh):  # the JAX engine ticks in its mesh
                eng.tick()
    if disagg:
        eng.finalize(float(eng._tick))
    else:
        eng.metrics.wall_s = float(eng._tick)
    return eng.metrics


def _port_params(params):
    """A JAX smoke smollm-360m tree as the port's module."""
    tcfg = t_smoke_variant(t_get_config("smollm-360m"))
    return TM.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")


def test_serve_decode_matches_the_jax_example(capsys):
    """examples/serve_decode.py's body on the tick clock, then the port's
    example on its own tick clock with the JAX engine's parameters."""
    cfg = smoke_variant(get_config("smollm-360m"))
    rng = np.random.default_rng(0)
    steady = poisson_arrivals(10, rate=15.0, rng=rng)
    burst = trace_arrivals([0.4] * 8)
    arrivals = np.sort(np.concatenate([steady, burst]))
    reqs = synthetic_requests(len(arrivals), vocab_size=cfg.vocab_size,
                              arrivals=arrivals, prompt_len=(6, 20),
                              max_new_tokens=(4, 12), rng=rng)
    policy = ElasticScalingPolicy([ScaleEvent(0, 1), ScaleEvent(4, 2),
                                   ScaleEvent(12, 1)])
    jeng = _tick_engine(ServeEngine, cfg, capacity=8, cache_len=48,
                        prefill_bucket=8, n_workers=1, policies=[policy],
                        seed=0)
    want_m = _drive(jeng, reqs)
    want = want_m.summarize()

    got_m = _example("serve_decode_torch").run(
        "cpu", params=_port_params(jeng.params), clock=[0.0])
    got = got_m.summarize()
    lines = capsys.readouterr().out.splitlines()
    assert _streams(got_m) == _streams(want_m)
    assert got["requests_finished"] == want["requests_finished"] == 18
    assert got["scale_events"] == want["scale_events"]
    assert lines[1] == ("scale events (tick, k_before, k_after): "
                        f"{want['scale_events']}")
    assert lines[-1] == "elastic serving OK"


def _jax_disagg(n):
    """examples/disagg_serve.py's body at `n` requests on the tick clock
    (its check on the streams included); -> (metrics, engine)."""
    cfg = smoke_variant(get_config("smollm-360m"))

    def workload(seed=0):
        rng = np.random.default_rng(seed)
        return synthetic_requests(
            n, vocab_size=cfg.vocab_size,
            arrivals=poisson_arrivals(n, rate=25.0, rng=rng),
            prompt_len=(8, 28), max_new_tokens=(4, 10), rng=rng)

    kw = dict(capacity=6, cache_len=48, prefill_bucket=8, seed=0)
    oracle = _tick_engine(ServeEngine, cfg, kv_layout="flat", n_workers=2,
                          **kw)
    want = _streams(_drive(oracle, workload()))
    dis = _tick_engine(DisaggEngine, cfg, n_workers=2,
                       split_policy=QueueSplitPolicy(interval=3),
                       debug_checks=True, params=oracle.params, **kw)
    metrics = _drive(dis, workload())
    assert _streams(metrics) == want
    return metrics, oracle


def test_disagg_serve_matches_the_jax_example(capsys):
    """--fast (8 requests): the port's streams equal its flat oracle's
    and the JAX example's; the handoff accounting equals the JAX run's."""
    want_m, oracle = _jax_disagg(8)
    want = want_m.summarize()["disagg"]
    got_m, oracle_streams = _example("disagg_serve_torch").run(
        "cpu", fast=True, params=_port_params(oracle.params),
        clock=[0.0])
    got = got_m.summarize()
    lines = capsys.readouterr().out.splitlines()
    assert _streams(got_m) == oracle_streams == _streams(want_m)
    assert len(oracle_streams) == 8
    for key in ("handoffs", "handoff_bytes", "split_events"):
        assert got["disagg"][key] == want[key], key
    assert got["disagg"]["handoffs"] == got["requests_finished"] == 8
    assert lines[1].startswith(f"handoffs: 8 ({want['handoff_bytes']} KV "
                               "bytes prefill->decode")
    assert lines[2] == ("split events (tick, prefill_k, decode_k): "
                        f"{want['split_events']}")
    assert lines[-1] == ("disaggregated serving OK (streams bit-identical "
                         "to monolithic)")


@pytest.mark.parametrize("name", ["serve_decode_torch",
                                  "disagg_serve_torch"])
def test_serving_example_on_the_wall_clock(name, capsys):
    """As the command line runs it (`--device cpu`, disagg with --fast):
    the engines' own seeded weights, open-loop arrivals paced on the wall
    clock, the example's own checks."""
    mod = _example(name)
    if name == "serve_decode_torch":
        s = mod.run("cpu").summarize()
        assert s["requests_finished"] == 18
    else:
        m, oracle_streams = mod.run("cpu", fast=True)
        assert _streams(m) == oracle_streams
        assert m.summarize()["disagg"]["handoffs"] == 8
    assert capsys.readouterr().out.splitlines()[-1].endswith(
        ("elastic serving OK", "(streams bit-identical to monolithic)"))
