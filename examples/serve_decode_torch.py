"""Elastic continuous-batching serving example: a bursty open-loop workload
(Poisson arrivals with a mid-run burst) against the slotted KV pool, with a
scale event (k: 1 -> 2 -> 1) while requests are in flight.

The PyTorch port's run of examples/serve_decode.py: the same workload,
engine (the flat KV layout), scaling schedule, output and checks through
`repro_torch.serve`, on the card, or on the CPU with --device cpu.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import ElasticScalingPolicy, ScaleEvent
from repro_torch.serve import (ServeEngine, poisson_arrivals,
                               synthetic_requests, trace_arrivals)


def serve(engine, reqs, clock=None):
    """`engine.run(reqs)` on the wall clock; with `clock`, the one-element
    list the engine's clock reads, tick t runs at simulated second t."""
    if clock is None:
        return engine.run(reqs)
    engine.submit(reqs)
    while (engine.scheduler.has_pending or engine._by_slot
           or engine._prefilling or engine._retrying):
        clock[0] = float(engine._tick)
        engine.tick()
    clock[0] = engine.metrics.wall_s = float(engine._tick)
    return engine.metrics


def run(device="cuda", cfg=None, params=None, clock=None):
    """The example on smoke smollm-360m (or `cfg`) with the engine's seeded
    weights (or the port parameter tree `params`), on the wall clock (or
    the tick clock `clock`, see `serve`); returns the run's metrics."""
    cfg = cfg or smoke_variant(get_config("smollm-360m"))
    rng = np.random.default_rng(0)

    # open-loop workload: steady poisson trickle + a burst of 8 at t=0.4s
    steady = poisson_arrivals(10, rate=15.0, rng=rng)
    burst = trace_arrivals([0.4] * 8)
    arrivals = np.sort(np.concatenate([steady, burst]))
    reqs = synthetic_requests(len(arrivals), vocab_size=cfg.vocab_size,
                              arrivals=arrivals, prompt_len=(6, 20),
                              max_new_tokens=(4, 12), rng=rng)

    # elastic schedule on the tick clock: scale out under the burst, back in
    policy = ElasticScalingPolicy([ScaleEvent(0, 1), ScaleEvent(4, 2),
                                   ScaleEvent(12, 1)])
    engine = ServeEngine(cfg, capacity=8, cache_len=48, prefill_bucket=8,
                         n_workers=1, policies=[policy], seed=0,
                         params=params, device=device,
                         clock=None if clock is None else lambda: clock[0])
    metrics = serve(engine, reqs, clock)
    summary = metrics.summarize()

    print(f"finished {summary['requests_finished']}/{summary['requests_total']}"
          f" requests, {summary['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {summary['ttft_p50_s']*1e3:.0f}ms, "
          f"occupancy {summary['occupancy_mean']:.2f}")
    print(f"scale events (tick, k_before, k_after): {summary['scale_events']}")
    assert summary["requests_finished"] == summary["requests_total"]
    assert summary["tokens_per_s"] > 0
    # the scale-out always lands mid-run; the exact number of events depends
    # on wall-clock pacing of the open-loop arrivals (deterministic coverage
    # of k: 1 -> 2 -> 1 lives in tests/test_serve.py with burst arrivals)
    assert len(summary["scale_events"]) >= 1, "expected a mid-run scale event"
    print("elastic serving OK")
    return metrics


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine serves (default: the card)")
    run(ap.parse_args().device)
