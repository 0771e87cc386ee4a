"""Disaggregated serving example: prefill and decode pools over disjoint
worker subsets with a page-granular handoff between them, plus a
queue-driven split policy rebalancing the prefill:decode worker split
mid-run.  The token streams are asserted bit-identical to a monolithic
flat-KV run of the same workload — the handoff moves KV pages, never
recomputes them.

The PyTorch port's run of examples/disagg_serve.py: the same workload,
engines, output and checks through `repro_torch.serve`.  On the card both
pools' attention runs through the paged-attention CUDA kernel (and the
flat oracle through the flat layout's attention), on the CPU with
--device cpu through the kernel's plain version.

    PYTHONPATH=src python examples/disagg_serve_torch.py [--fast] \
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.serve import (DisaggEngine, QueueSplitPolicy, ServeEngine,
                               poisson_arrivals, synthetic_requests)


def serve(engine, reqs, clock=None):
    """`engine.run(reqs)` on the wall clock; with `clock`, the one-element
    list the engine's clock reads, tick t runs at simulated second t."""
    if clock is None:
        return engine.run(reqs)
    engine.submit(reqs)
    disagg = isinstance(engine, DisaggEngine)
    while (not engine.drained if disagg else (
            engine.scheduler.has_pending or engine._by_slot
            or engine._prefilling or engine._retrying)):
        clock[0] = float(engine._tick)
        engine.tick()
    clock[0] = float(engine._tick)
    if disagg:
        engine.finalize(clock[0])
    else:
        engine.metrics.wall_s = clock[0]
    return engine.metrics


def run(device="cuda", fast=False, cfg=None, params=None, clock=None):
    """The example (`fast` as --fast) on smoke smollm-360m (or `cfg`) with
    the engines' seeded weights (or the port parameter tree `params`), on
    the wall clock (or the tick clock `clock`, see `serve`).  Returns the
    disaggregated run's metrics and the flat oracle's streams."""
    cfg = cfg or smoke_variant(get_config("smollm-360m"))
    n = 8 if fast else 14

    def workload(seed=0):
        rng = np.random.default_rng(seed)
        return synthetic_requests(
            n, vocab_size=cfg.vocab_size,
            arrivals=poisson_arrivals(n, rate=25.0, rng=rng),
            prompt_len=(8, 28), max_new_tokens=(4, 10), rng=rng)

    kw = dict(capacity=6, cache_len=48, prefill_bucket=8, seed=0,
              params=params, device=device,
              clock=None if clock is None else lambda: clock[0])

    # monolithic flat engine: the bit-exactness oracle
    oracle = ServeEngine(cfg, kv_layout="flat", n_workers=2, **kw)
    want = {r.rid: list(r.generated)
            for r in serve(oracle, workload(), clock).requests}

    # disaggregated: requests prefill in one pool, decode in the other;
    # the split policy moves workers toward whichever queue is deeper
    dis = DisaggEngine(cfg, n_workers=2,
                       split_policy=QueueSplitPolicy(interval=3),
                       debug_checks=True, **kw)
    metrics = serve(dis, workload(), clock)
    got = {r.rid: list(r.generated) for r in metrics.requests}

    s = metrics.summarize()
    d = s["disagg"]
    print(f"finished {s['requests_finished']}/{s['requests_total']} "
          f"requests, {s['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {s['ttft_p50_s']*1e3:.0f}ms")
    print(f"handoffs: {d['handoffs']} ({d['handoff_bytes']} KV bytes "
          f"prefill->decode, delay p50 "
          f"{(s['handoff_delay_p50_s'] or 0)*1e3:.1f}ms)")
    print(f"split events (tick, prefill_k, decode_k): {d['split_events']}")

    assert got == want, "disagg streams must match the monolithic oracle"
    assert d["handoffs"] == s["requests_finished"]
    assert dis.prefill.pages.n_used == 0 and dis.decode.pages.n_used == 0
    print("disaggregated serving OK (streams bit-identical to monolithic)")
    return metrics, want


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines serve (default: the card)")
    args = ap.parse_args()
    run(args.device, fast=args.fast)
