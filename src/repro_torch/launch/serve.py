"""Serving CLI of the PyTorch port: a thin launcher over
`repro_torch.serve.ServeEngine` (synchronous tick).

Runs on the GPU unless `--device cpu` is given.  `--kv-layout flat`
(default) keeps one cache row per slot; `--kv-layout paged` pages the KV
cache, and there `--paged-impl kernel` (default) runs attention through
the CUDA paged-attention kernel, `--paged-impl gather` through a gather
and plain attention.  `--spec ngram|draft` turns on speculative decoding
with `--spec-k` drafts a tick.  `--chaos` injects faults on the tick clock
(crashes, slow workers); `--slo-ttft`/`--slo-tpot` set SLO targets,
`--tenant-rate`/`--queue-cap` bound admission, and `--brownout auto` arms
the degradation ladder (and, with `--chaos`, the crash-storm circuit
breaker).

CLI: PYTHONPATH=src python -m repro_torch.launch.serve --spec ngram \
         --spec-k 4 [--kv-layout paged] --trace poisson --requests 16
     PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
         --workers 2 --chaos "crash@t=5,slow@t=3:w0:2.0" --brownout auto
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs import get_config, smoke_variant
from ..core import ElasticScalingPolicy, ScaleEvent, StragglerMitigationPolicy
from ..faults import FaultInjector, parse_chaos
from ..obs import (Tracer, dominant_host_phase, format_attribution,
                   host_overlap_ratio, phase_attribution)
from ..serve import (CircuitBreaker, ServeEngine, poisson_arrivals,
                     synthetic_requests)
from .train import scale_config


def parse_scale_events(s: Optional[str]) -> Sequence[ScaleEvent]:
    """'tick:workers,tick:workers' -> ScaleEvents on the engine tick clock."""
    if not s:
        return []
    events = []
    for part in s.split(","):
        try:
            at, n = part.split(":")
            events.append(ScaleEvent(float(at), int(n)))
        except ValueError:
            raise ValueError(
                f"--scale-events expects 'tick:workers,...'; got {part!r}")
    return events


def _range_arg(s: str):
    """'min,max' (or a single value meaning min==max) -> (min, max)."""
    parts = s.split(",")
    if len(parts) == 1:
        parts = parts * 2
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected 'min,max', got {s!r}")
    lo, hi = int(parts[0]), int(parts[1])
    if lo > hi or lo <= 0:
        raise argparse.ArgumentTypeError(f"bad range {s!r}")
    return lo, hi


def default_scale_schedule(n_requests: int, avg_new: float, capacity: int,
                           workers: int) -> Sequence[ScaleEvent]:
    """Default: scale out to workers+1 a third of the way through the
    expected run, back in at two thirds (k: w -> w+1 -> w)."""
    est_ticks = max(int(np.ceil(n_requests * avg_new / capacity)) + 4, 9)
    return [ScaleEvent(0, workers),
            ScaleEvent(est_ticks // 3, workers + 1),
            ScaleEvent(2 * est_ticks // 3, workers)]


def serve(arch: str, *, smoke: bool = True, scale: str = "tiny",
          trace: str = "poisson", rate: float = 20.0, requests: int = 16,
          capacity: int = 8, cache_len: int = 64, prefill_bucket: int = 16,
          prompt_len: Tuple[int, int] = (8, 24),
          max_new_tokens: Tuple[int, int] = (4, 12),
          workers: int = 1, scale_events: Optional[str] = None,
          straggler_policy: bool = False, kv_layout: str = "flat",
          page_size: int = 8, spec: str = "off", spec_k: int = 4,
          prefix_share: Optional[bool] = None,
          evict: Optional[bool] = None, paged_impl: str = "kernel",
          chaos: Optional[str] = None,
          slo_ttft: Optional[float] = None, slo_tpot: Optional[float] = None,
          tenant_rate: Optional[float] = None, queue_cap: Optional[int] = None,
          brownout: str = "off",
          device: str = "cuda", seed: int = 0,
          trace_out: Optional[str] = None) -> Dict:
    """Run an open-loop serving workload; returns the metrics summary.
    `straggler_policy` adds a `StragglerMitigationPolicy` to the scale
    schedule; `spec` ("off", "ngram" or "draft") drafts `spec_k` tokens a
    tick for one verify dispatch; `evict` lets priority admission park a
    lower-priority decode's pages on the host (paged layout; default on
    there); `chaos` is a fault spec on the tick clock (`parse_chaos`);
    `slo_ttft`/`slo_tpot`, `tenant_rate`, `queue_cap` and `brownout` are
    the engine's overload knobs, and `brownout="auto"` with `chaos` also
    arms a `CircuitBreaker`; `trace_out` enables tick-phase tracing,
    writes a Chrome trace-event JSON file there (Perfetto-loadable) and
    adds the per-phase host-vs-device attribution to the summary."""
    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if smoke else scale_config(cfg, scale)
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(requests, rate if trace == "poisson" else 0.0,
                                rng=rng)
    reqs = synthetic_requests(requests, vocab_size=cfg.vocab_size,
                              arrivals=arrivals, prompt_len=prompt_len,
                              max_new_tokens=max_new_tokens, rng=rng)
    if scale_events is None:
        sched = default_scale_schedule(
            requests, float(np.mean(max_new_tokens)), capacity, workers)
    else:
        sched = parse_scale_events(scale_events)
    policies = [ElasticScalingPolicy(sched)] if sched else []
    if straggler_policy:
        policies.append(StragglerMitigationPolicy())
    tracer = Tracer(name=f"serve:{arch}") if trace_out else None
    injector = (FaultInjector(parse_chaos(chaos), tracer=tracer)
                if chaos else None)
    # overload control: brownout=auto arms the degradation ladder, and with
    # chaos scripted too it arms the crash-storm circuit breaker
    breaker = CircuitBreaker() if brownout == "auto" and chaos else None
    engine = ServeEngine(cfg, capacity=capacity, cache_len=cache_len,
                         prefill_bucket=prefill_bucket, n_workers=workers,
                         policies=policies, kv_layout=kv_layout,
                         page_size=page_size, spec=spec, spec_k=spec_k,
                         prefix_share=prefix_share,
                         evict=evict, paged_impl=paged_impl,
                         fault_injector=injector, slo_ttft=slo_ttft,
                         slo_tpot=slo_tpot, tenant_rate=tenant_rate,
                         queue_cap=queue_cap, brownout=brownout,
                         breaker=breaker, seed=seed, tracer=tracer,
                         device=device)
    out = engine.run(reqs).summarize()
    out.update(arch=arch, capacity=capacity, device=str(engine.device),
               kv_layout=kv_layout, paged_impl=paged_impl)
    if injector is not None:
        out["chaos"] = chaos
        out["faults_injected"] = injector.summary()
    if tracer is not None:
        tracer.save(trace_out)
        attr = phase_attribution(tracer)
        out["attribution"] = attr
        out["dominant_host_phase"] = dominant_host_phase(attr)
        out["host_overlap_ratio"] = host_overlap_ratio(tracer)
        out["trace_out"] = trace_out
    return out


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v * 1e3:7.1f}ms" if v is not None else "    n/a"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "25m", "100m"])
    ap.add_argument("--trace", default="poisson", choices=["poisson", "burst"])
    ap.add_argument("--rate", type=float, default=20.0, help="req/s (poisson)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=8, help="decode slots")
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--prefill-bucket", type=int, default=16)
    ap.add_argument("--prompt-len", type=_range_arg, default=(8, 24),
                    help="min,max (or one value)")
    ap.add_argument("--max-new", type=_range_arg, default=(4, 12),
                    help="min,max (or one value)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--scale-events", default=None,
                    help="'tick:workers,...'; default = k -> k+1 -> k mid-run")
    ap.add_argument("--straggler-policy", action="store_true",
                    help="add the straggler-mitigation policy")
    ap.add_argument("--kv-layout", default="flat", choices=["flat", "paged"],
                    help="paged = block-table KV pool + chunked prefill")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--spec", default="off", choices=["off", "ngram", "draft"],
                    help="speculative decode drafter (lossless greedy); "
                         "'draft' without trained draft params is a plumbing "
                         "demo (~0 acceptance) — use the ServeEngine API's "
                         "draft_params for real draft-model speculation")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed/verified per tick")
    ap.add_argument("--prefix-share", default=None, choices=["on", "off"],
                    help="map shared prompt prefixes onto existing KV pages "
                         "(refcounted, copy-on-write; paged layout only; "
                         "default: on when --kv-layout paged)")
    ap.add_argument("--evict", default=None, choices=["on", "off"],
                    help="priority admission may park a lower-priority "
                         "in-flight decode's pages to host instead of "
                         "queueing (paged layout only; default: on when "
                         "--kv-layout paged)")
    ap.add_argument("--paged-impl", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged attention through the CUDA kernel or through "
                         "a gather and plain attention")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection spec on the tick clock, e.g. "
                         "'crash@t=5', 'crash@t=5:w1', 'slow@t=3:w0:2.0', "
                         "'p_crash=0.02'; comma-separate multiple events")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S",
                    help="TTFT SLO target in seconds; enables the rolling "
                         "attainment tracker + goodput accounting")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="S",
                    help="per-output-token SLO target in seconds")
    ap.add_argument("--tenant-rate", type=float, default=None, metavar="R",
                    help="token-bucket admission: R requests/s per tenant "
                         "(burst defaults to max(R, 1)); excess arrivals "
                         "are REJECTED with a retry-after hint")
    ap.add_argument("--queue-cap", type=int, default=None, metavar="N",
                    help="bounded admission queue: arrivals beyond N queued "
                         "requests are REJECTED (backpressure)")
    ap.add_argument("--brownout", default="off", choices=["off", "auto"],
                    help="graceful-degradation ladder driven by SLO "
                         "attainment + queue pressure (spec shrink -> spec "
                         "off -> chunk cap -> park low-prio -> shed late); "
                         "with --chaos also arms the crash-storm circuit "
                         "breaker")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="enable tick-phase tracing and write a Chrome "
                         "trace-event JSON file (Perfetto-loadable); also "
                         "prints the host/device attribution table")
    ap.add_argument("--json", action="store_true", help="print raw JSON")
    args = ap.parse_args()

    onoff = lambda v: None if v is None else v == "on"  # noqa: E731
    out = serve(args.arch, smoke=args.smoke, scale=args.scale,
                trace=args.trace, rate=args.rate, requests=args.requests,
                capacity=args.capacity, cache_len=args.cache_len,
                prefill_bucket=args.prefill_bucket,
                prompt_len=args.prompt_len, max_new_tokens=args.max_new,
                workers=args.workers, scale_events=args.scale_events,
                straggler_policy=args.straggler_policy,
                kv_layout=args.kv_layout, page_size=args.page_size,
                spec=args.spec, spec_k=args.spec_k,
                prefix_share=onoff(args.prefix_share),
                evict=onoff(args.evict), paged_impl=args.paged_impl,
                chaos=args.chaos, slo_ttft=args.slo_ttft,
                slo_tpot=args.slo_tpot, tenant_rate=args.tenant_rate,
                queue_cap=args.queue_cap, brownout=args.brownout,
                device=args.device, seed=args.seed,
                trace_out=args.trace_out)
    if args.json:
        print(json.dumps(out, indent=2))
        return
    layout = out["kv_layout"] + (f", {out['paged_impl']}"
                                 if out["kv_layout"] == "paged" else "")
    print(f"{out['arch']} on {out['device']} ({layout}): "
          f"{out['requests_finished']}/{out['requests_total']} requests, "
          f"{out['tokens_generated']} tokens, "
          f"{out['tokens_per_s']:.1f} tok/s over {out['wall_s']:.2f}s")
    print(f"  TTFT p50 {_fmt_ms(out['ttft_p50_s'])}  "
          f"p99 {_fmt_ms(out['ttft_p99_s'])}")
    print(f"  TPOT p50 {_fmt_ms(out['tpot_p50_s'])}  "
          f"p99 {_fmt_ms(out['tpot_p99_s'])}")
    print(f"  occupancy {out['occupancy_mean']:.2f} over {out['n_ticks']} "
          f"ticks; scale events {out['scale_events']}")
    if out["spec_drafted_total"]:
        print(f"  spec: acceptance {out['spec_acceptance_rate']:.2f} "
              f"({out['spec_accepted_total']}/{out['spec_drafted_total']} "
              f"drafts), {out['tokens_per_dispatch']:.2f} tokens/dispatch "
              f"over {out['decode_dispatches']} dispatches")
    if out["shared_page_hits_total"] or out["parked_total"]:
        print(f"  kv: {out['shared_page_hits_total']} shared-page hits, "
              f"{out['cow_breaks_total']} cow breaks, "
              f"{out['parked_total']} parked / {out['restored_total']} "
              f"restored ({out['kv_moved_bytes_total']} bytes moved)")
    if "faults_injected" in out:
        print(f"  chaos: injected {out['faults_injected']}; "
              f"{out['recoveries']} recoveries "
              f"(mean {out['recovery_ticks_mean'] or 0:.1f} ticks), "
              f"{out['retries_total']} retries, "
              f"{out['shed_requests']} shed")
    if out.get("goodput") is not None or out.get("rejected_requests"):
        gp = out.get("goodput")
        print(f"  overload: goodput "
              f"{'n/a' if gp is None else f'{gp:.2f}'} "
              f"({out.get('slo_met') or 0}/{out['requests_finished']} "
              f"finished met SLO), {out['rejected_requests']} rejected, "
              f"{out['shed_requests']} shed, brownout max level "
              f"{out['brownout_level_max']}"
              + (f", breaker {out['breaker_events']}"
                 if out.get("breaker_events") else ""))
    if "attribution" in out:
        ratio = out.get("host_overlap_ratio")
        print(f"  trace written to {out['trace_out']}; tick-time "
              f"attribution (dominant host phase: "
              f"{out['dominant_host_phase']}; host overlap ratio "
              f"{'n/a' if ratio is None else f'{ratio:.2f}'}):")
        print(format_attribution(out["attribution"]))


if __name__ == "__main__":
    main()
