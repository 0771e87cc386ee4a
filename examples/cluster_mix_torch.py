"""Multi-tenant cluster demo: 2 elastic trainers + 1 serving job contending
over 8 simulated heterogeneous nodes (6 fast, 2 at 1.5x per-sample time),
with the full event menu — arrivals, a bursty serve tenant preempting the
trainers, and a mid-run trainer departure that returns its nodes.

trainA runs in micro-task mode (fixed logical parallelism; the allocation
only changes how its tasks waterfill onto leased nodes — convergence is
untouched by preemption).  trainB runs in uni-task mode: its worker count
tracks the lease through a callable-schedule `ElasticScalingPolicy`, the
closed-loop version of the benchmarks' scripted `ScaleEvent` replay.  The
server splits admissions 3:1 across two tenants via the weighted
round-robin admission queue.

The PyTorch port's run of examples/cluster_mix.py: the same trace, pool
and jobs, through `repro_torch.cluster`; the jobs run on the card (the
paged-attention and SCD kernels' plain versions on the CPU with
--device cpu).

    PYTHONPATH=src python examples/cluster_mix_torch.py [--fast] [--device cpu]
"""
import argparse

import torch

from repro_torch.cluster import (ClusterOrchestrator, ClusterTrace,
                                 DevicePool, JobSpec, ServeJob, arrive, burst,
                                 cocoa_train_job, depart)
from repro_torch.configs import get_config, smoke_variant

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="stream per-tick cluster stats (demand/alloc/"
                         "nodes_used) to FILE as JSON lines")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the jobs run (default: the card)")
    args = ap.parse_args()
    dev = args.device

    n, f, iters = (1000, 24, 10) if args.fast else (3000, 48, 20)
    burst_n = 5 if args.fast else 8

    trainA = cocoa_train_job("trainA", iterations=iters, k_tasks=8,
                             n=n, f=f, chunk=50, seed=0, mode="microtask",
                             device=dev)
    trainB = cocoa_train_job("trainB", iterations=4 * iters, k_tasks=8,
                             n=n, f=f, chunk=50, seed=1, mode="unitask",
                             device=dev)
    cfg = smoke_variant(get_config("smollm-360m"))
    server = ServeJob(
        JobSpec("svc", "serve", weight=1.0, priority=1, max_nodes=4),
        cfg, capacity=8, cache_len=32, prefill_bucket=8, slots_per_node=2,
        tenant_weights={"gold": 3.0, "free": 1.0}, seed=0, device=dev)

    trace = ClusterTrace([
        arrive(0.0, "trainA"),
        arrive(0.0, "trainB"),
        arrive(5.0, "svc"),
        burst(5.0, "svc", burst_n, prompt_len=[6, 12], max_new_tokens=[4, 8],
              tenant="gold", seed=2),
        burst(5.0, "svc", burst_n, prompt_len=[6, 12], max_new_tokens=[4, 8],
              tenant="free", seed=3),
        burst(9.0, "svc", burst_n, rate=2.0, prompt_len=[6, 12],
              max_new_tokens=[4, 8], tenant="gold", seed=4),
        depart(16.0, "trainB"),  # revocation: nodes return to the pool
    ])

    pool = DevicePool(8, pst=[1.0] * 6 + [1.5] * 2,
                      devices=[torch.device(dev)] if dev == "cpu" else None)
    # context manager: the --trace-out stream is closed (and flushed) even
    # if a job raises mid-run
    with ClusterOrchestrator(pool, [trainA, trainB, server], trace,
                             dt=1.0, max_ticks=500,
                             trace_out=args.trace_out) as orch:
        report = orch.run()
    if args.trace_out:
        print(f"per-tick stats streamed to {args.trace_out} "
              f"({report.ticks} lines)")

    print(f"makespan {report.makespan:.0f}s  "
          f"utilization {report.utilization:.2f}  "
          f"Jain fairness {report.fairness_jain:.2f}  "
          f"preemptions {report.preemptions}  "
          f"node migrations {report.migrations}")
    for name, j in report.jobs.items():
        extra = (f"iters {j['iterations_done']}" if j["kind"] == "train"
                 else f"reqs {j['serve']['requests_finished']}"
                      f"/{j['expected_requests']}")
        print(f"  {name:7s} [{j['kind']:5s}] {j['state']:9s} "
              f"node_time {j['node_time']:6.1f}  "
              f"preempted {j['preemptions']}x  {extra}")

    # compact allocation swimlane (one row per job, one column per tick)
    names = list(report.jobs)
    print("\nallocation timeline (nodes per tick):")
    for name in names:
        lane = "".join(format(t.alloc.get(name, 0), "x")
                       for t in report.timeline)
        print(f"  {name:7s} |{lane}|")

    svc = report.jobs["svc"]["serve"]
    assert report.preemptions >= 1, "burst should preempt a trainer"
    assert report.jobs["trainA"]["state"] == "finished"
    assert report.jobs["trainB"]["state"] == "departed"
    assert svc["requests_finished"] == report.jobs["svc"]["expected_requests"]
    assert report.utilization > 0.5
    print("\ncluster mix OK")
