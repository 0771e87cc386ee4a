"""Multi-tenant elastic cluster orchestration (`repro_torch.cluster`).

Chicle's premise is that training is rarely executed alone: resources are
consolidated, and utilization/fairness come from elasticity *across* jobs.
This package closes the loop the single-job engines leave open — instead of
replaying an externally-scripted `ScaleEvent` schedule, a weighted
fair-share allocator decides resize events under contention, and jobs
consume them through the repo's existing elastic paths (micro-task time
projection, `UniTaskEngine` + callable `ElasticScalingPolicy`, and
`ServeEngine.resize`/`suspend`/`resume`).

- `pool`         — simulated heterogeneous device pool (leases, minimal-churn
                   reassignment, per-node speed = the engines' node-pst model)
- `allocator`    — weighted max-min fair shares with priority boost and
                   preemption; pure function of the demand vector (plus an
                   optional `UsageLedger` lookahead: time-decayed usage
                   credit so bursty jobs repay over subsequent ticks)
- `jobs`         — `TrainJob` / `ServeJob` wrappers + `JobSpec`
- `trace`        — JSON-able arrival/departure/burst event traces
- `orchestrator` — the discrete-event tick loop + cluster metrics
                   (makespan, utilization, Jain fairness, preemptions)

The host side (pool, allocator, trace, orchestrator) is the JAX package's
line for line (the pool's default device list aside), so one trace gives
one timeline in both; the jobs drive the port's engines, solvers and
trainers on `device` (CUDA unless the caller passes "cpu").
"""
from .allocator import FairShareAllocator, JobDemand, UsageLedger
from .jobs import (ClusterJob, DisaggServeJob, JobSpec, JobState, LMTrainJob,
                   ServeJob, TrainJob, cocoa_train_job)
from .orchestrator import ClusterOrchestrator, ClusterReport, TickStats
from .pool import DevicePool
from .trace import (ClusterTrace, TraceEvent, arrive, burst, depart, fail,
                    slow)

__all__ = [
    "ClusterJob", "ClusterOrchestrator", "ClusterReport", "ClusterTrace",
    "DevicePool", "DisaggServeJob", "FairShareAllocator", "JobDemand",
    "JobSpec", "JobState", "LMTrainJob", "ServeJob", "TickStats",
    "TraceEvent", "TrainJob", "UsageLedger", "arrive", "burst",
    "cocoa_train_job", "depart", "fail", "slow",
]
