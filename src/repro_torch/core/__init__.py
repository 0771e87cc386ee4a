"""Chicle core: the paper's primary contribution — uni-tasks, mobile stateful
data chunks, elastic scaling + load-balancing policies, and the lSGD/CoCoA
solvers that run on top of them (PyTorch; the solvers run on CUDA unless
the caller passes device="cpu")."""
from .chunks import Assignment, ChunkStore
from .cocoa import CoCoASolver, duality_gap
from .engine import (
    IterationRecord,
    MicroTaskEmulator,
    UniTaskEngine,
    epochs_to_target,
    microtask_schedule_len,
    time_to_target,
)
from .fairshare import (
    integerize_shares,
    jain_index,
    stride_pick,
    weighted_max_min,
)
from .local_sgd import LocalSGDSolver
from .policies import (
    ElasticScalingPolicy,
    Policy,
    RebalancePolicy,
    ScaleEvent,
    ShufflePolicy,
    StragglerMitigationPolicy,
)

__all__ = [
    "Assignment", "ChunkStore", "CoCoASolver", "duality_gap",
    "IterationRecord", "MicroTaskEmulator", "UniTaskEngine",
    "epochs_to_target", "microtask_schedule_len", "time_to_target",
    "LocalSGDSolver", "ElasticScalingPolicy", "Policy", "RebalancePolicy",
    "ScaleEvent", "ShufflePolicy", "StragglerMitigationPolicy",
    "integerize_shares", "jain_index", "stride_pick", "weighted_max_min",
]
