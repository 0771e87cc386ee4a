"""Chicle core substrate used by serving: mobile slot-chunks
(`chunks`), elastic scaling / load-balancing policies (`policies`) and the
weighted fair-share arithmetic (`fairshare`)."""
from .chunks import Assignment, ChunkStore
from .fairshare import (
    integerize_shares,
    jain_index,
    stride_pick,
    weighted_max_min,
)
from .policies import (
    ElasticScalingPolicy,
    Policy,
    RebalancePolicy,
    ScaleEvent,
    ShufflePolicy,
    StragglerMitigationPolicy,
)

__all__ = [
    "Assignment", "ChunkStore", "ElasticScalingPolicy", "Policy",
    "RebalancePolicy", "ScaleEvent", "ShufflePolicy",
    "StragglerMitigationPolicy", "integerize_shares", "jain_index",
    "stride_pick", "weighted_max_min",
]
