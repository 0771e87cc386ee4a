"""Roofline terms of a step on one NVIDIA H100, the counterpart of the
reference's `launch/hlo_analysis.py` (whose constants are a TPU v5e's).

compute = flops / peak (by the config's dtype)
memory  = bytes / HBM rate

Constants are the published rates of the H100 SXM part (NVIDIA's data
sheet, dense, at its 700 W limit): bf16 tensor cores 989e12 FLOP/s, fp32
CUDA cores 67e12, HBM3 3.35e12 B/s.  A step on one card moves nothing over
a link, so the reference's collective term and its `parse_collectives`
(which reads HLO text) have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12  # bytes/s


@dataclasses.dataclass
class Roofline:
    flops: float  # total counted flops
    bytes_accessed: float
    compute_s: float
    memory_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.compute_s, self.memory_s)

    def row(self) -> Dict[str, float]:
        return dict(dataclasses.asdict(self), bound_s=self.bound_s)


def roofline_terms(*, flops: float, bytes_accessed: float,
                   model_flops: float, dtype: str = "bfloat16") -> Roofline:
    compute_s = flops / PEAK_FLOPS[dtype]
    memory_s = bytes_accessed / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / flops if flops else 0.0
    return Roofline(
        flops=flops, bytes_accessed=bytes_accessed, compute_s=compute_s,
        memory_s=memory_s, bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful)


def model_flops_for(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (N = active params)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    toks = shape.global_batch  # one token per sequence
    return 2.0 * n_active * toks
