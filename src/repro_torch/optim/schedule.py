"""Learning-rate schedules, including the paper's sqrt(K) elastic scaling.
Each maps a step (int or tensor) to an fp32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant_lr(base: float):
    return lambda step: _f32(base)


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = (_f32(step) / total_steps).clamp(0.0, 1.0)
        return _f32(base) * (final_frac + (1 - final_frac)
                             * 0.5 * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_cosine(base: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_lr(base, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = _f32(step)
        warm = _f32(base) * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))
    return fn


def elastic_sqrt_k(base: float, k: int):
    """alpha' = alpha * sqrt(K) — the paper's elastic LR rule (§5.1)."""
    return base * math.sqrt(k)
