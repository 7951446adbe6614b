"""Learning-rate schedules: functions of the step, computed in float32 on
the host as the reference (``repro.optim.schedule``) computes them.  Each
returns a 0-dim float32 CPU tensor."""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float) -> torch.Tensor:
    return peak * torch.clamp((_f32(step) + 1) / max(warmup_steps, 1),
                              max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    peak: float, floor: float = 0.0) -> torch.Tensor:
    warm = linear_warmup(step, warmup_steps, peak)
    frac = torch.clamp((_f32(step) - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
    return torch.where(_f32(step) < warmup_steps, warm, cos)
