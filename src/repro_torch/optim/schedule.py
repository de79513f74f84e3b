"""Learning-rate schedules (``repro.optim.schedule``): WSD (warmup-stable-
decay, MiniCPM) and cosine, computed in f32 as the reference computes them,
so that lr is exactly 0 at step 0."""
from __future__ import annotations

import math

import torch

__all__ = ["wsd_schedule", "cosine_schedule"]


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def wsd_schedule(*, peak: float, warmup: int, total: int, decay_frac: float = 0.1,
                 floor: float = 0.0):
    """Warmup-Stable-Decay (arXiv:2404.06395): linear warmup, long stable
    plateau at `peak`, then a short exponential-style decay tail. The
    returned ``sched(step)`` gives a 0-d f32 tensor on the step's device."""
    decay_steps = max(1, int(total * decay_frac))
    stable_end = total - decay_steps

    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        tail = peak * torch.exp(-5.0 * (step - stable_end) / decay_steps)
        return torch.where(step < warmup, warm,
                           torch.where(step < stable_end, torch.full_like(step, peak),
                                       torch.clamp(tail, min=floor)))

    return sched


def cosine_schedule(*, peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return sched
