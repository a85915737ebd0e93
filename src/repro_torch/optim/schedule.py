"""Learning-rate schedules as plain callables (ports
:mod:`repro.optim.schedule`): ``lr(step)`` for a number or a tensor step,
in fp32."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        s = _f32(step)
        warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, warm, cos(s - warmup))

    return lr
