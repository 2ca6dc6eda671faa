"""Learning-rate schedules (pure functions of the step), counterpart of
``repro.optim.schedule``: the step is a tensor (the optimizer's int32
``step``) or an int, the rate a float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step).float()
        t = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(step - warmup))

    return lr
