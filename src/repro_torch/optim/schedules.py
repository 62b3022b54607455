"""Learning-rate schedules (port of ``repro.optim.schedules``): each maps
a 0-d int tensor of the step to a 0-d float32 tensor on its device."""

from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay_lr(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return f


def warmup_cosine_lr(lr: float, warmup_steps: int, total_steps: int,
                     final_frac: float = 0.1):
    cosine = cosine_decay_lr(lr, max(total_steps - warmup_steps, 1),
                             final_frac)

    def f(step):
        t = step.to(torch.float32)
        warm = lr * t / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cosine(step - warmup_steps))
    return f
