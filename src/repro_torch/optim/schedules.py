"""Learning-rate schedules: callables of the int32 step tensor (a
cohort's per-client ``(n_c,)`` counter) returning the fp32 lr, the
reference's formulas op for op."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32,
                                   device=step.device)


def linear_warmup(base_lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
        return base_lr * frac
    return fn


def cosine_decay(base_lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        t = torch.clamp(step.float() / max(decay_steps, 1), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * ((1 - alpha) * cos + alpha)
    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    wu = linear_warmup(base_lr, warmup_steps)
    cd = cosine_decay(base_lr, max(decay_steps - warmup_steps, 1), alpha)

    def fn(step):
        return torch.where(step < warmup_steps, wu(step),
                           cd(step - warmup_steps))
    return fn
