"""Learning-rate schedules (port of ``repro/optim/schedules.py``): each
maps a step to an f32 lr tensor on the step's device, computed in f32 as
the reference computes it, so the optimizers can read the step as a
tensor inside captured code."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return fn


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        # the cosine of the f32 angle, correctly rounded to f32 (through
        # f64): torch's f32 cos misses that by an ulp where XLA's rarely
        # does, and the schedule scales the miss to ~3 ulp of the lr
        c = torch.cos((math.pi * t).to(torch.float64)).to(torch.float32)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (1 + c)
        return torch.where(step < warmup, warm, cos)
    return fn


def inverse_sqrt(lr: float, warmup: int = 100):
    """η = lr/√max(step, warmup), the theorem's η = 1/√E choice."""
    def fn(step):
        step = _f32(step)
        return lr / torch.sqrt(torch.clamp(step, min=warmup))
    return fn
