# Counterpart of src/repro/optim/schedule.py; nothing of it is left unported.
"""LR schedules (pure functions of the step), evaluated in f32 as the
reference's ``jnp`` versions are.  ``step`` is an int or an integer tensor;
the result is an f32 scalar tensor on the step's device (the CPU for an
int)."""
from __future__ import annotations

import math
from typing import Callable

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup_cosine(lr: float, warmup: int, total: int,
                         final_frac: float = 0.1) -> Callable:
    def f(step):
        s = _step_f32(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, lr * cos)
    return f


def constant(lr: float) -> Callable:
    def f(step):
        dev = step.device if isinstance(step, torch.Tensor) else "cpu"
        return torch.full((), lr, dtype=torch.float32, device=dev)
    return f
