"""LR schedules as ``step -> lr`` callables (PyTorch counterpart of
``repro.optim.schedule``); ``step`` is an int32 tensor, the result a
float32 tensor on its device.

Division rule: the reference divides the step by a Python constant, which
XLA turns into a multiplication by the constant's float32 reciprocal; the
port multiplies by :func:`repro_torch.device.recip_f32` of it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import recip_f32


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _warm(s: torch.Tensor, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((s + 1.0) * recip_f32(max(warmup_steps, 1)),
                       max=1.0)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        return lr * _warm(step.to(torch.float32), warmup_steps)
    return f


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_fraction: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = _warm(s, warmup_steps) if warmup_steps else 1.0
        frac = torch.clamp((s - warmup_steps) * recip_f32(
            max(total_steps - warmup_steps, 1)), 0, 1)
        cos = final_fraction + (1 - final_fraction) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return lr * warm * cos
    return f
