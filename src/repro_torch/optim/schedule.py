"""LR schedules (the reference's ``optim/schedule.py``), computed in f32
as the reference computes them. ``step`` is an int or a tensor; the
result is a 0-d f32 tensor on ``step``'s device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup: int, peak: float):
    s = torch.as_tensor(step, dtype=torch.float32)
    return peak * torch.clamp((s + 1) / max(1, warmup), max=1.0)


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor: float = 0.0):
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak * torch.clamp((s + 1) / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)
