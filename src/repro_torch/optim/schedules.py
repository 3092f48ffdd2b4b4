"""LR schedules: functions of the step counter, computed in f32 on its
device (port of `repro.optim.schedules`)."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine"]


def constant(lr: float):
    """lr at every step: an f32 0-d tensor on the step's device."""
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0
        )
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
