"""LR schedules.

Port of the JAX package's ``optim/schedule.py``: float32 on the step's
device, so that the train step reads its learning rate without a host
sync. Every constant the reference divides by is a float32 0-dim tensor
here (a division by a Python number on the card multiplies by its
rounded reciprocal)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """``lr(step)`` → a float32 0-dim tensor on the step's device: linear
    warmup to ``base_lr``, then a cosine down to ``min_ratio · base_lr``
    at ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        f32 = dict(dtype=torch.float32, device=step.device)
        warm = base_lr * step / torch.full((), max(warmup_steps, 1), **f32)
        frac = torch.clamp(
            (step - warmup_steps)
            / torch.full((), max(total_steps - warmup_steps, 1), **f32),
            0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
