"""LR schedules (the JAX package's ``optim/schedule.py``): functions of
the step, computed in float32 on a tensor step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then a cosine down to
    ``min_ratio · base_lr`` at ``total_steps``; a float32 scalar on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
