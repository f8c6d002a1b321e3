"""LR schedules: the counterpart of ``repro.optim.schedule``."""

from __future__ import annotations

import math
from typing import Callable, Union

import torch


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1
                  ) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """``lr(step)``: linear warmup to ``peak`` over ``warmup_steps``, then
    a cosine decay to ``floor * peak`` at ``total_steps``; float32 on the
    step's device, from a step tensor (no host sync) or an int."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
