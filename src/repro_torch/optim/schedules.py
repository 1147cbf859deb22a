"""Learning-rate schedules (the counterpart of ``repro.optim.schedules``):
callables on the step count, a 0-d tensor (the optimizer's ``count``) or a
number; the result is an fp32 tensor."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.float()
    return torch.tensor(float(step))


def linear_warmup(peak_lr: float, warmup_steps: int):
    def sched(step):
        s = _step(step)
        return peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return sched


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def sched(step):
        s = _step(step)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                    1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return peak_lr * warm * cos
    return sched
