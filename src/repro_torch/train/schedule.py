"""LR schedules as functions of the step (an int or a scalar tensor) that
return an fp32 scalar tensor.  WSD (Warmup-Stable-Decay) is the MiniCPM
schedule [arXiv:2404.06395 §4]: linear warmup, a constant plateau, then
a decay tail by the square root of its progress.

Counterpart of `repro/train/schedule.py`, in the same fp32 arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def wsd_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                 stable_frac: float = 0.8, final_frac: float = 0.1
                 ) -> Callable:
    decay_start = int(total_steps * stable_frac)
    decay_steps = max(total_steps - decay_start, 1)

    def fn(step):
        step = _step(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        decay = peak_lr * (1.0 - (1.0 - final_frac) * torch.sqrt(frac))
        return torch.where(step < decay_start, warm, decay)
    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    def fn(step):
        step = _step(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                    * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn


def make_schedule(name: str, peak_lr: float, warmup_steps: int,
                  total_steps: int, stable_frac: float = 0.8) -> Callable:
    if name == "wsd":
        return wsd_schedule(peak_lr, warmup_steps, total_steps, stable_frac)
    if name == "cosine":
        return cosine_schedule(peak_lr, warmup_steps, total_steps)
    if name == "constant":
        return lambda step: torch.full((), peak_lr, dtype=torch.float32,
                                       device=_step(step).device)
    raise ValueError(name)
