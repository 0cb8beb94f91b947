"""Learning-rate schedules (port of ``repro.optim.schedule``).  WSD
(warmup-stable-decay, MiniCPM's schedule) is the default; cosine and
constant are provided for ablations."""
from __future__ import annotations

import math

import torch


def lr_schedule(step, *, base_lr: float, warmup: int, total: int = 10_000,
                kind: str = "wsd", decay_frac: float = 0.1,
                min_ratio: float = 0.1) -> torch.Tensor:
    """step: int or integer tensor -> lr, a float32 scalar tensor on the
    step's device (the reference's float32 arithmetic)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    if kind == "const":
        return base_lr * warm
    if kind == "cosine":
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        return base_lr * warm * (min_ratio + (1 - min_ratio)
                                 * 0.5 * (1 + torch.cos(math.pi * t)))
    # WSD: warmup -> stable plateau -> sharp linear decay in the final
    # decay_frac of training (MiniCPM, arXiv:2404.06395 §4)
    decay_steps = decay_frac * total
    decay_start = total - decay_steps
    decay = torch.clamp(1.0 - (step - decay_start) / max(decay_steps, 1),
                        min_ratio, 1.0)
    return base_lr * warm * decay
