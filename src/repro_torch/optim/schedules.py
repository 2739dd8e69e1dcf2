"""Learning-rate schedules (step -> fp32 tensor lr) — :mod:`repro.optim.
schedules`.  ``step`` may be an int or a 0-d tensor; the arithmetic is
fp32, as under ``jit`` in the reference."""

from __future__ import annotations

import math

import torch


def _f32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    # a fill, not a host-to-device copy: a schedule runs inside the train
    # step, which is captured as a CUDA graph on the card
    return torch.full((), x, dtype=torch.float32, device=device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp((_f32(step, step) + 1) / max(1, warmup_steps), max=1.0)
        return _f32(lr, step) * frac

    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * lr``."""

    def fn(step):
        step = _f32(step, step)
        warm = torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        progress = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0
        )
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return _f32(lr, step) * warm * cos

    return fn
