"""LR schedules (twin of ``repro.optim.schedules``). WSD
(warmup-stable-decay) is MiniCPM's training recipe.

Each schedule maps a step to a float32 0-d tensor computed in float32, as
the reference computes it in ``jnp.float32``.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def make_schedule(name: str, base_lr: float, total_steps: int, *,
                  warmup_steps: int = 0, decay_frac: float = 0.1):
    if name == "constant":
        return lambda step: _f32(base_lr)
    if name == "wsd":
        decay_start = int(total_steps * (1.0 - decay_frac))

        def wsd(step):
            step = _f32(step)
            warm = base_lr * torch.clamp((step + 1) / max(1, warmup_steps),
                                         max=1.0)
            decay_span = max(1, total_steps - decay_start)
            decay = base_lr * torch.exp(
                -5.0 * torch.clamp(step - decay_start, min=0.0) / decay_span)
            return torch.where(step < warmup_steps, warm,
                               torch.where(step < decay_start, _f32(base_lr),
                                           decay))
        return wsd
    if name == "cosine":
        def cos(step):
            step = _f32(step)
            warm = (step + 1) / max(1, warmup_steps)
            prog = torch.clamp((step - warmup_steps)
                               / max(1, total_steps - warmup_steps), 0.0, 1.0)
            return base_lr * torch.minimum(
                warm, 0.5 * (1 + torch.cos(math.pi * prog)))
        return cos
    raise ValueError(f"unknown schedule {name!r}")
