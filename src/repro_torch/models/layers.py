"""Shared layer helpers (the part of ``repro.models.layers`` the CNN uses)."""
from __future__ import annotations

import math

import torch


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(generator: torch.Generator, shape, in_axis_size, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) init drawn from ``generator`` on the CPU
    (the same numbers on every device), then moved to ``device``."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=generator) * scale
    return w.to(device=device, dtype=dtype)
