"""Weighted sum of M flattened models: ``out[n] = sum_m w[m] * x[m, n]``.

Replaces the Pallas kernel ``repro/kernels/wsum.py:27`` (``weighted_sum``),
the intra-silo FedAvg every silo runs every round. CUDA source:
``csrc/wsum.cu``. Bound on the card: memory, ``(M+1) * N * itemsize`` bytes
for ``2 * M * N`` flops; each thread streams 4 outputs as 16-byte loads down
the M rows and sums in float32 registers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE_N = 4096    # the padding contract of ops.weighted_sum (ops.py:144-150)
MAX_M = 1024     # w lives in shared memory

_KERNEL = _build.register(
    "weighted_sum", "repro_weighted_sum",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def weighted_sum(x, w):
    """x: [M, N] f32/bf16 (N % TILE_N == 0); w: [M] -> [N] in x.dtype."""
    if x.device.type == "cpu":
        return ref.weighted_sum(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"weighted_sum: no kernel for device {x.device}")
    M, N = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weighted_sum: x must be f32 or bf16, got {x.dtype}")
    if N % TILE_N or not 1 <= M <= MAX_M or w.shape != (M,):
        raise ValueError(f"weighted_sum: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} (N % {TILE_N}, 1 <= M <= {MAX_M})")
    x = x.contiguous()
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((N,), dtype=x.dtype, device=x.device)
    _KERNEL(_build.ptr(x), _build.ptr(w), _build.ptr(out), M, N,
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    return out
