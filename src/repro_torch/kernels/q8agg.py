"""Fused int8 aggregation: ``out[n] = sum_m w[m] * s[m, n//1024] * q[m, n]``.

Replaces the Pallas kernel ``repro/kernels/q8agg.py:51`` (``wsum_q8``), the
cross-silo merge of int8 peer models, which never builds the f32 ``[M, N]``
matrix. CUDA source: ``csrc/q8agg.cu``. Bound on the card: memory,
``M*N + 4*M*N/1024 + 4*N`` bytes; one block per quantization tile folds
``w[m] * s[m, tile]`` once in shared memory and streams the int8 codes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.quant import TILE as QT

QPB = 4               # quant tiles per block of the reference layout
TILE_N = QPB * QT     # the padding contract of ops._pad_q8 (ops.py:160-176)
MAX_M = 1024          # folded weights live in shared memory

_KERNEL = _build.register(
    "wsum_q8", "repro_wsum_q8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


def wsum_q8(q, scales, w):
    """q: [M, N] int8 (N % TILE_N == 0); scales: [M, N/QT]; w: [M]
    -> [N] f32."""
    if q.device.type == "cpu":
        return ref.wsum_q8(q, scales, w, QT)
    if q.device.type != "cuda":
        raise ValueError(f"wsum_q8: no kernel for device {q.device}")
    M, N = q.shape
    if q.dtype != torch.int8 or N % TILE_N or not 1 <= M <= MAX_M or \
            tuple(scales.shape) != (M, N // QT) or tuple(w.shape) != (M,):
        raise ValueError(f"wsum_q8: bad inputs q{tuple(q.shape)} {q.dtype} "
                         f"scales{tuple(scales.shape)} w{tuple(w.shape)}")
    q = q.contiguous()
    scales = scales.to(torch.float32).contiguous()
    w = w.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=q.device)
    _KERNEL(_build.ptr(q), _build.ptr(scales), _build.ptr(w), _build.ptr(out),
            M, N, _build.stream_of(q))
    return out
