"""Symmetric per-tile int8 quantize / dequantize (the int8 wire format).

``quantize`` replaces ``repro/kernels/quant.py:34``; ``dequantize`` replaces
the body ``_dq_kernel`` that both ``quant.py:79`` (``dequantize``, one
payload) and ``quant.py:55`` (``dequantize_batch``, K payloads in one
launch) run. CUDA source: ``csrc/quant.cu``. Bound on the card: memory —
quantize moves 5 bytes per element (+4 per 1024-tile), dequantize 5 (or 3
for bf16 output). One block per tile with a warp-shuffle amax; ``x / s`` is
an IEEE division and rounding is half-to-even, so codes are bit-exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE = 1024
LANE = 128  # quantization tiles per block of the reference layout

_Q = _build.register(
    "quantize", "repro_quantize",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p])
_DQ = _build.register(
    "dequantize", "repro_dequantize",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_void_p])


def _cuda_only(t, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")


def quantize(x):
    """x: [N] f32 (N % TILE == 0) -> (q int8 [N], scales f32 [N/TILE])."""
    if x.device.type == "cpu":
        return ref.quantize_int8(x, TILE)
    _cuda_only(x, "quantize")
    (N,) = x.shape
    if x.dtype != torch.float32 or N % TILE:
        raise ValueError(f"quantize: need f32 [N], N % {TILE} == 0; got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    q = torch.empty((N,), dtype=torch.int8, device=x.device)
    s = torch.empty((N // TILE,), dtype=torch.float32, device=x.device)
    _Q(_build.ptr(x), _build.ptr(q), _build.ptr(s), N, _build.stream_of(x))
    return q, s


def dequantize(q, scales, dtype=torch.float32):
    """q: [..., N] int8 (N % TILE == 0); scales: [..., N/TILE] -> [..., N]
    in ``dtype`` (f32 or bf16). One launch for any number of rows."""
    if q.device.type == "cpu":
        flat = ref.dequantize_int8(q.reshape(-1), scales.reshape(-1), TILE)
        return flat.reshape(q.shape).to(dtype)
    _cuda_only(q, "dequantize")
    if q.dtype != torch.int8 or q.shape[-1] % TILE or \
            tuple(scales.shape) != (*q.shape[:-1], q.shape[-1] // TILE):
        raise ValueError(f"dequantize: bad inputs q{tuple(q.shape)} {q.dtype} "
                         f"scales{tuple(scales.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize: output must be f32 or bf16, got {dtype}")
    q = q.contiguous()
    scales = scales.to(torch.float32).contiguous()
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    _DQ(_build.ptr(q), _build.ptr(scales), _build.ptr(out), q.numel(),
        int(dtype == torch.bfloat16), _build.stream_of(q))
    return out
