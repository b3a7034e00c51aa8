"""Kernels straight off int8 payloads; none builds the f32 models.

``wsum_q8``: ``out[n] = sum_m w[m] * s[m, n//1024] * q[m, n]``, the
cross-silo merge of int8 peers (replaces ``repro/kernels/q8agg.py:51``).
Bound: memory, ``M*N + 4*M*N/1024 + 4*N`` bytes; one block per quantization
tile folds ``w[m] * s[m, tile]`` once in shared memory.

``add_q8_delta``: ``out = base + q * s``, rounded once (an FMA), the rebuild
of an ``int8-delta`` envelope onto its base (replaces ``q8agg.py:77``).
Bound: memory, ``9*n + 4*n/1024`` bytes; 4 elements a thread below 2^20
(the paper CNN's n spreads over every SM), 16 from there on. It takes the
caller's base unpadded, at any 4-byte alignment, and writes ``[n]``.

``gram_q8``: the Gram matrix and row norms of the dequantized models,
int8 x int8 -> int32 exact per 1024-tile, scaled and summed across tiles in
f32 (replaces ``q8agg.py:122``). Bound: memory, ``M*N + 4*M*N/1024`` bytes.
One launch: a warp sums a tile at a time from registers (``__dp4a``, an
exact int32 warp sum, one scale a tile and pair), and the last block to
take a ticket sums the blocks' partials in a fixed order (no atomics, so
the MultiKRUM scores repeat exactly). Any whole number of 1024-tiles, so
``ops`` hands over the payloads unpadded.

CUDA source: ``csrc/q8agg.cu`` (and ``csrc/gram.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.quant import TILE as QT

QPB = 4               # quant tiles per block of the reference layout
TILE_N = QPB * QT     # the padding contract of ops._pad_q8 (ops.py:160-176)
MAX_M = 1024          # folded weights live in shared memory
GRAM_MAX_M = 64       # gram_q8: models (csrc/gram.cuh)

_KERNEL = _build.register(
    "wsum_q8", "repro_wsum_q8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
_ADD_DELTA = _build.register(
    "add_q8_delta", "repro_add_q8_delta",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p])
_GRAM = _build.register(
    "gram_q8", "repro_gram_q8",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


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


def add_q8_delta(base, q, scales, n=None):
    """base: [>= n] f32, q: [Np] int8 (Np % QT == 0, n <= Np), scales:
    [Np/QT] -> [n] f32 = base + q * s, one rounding (n defaults to
    len(base)). The base may be any unit-stride view (an offset, a row of a
    [K, n] stack). The checks are written for a thin host path."""
    n = base.shape[0] if n is None else n
    if not q.is_cuda:
        if q.device.type == "cpu":
            return ref.add_q8_delta(base[:n], q[:n], scales, QT)
        raise ValueError(f"add_q8_delta: no kernel for device {q.device}")
    Np = q.shape[0] if q.dim() == 1 else 0
    if not (q.dtype is torch.int8 and Np % QT == 0 and Np > 0
            and q.is_contiguous() and 0 < n <= Np and base.dim() == 1
            and base.shape[0] >= n and scales.shape == (Np // QT,)):
        raise ValueError(f"add_q8_delta: bad operands base{tuple(base.shape)} "
                         f"q{tuple(q.shape)} {q.dtype} "
                         f"scales{tuple(scales.shape)}, n={n} (q [Np], "
                         f"Np % {QT} == 0, 1 <= n <= Np, len(base) >= n)")
    dev = q.get_device()
    if not (base.dtype is torch.float32 and base.is_contiguous()
            and base.get_device() == dev):
        base = base[:n].to(device=q.device, dtype=torch.float32).contiguous()
    if not (scales.dtype is torch.float32 and scales.is_contiguous()
            and scales.get_device() == dev):
        scales = scales.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _ADD_DELTA(base.data_ptr(), q.data_ptr(), scales.data_ptr(),
               out.data_ptr(), n, _build.raw_stream(dev))
    return out


def gram_rows(q):
    """``q`` [M, N] and its row stride as ``gram_q8``'s kernel reads them:
    unit column stride, row stride and base address in whole 16-byte
    vectors; else a copy in a fresh allocation (``contiguous`` would hand
    back a contiguous tensor whose base is misaligned as it is)."""
    M, N = q.shape
    ld = q.stride(0) if M > 1 else N
    if q.stride(1) != 1 or ld % 16 or q.data_ptr() % 16:
        return q.clone(memory_format=torch.contiguous_format), N
    return q, ld


def gram_q8(q, scales):
    """q: [M, N] int8 (N % QT == 0, M <= 64, rows may be strided); scales:
    [M, N/QT] -> (G [M, M] f32, sq [M, 1] f32) of the dequantized models,
    two views of one allocation."""
    if q.device.type == "cpu":
        return ref.gram_q8(q, scales, QT)
    if q.device.type != "cuda":
        raise ValueError(f"gram_q8: no kernel for device {q.device}")
    M, N = q.shape
    if q.dtype != torch.int8 or N % QT or N == 0 or \
            not 1 <= M <= GRAM_MAX_M or tuple(scales.shape) != (M, N // QT):
        raise ValueError(f"gram_q8: bad inputs q{tuple(q.shape)} {q.dtype} "
                         f"scales{tuple(scales.shape)} (N % {QT} == 0, "
                         f"1 <= M <= {GRAM_MAX_M})")
    q, ld = gram_rows(q)
    if scales.dtype != torch.float32 or scales.stride(1) != 1:
        scales = scales.to(torch.float32).contiguous()
    stream = _build.stream_of(q)
    ticket, part = _build.gram_scratch(q, M * (M + 1) // 2, stream)
    out = torch.empty(M * M + M, dtype=torch.float32, device=q.device)
    _GRAM(q.data_ptr(), ld, scales.data_ptr(), scales.stride(0) if M > 1
          else N // QT, M, N, part.data_ptr(), part.numel(),
          ticket.data_ptr(), out.data_ptr(), stream)
    return (out.as_strided((M, M), (M, 1)),
            out.as_strided((M, 1), (1, 1), M * M))
