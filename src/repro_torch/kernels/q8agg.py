"""Kernels straight off int8 payloads; none builds the f32 models.

``wsum_q8``: ``out[n] = sum_m w[m] * s[m, n//1024] * q[m, n]``, the
cross-silo merge of int8 peers (replaces ``repro/kernels/q8agg.py:51``).
Bound: memory, ``M*n + 4*M*ceil(n/1024) + 4*n`` bytes for the n columns
kept. It takes the caller's ``[M, Np]`` payloads as they are (a stack or a
row-strided view) and writes ``[n]``, reading only the tiles those columns
lie in: a warp a chunk of 512 columns, all of a chunk's code loads before
its FMAs, ``w[m] * s[m, tile]`` folded in registers. Each output is the
FMA chain over m in order from 0, the bits of the reference's kernel
(``ref.weighted_sum_ordered``; ``ref.wsum_q8`` computes just that).

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

GRAM_MAX_M = 64       # gram_q8: models (csrc/gram.cuh)

_KERNEL = _build.register(
    "wsum_q8", "repro_wsum_q8",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p], packed=True)
_ADD_DELTA = _build.register(
    "add_q8_delta", "repro_add_q8_delta",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p])
_GRAM = _build.register(
    "gram_q8", "repro_gram_q8",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def wsum_q8(q, scales, w, n=None):
    """q: [M, Np] int8 (Np % QT == 0; rows may be strided); scales:
    [M, Np/QT]; w: [M] -> the first ``n`` (default Np) columns of the
    merge, [n] f32. The kernel reads only the ceil(n/QT) tiles they lie in.
    The checks are written for a thin host path."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            out = ref.wsum_q8(q, scales, w, QT)
            return out if n is None else out[:n]
        raise ValueError(f"wsum_q8: no kernel for device {q.device}")
    shape, strides = q.shape, q.stride()
    M, Np = shape if len(shape) == 2 else (0, 0)
    n = Np if n is None else n
    ldq = strides[0] if M > 1 else Np
    if not (q.dtype is torch.int8 and M >= 1 and Np % QT == 0
            and 0 < n <= Np and strides[1] == 1 and ldq >= Np
            and scales.shape == (M, Np // QT) and w.shape == (M,)):
        raise ValueError(f"wsum_q8: bad operands q{tuple(shape)} {q.dtype} "
                         f"strides {strides}, scales{tuple(scales.shape)}, "
                         f"w{tuple(w.shape)}, n={n} (q [M, Np], Np % {QT} "
                         "== 0, 1 <= n <= Np, unit column stride)")
    dev = q.get_device()
    if not (scales.dtype is torch.float32 and scales.stride(1) == 1
            and scales.get_device() == dev):
        scales = scales.to(device=q.device, dtype=torch.float32).contiguous()
    if not (w.dtype is torch.float32 and w.is_contiguous()
            and w.get_device() == dev):
        w = w.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    _KERNEL(q.data_ptr(), ldq, scales.data_ptr(),
            scales.stride(0) if M > 1 else Np // QT, w.data_ptr(), M,
            out.data_ptr(), n, _build.raw_stream(dev))
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
