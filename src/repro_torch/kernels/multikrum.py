"""MultiKRUM's Gram matrix and row norms: ``G = X X^T``, ``sq = sum x^2``.

Replaces the Pallas kernel ``repro/kernels/multikrum.py:40``
(``gram_and_norms``); ``ops.pairwise_dists`` forms the distances from it.
CUDA source: ``csrc/multikrum.cu``. Bound on the card: memory, ``4*M*N``
bytes for ``2*M^2*N`` flops at M <= 64. One launch: blocks stream column
units through a ring of ``cp.async`` slabs, sum row-group pairs in
registers, write their partials to scratch, and the last block to take a
ticket sums them in a fixed order.

``x`` is any ``[M, N]`` float32 with unit column stride and row stride >= N
(the paper CNN's unpadded stack, or the strided view of a padded dequantize).
The scratch and the ticket are ``_build.gram_scratch``'s, one pair a device
and stream, shared with ``gram_q8``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_M = 64            # row pairs a block (csrc/multikrum.cu)

_KERNEL = _build.register(
    "gram_and_norms", "repro_gram_and_norms",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p])


def gram_and_norms(x):
    """x: [M, N] f32, row-strided, M <= 64 -> (G [M, M], sq [M, 1]), two
    views of one allocation. The checks are written for a thin host path."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ref.gram_and_norms(x)
        raise ValueError(f"gram_and_norms: no kernel for device {x.device}")
    M, N = x.shape
    s0, s1 = x.stride()
    ld = s0 if M > 1 else N
    if not (x.dtype is torch.float32 and 1 <= M <= MAX_M and N >= 1
            and (s1 == 1 or N == 1) and ld >= N):
        raise ValueError(f"gram_and_norms: need f32 [M, N], 1 <= M <= {MAX_M}"
                         ", unit column stride, row stride >= N; got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    stream = _build.stream_of(x)
    ticket, part = _build.gram_scratch(x, M * (M + 1) // 2, stream)
    out = torch.empty(M * M + M, dtype=torch.float32, device=x.device)
    _KERNEL(x.data_ptr(), ld, M, N, part.data_ptr(), part.numel(),
            ticket.data_ptr(), out.data_ptr(), stream)
    return (out.as_strided((M, M), (M, 1)),
            out.as_strided((M, 1), (1, 1), M * M))
