"""MultiKRUM's Gram matrix and row norms: ``G = X X^T``, ``sq = sum x^2``.

Replaces the Pallas kernel ``repro/kernels/multikrum.py:40``
(``gram_and_norms``); ``ops.pairwise_dists`` forms the distances from it.
CUDA source: ``csrc/multikrum.cu`` (and ``csrc/gram.cuh``). Bound on the
card: memory, ``4*M*N`` bytes for ``2*M^2*N`` flops at M <= 64. N splits
across blocks by whole ``TILE_N`` tiles, each block keeps its row pairs'
sums in registers over an ``[M, 256]`` slab in shared memory, and a second
pass sums the blocks' partials in a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.q8agg import GRAM_MAX_M, launch_gram

TILE_N = 2048    # the padding contract of ops.pairwise_dists

_KERNEL = _build.register(
    "gram_and_norms", "repro_gram_and_norms",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def gram_and_norms(x):
    """x: [M, N] f32 (N % TILE_N == 0, M <= 64) -> (G [M, M], sq [M, 1])."""
    if x.device.type == "cpu":
        return ref.gram_and_norms(x)
    if x.device.type != "cuda":
        raise ValueError(f"gram_and_norms: no kernel for device {x.device}")
    M, N = x.shape
    if x.dtype != torch.float32 or N % TILE_N or not 1 <= M <= GRAM_MAX_M:
        raise ValueError(f"gram_and_norms: need f32 [M, N], N % {TILE_N} == 0"
                         f", 1 <= M <= {GRAM_MAX_M}; got {x.dtype} "
                         f"{tuple(x.shape)}")
    return launch_gram(_KERNEL, x.contiguous(), N // TILE_N, M, N)
