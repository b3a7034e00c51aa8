"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

They are what a wrapper runs on a CPU tensor, and the yardstick a CUDA
kernel is held against on the card: the same arithmetic, written as whole-
tensor operations.
"""
from __future__ import annotations

import torch


def weighted_sum(x, w):
    """x: [M, N] models, w: [M] weights -> [N] aggregate (f32 accumulate)."""
    return torch.einsum("m,mn->n", w.to(torch.float32),
                        x.to(torch.float32)).to(x.dtype)


def quantize_int8(x, tile: int = 1024):
    """Symmetric per-tile int8 quantization. x: [N] (N % tile == 0).
    Returns (q int8 [N], scales f32 [N/tile])."""
    xt = x.to(torch.float32).reshape(-1, tile)
    amax = xt.abs().amax(dim=1)
    # amax * (1/127), not amax / 127: the reference's default (Pallas) path
    # compiles its division by the constant into this product, and the two
    # differ in the last bit for some tiles (its jnp oracle divides)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    # torch.round rounds half to even, like jnp.round
    q = torch.clamp(torch.round(xt / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_int8(q, scales, tile: int = 1024):
    qt = q.reshape(-1, tile).to(torch.float32)
    return (qt * scales[:, None]).reshape(-1)


def dequantize_rows(q, scales, tile: int = 1024):
    """q: [M, N] int8, scales: [M, N/tile] -> [M, N] f32."""
    M, N = q.shape
    qt = q.reshape(M, N // tile, tile).to(torch.float32)
    return (qt * scales[:, :, None]).reshape(M, N)


def wsum_q8(q, scales, w, tile: int = 1024):
    """Dequantize, then weighted sum. q: [M, N] int8, scales: [M, N/tile],
    w: [M] -> [N] f32."""
    x = dequantize_rows(q, scales, tile)
    return torch.einsum("m,mn->n", w.to(torch.float32), x)
