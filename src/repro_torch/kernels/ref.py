"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

They are what a wrapper runs on a CPU tensor, and the yardstick a CUDA
kernel is held against on the card: the same arithmetic, written as whole-
tensor operations.
"""
from __future__ import annotations

import torch


def multikrum_dists(x):
    """x: [M, N] flattened models -> pairwise squared L2 [M, M] (f32)."""
    xf = x.to(torch.float32)
    sq = torch.sum(xf * xf, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (xf @ xf.T)
    return torch.clamp(d, min=0.0)


def krum_from_dists(d, m: int):
    """MultiKRUM score per model from its [M, M] distances: the sum of its
    min(m, M-1) smallest distances to the others (lower = more central)."""
    M = d.shape[0]
    d = d + torch.diag(torch.full((M,), float("inf"), device=d.device))
    return torch.sort(d, dim=1).values[:, :min(m, M - 1)].sum(dim=1)


def multikrum_scores(x, m: int):
    """MultiKRUM score per model (lower = better). x: [M, N]."""
    return krum_from_dists(multikrum_dists(x), m)


def weighted_sum(x, w):
    """x: [M, N] models, w: [M] weights -> [N] aggregate (f32 accumulate)."""
    return torch.einsum("m,mn->n", w.to(torch.float32),
                        x.to(torch.float32)).to(x.dtype)


def weighted_sum_ordered(x, w):
    """The weighted_sum kernel's own float32 arithmetic: ``acc = fma(w[m],
    x[m], acc)`` for m = 0..M-1 from 0, each step rounded once, emulated in
    float64. The product is exact there (24 + 24 bits); TwoSum recovers what
    the float64 sum dropped, which decides a float32 tie. Bit for bit what
    the kernel gives, at any layout and vector width; a yardstick for its
    order, not a path of the port. x: [M, N] f32, w: [M] -> [N] f32."""
    acc = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    wf = w.to(device=x.device, dtype=torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    for m in range(x.shape[0]):
        p = wf[m] * x[m].to(torch.float64)
        s = p + acc
        pb = s - acc
        e = (p - pb) + (acc - (s - pb))      # s + e == p + acc exactly
        r = s.to(torch.float32)
        r64 = r.to(torch.float64)
        hi = torch.where(r64 > s, r, torch.nextafter(r, inf))
        lo = torch.where(r64 < s, r, torch.nextafter(r, -inf))
        tie = s == (hi.to(torch.float64) + lo.to(torch.float64)) * 0.5
        r = torch.where(tie & (e > 0), hi, torch.where(tie & (e < 0), lo, r))
        acc = r.to(torch.float64)
    return acc.to(torch.float32)


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


def add_q8_delta(base, q, scales, tile: int = 1024):
    """Fused int8 delta-apply: base [N] f32 + q [N] int8 * scales [N/tile]
    -> [N] f32. ``base + q*s`` is evaluated in float64 (q*s is exact there)
    and rounded once to float32, as a fused multiply-add rounds it: the
    reference's default (Pallas) path compiles ``b + q*s`` into an FMA, and
    its jnp oracle, which rounds the product first, differs from it in the
    last bit for about a quarter of the elements. The reconstructed model is
    the next round's delta base, so those bits reach the wire and the CIDs."""
    N = q.shape[0]
    s = scales.to(torch.float64).repeat_interleave(tile)[:N]
    return (base.to(torch.float64) + q.to(torch.float64) * s).to(torch.float32)


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


def gram_and_norms(x):
    """x: [M, N] -> (G = X X^T [M, M] f32, sq [M, 1] f32)."""
    xf = x.to(torch.float32)
    return xf @ xf.T, torch.sum(xf * xf, dim=1, keepdim=True)


def gram_q8(q, scales, tile: int = 1024):
    """Dequantize, then X X^T and the row norms. q: [M, N] int8, scales:
    [M, N/tile] -> (G [M, M] f32, sq [M, 1] f32)."""
    return gram_and_norms(dequantize_rows(q, scales, tile))


def wkv6_naive(r, k, v, w, u, state):
    """Token-by-token WKV6 recurrence in float32. r, k, v, w: [B, T, H, hs];
    u: [H, hs]; state: [B, H, hs, hs] (key x value) -> (y [B, T, H, hs] in
    r.dtype, state' f32)."""
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhkv,bhk->bhv", S + uf * kv, rf[:, t]))
        S = S * wf[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), S
