"""Public kernel layer: flattening and dispatch by device.

Twin of ``repro.kernels.ops``. Every call hands the caller's tensors to
its kernel wrapper as they are, with the length to keep where it differs
from the operand's: ``quantize`` gives the reference's wire payload, the
codes of x zero-padded to ``QUANT_BLOCK`` (131072) on every device, but
the kernel writes that padding itself; ``weighted_sum_q8``,
``dequantize``, ``dequantize_batch`` and ``add_q8_delta`` take the
payloads (whole 1024-tiles, rows may be strided) and write only the
``n`` columns kept; the int8 Gram takes any whole number of 1024-tiles;
the f32 weighted sum and Gram take ``[M, N]`` at any N with a row stride
(views included). The reference pads these inside its own ``ops`` for
its Pallas grids; nothing here pads or slices. Each call goes to its
kernel wrapper, which launches the CUDA kernel for a CUDA tensor and
runs the plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels import multikrum as _mk
from repro_torch.kernels import q8agg as _q8
from repro_torch.kernels import quant as _q
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6 as _rwkv
from repro_torch.kernels import wsum as _ws

QTILE = _q.TILE                    # scale granularity of the int8 payload
QUANT_BLOCK = _q.TILE * _q.LANE    # the wire payload's length unit (131072)


# --------------------------------------------------------------------------- #
# Flatten helpers (model params <-> single vector), JAX leaf order
# --------------------------------------------------------------------------- #

class FlattenSpec(NamedTuple):
    paths: Tuple[tuple, ...]
    shapes: Tuple[tuple, ...]
    dtypes: Tuple[torch.dtype, ...]


def make_flatten_spec(params) -> FlattenSpec:
    items = tree.leaves_with_paths(params)
    return FlattenSpec(tuple(p for p, _ in items),
                       tuple(tuple(l.shape) for _, l in items),
                       tuple(l.dtype for _, l in items))


def flatten_pytree(params, spec=None):
    """Params -> (vector f32 [N], spec), leaves in sorted-key order."""
    vecs, spec = flatten_batch([params], spec)
    return vecs[0], spec


def flatten_batch(params_list, spec=None):
    """M params dicts of one config -> ([M, N] f32, spec). Each leaf is
    cast straight into its place: no f32 copy of a leaf, no second [M, N]
    (at full width a [2, N] f32 stack is 13.8 GB of qwen3-1.7b)."""
    if spec is None:
        spec = make_flatten_spec(params_list[0])
    rows = [tree.leaves(p) for p in params_list]
    if not rows[0]:
        return torch.zeros((len(rows), 0), dtype=torch.float32), spec
    out = torch.empty((len(rows), spec_length(spec)), dtype=torch.float32,
                      device=rows[0][0].device)
    off = 0
    for i, n in enumerate(_sizes(spec)):
        for m, r in enumerate(rows):
            out[m, off:off + n].copy_(r[i].reshape(-1))
        off += n
    return out, spec


def _sizes(spec: FlattenSpec) -> List[int]:
    return [int(np.prod(s)) if s else 1 for s in spec.shapes]


def unflatten_pytree(vec, spec: FlattenSpec):
    leaves, off = [], 0
    for n, shape, dtype in zip(_sizes(spec), spec.shapes, spec.dtypes):
        leaves.append(vec[off:off + n].reshape(shape).to(dtype))
        off += n
    return tree.unflatten(list(spec.paths), leaves)


def unflatten_batch(mat, spec: FlattenSpec):
    """[K, N] f32 -> params dict with leaves [K, *shape]."""
    K = mat.shape[0]
    leaves, off = [], 0
    for n, shape, dtype in zip(_sizes(spec), spec.shapes, spec.dtypes):
        leaves.append(mat[:, off:off + n].reshape((K,) + shape).to(dtype))
        off += n
    return tree.unflatten(list(spec.paths), leaves)


def spec_length(spec: FlattenSpec) -> int:
    """True (unpadded) flattened length of a spec's params."""
    return sum(_sizes(spec))


# --------------------------------------------------------------------------- #
# MultiKRUM
# --------------------------------------------------------------------------- #

def _dists(g, sq):
    return torch.clamp(sq + sq.T - 2.0 * g, min=0.0)


def pairwise_dists(x):
    """x: [M, N] (views too) -> pairwise squared L2 [M, M]."""
    return _dists(*_mk.gram_and_norms(x.to(torch.float32)))


def multikrum_scores(x, m: int):
    """Sum of squared distances to the m nearest peers (lower = better)."""
    return _ref.krum_from_dists(pairwise_dists(x), m)


# --------------------------------------------------------------------------- #
# Weighted aggregation
# --------------------------------------------------------------------------- #

def weighted_sum(x, w):
    """x: [M, N] (views too), w: [M] on the host or x's device -> [N]."""
    return _ws.weighted_sum(x, w)


def weighted_sum_q8(q, scales, w, n: int = None):
    """Fused dequantize + weighted sum. q: [M, Np] int8 (Np % QTILE == 0,
    rows may be strided), scales: [M, Np/QTILE], w: [M] -> [n] f32 (n
    defaults to Np). Nothing is padded or sliced: the kernel reads the
    tiles the n columns lie in and writes [n]."""
    Np = q.shape[-1]
    if Np % QTILE:
        raise ValueError(f"quantized payload must be {QTILE}-aligned")
    return _q8.wsum_q8(q, scales, w, n)


def add_q8_delta(base, q, scales, n: int = None):
    """Fused delta-apply: base [>= n] f32 + dequantized int8 delta, one pass.
    q: [Np] int8 (Np % QTILE == 0, Np >= n), scales: [Np/QTILE] -> [n] f32
    without building the f32 delta (n defaults to len(base)). Nothing is
    padded or sliced: the kernel takes these tensors as they are."""
    n = int(base.shape[0]) if n is None else n
    if q.shape[0] % QTILE:
        raise ValueError(f"delta payload must be {QTILE}-aligned")
    return _q8.add_q8_delta(base, q, scales, n)


def pairwise_dists_q8(q, scales):
    """Fused dequantize + pairwise squared L2 of quantized models [M, M].
    q: [M, Np] int8 (Np % QTILE == 0), scales: [M, Np/QTILE], unpadded: the
    kernel takes any whole number of tiles."""
    return _dists(*_q8.gram_q8(q, scales))


def multikrum_scores_q8(q, scales, m: int):
    """MultiKRUM scores straight off the int8 payloads (lower = better)."""
    return _ref.krum_from_dists(pairwise_dists_q8(q, scales), m)


# --------------------------------------------------------------------------- #
# int8 compression
# --------------------------------------------------------------------------- #

def quantize(x):
    """x: [N] -> (q int8 [Np], scales [Np/QTILE], N), Np = N rounded up to
    QUANT_BLOCK on every device (the reference's default path): the codes
    of x zero-padded to Np, the padding written by the kernel itself."""
    N = x.shape[0]
    q, s = _q.quantize(x.to(torch.float32), N + (-N) % QUANT_BLOCK)
    return q, s, N


def dequantize(q, scales, n, dtype=torch.float32):
    """q [Np] int8 + scales [Np/QTILE] -> [n] in ``dtype``, contiguous; only
    the n values kept are written."""
    return _q.dequantize(q, scales, dtype, n)


def dequantize_batch(q, scales, n, dtype=torch.float32):
    """q [K, Np] int8 + scales [K, Np/QTILE] -> [K, n] in ONE launch: a
    row-strided view (row stride n rounded up to 16 bytes) holding only the
    n columns kept."""
    return _q.dequantize(q, scales, dtype, n)


# --------------------------------------------------------------------------- #
# WKV6
# --------------------------------------------------------------------------- #

def wkv6(r, k, v, w, u, state):
    """r, k, v, w: [B, T, H, hs]; u: [H, hs]; state: [B, H, hs, hs] f32 ->
    (y [B, T, H, hs] in r.dtype, state' f32). Any T: the kernel masks its
    tail chunk per token, so the reference's chunk padding and head folding
    go away. On the card through ``rwkv6.WKV6``, whose backward is the
    ``wkv6_backward`` kernel, when a gradient is taken, else the forward
    kernel alone; on the CPU the plain scan, differentiated by autograd."""
    return _rwkv.wkv6(r, k, v, w, u, state)
