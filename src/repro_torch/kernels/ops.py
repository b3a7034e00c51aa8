"""Public kernel layer: padding, flattening and dispatch by device.

Twin of ``repro.kernels.ops`` with its padding contract: weighted sums pad
N to ``wsum.TILE_N``, the fused int8 merge pads to ``q8agg.TILE_N`` and
``QPB`` scales, and ``quantize`` pads to ``QUANT_BLOCK`` (131072) on every
device, so wire payloads are byte-identical to the reference's. Each call
goes to its kernel wrapper, which launches the CUDA kernel for a CUDA tensor
and runs the plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.kernels import q8agg as _q8
from repro_torch.kernels import quant as _q
from repro_torch.kernels import wsum as _ws

QTILE = _q.TILE                    # scale granularity of the int8 payload
QUANT_BLOCK = _q.TILE * _q.LANE    # quantize pads to this (131072)


def _pad_to(x, axis: int, multiple: int):
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, pad]
    return F.pad(x, widths)


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
    if spec is None:
        spec = make_flatten_spec(params)
    leaves = tree.leaves(params)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32), spec
    return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves]), spec


def flatten_batch(params_list, spec=None):
    """M params dicts of one config -> ([M, N] f32, spec)."""
    if spec is None:
        spec = make_flatten_spec(params_list[0])
    rows = [tree.leaves(p) for p in params_list]
    if not rows[0]:
        return torch.zeros((len(rows), 0), dtype=torch.float32), spec
    cols = [torch.stack([r[i].reshape(-1).to(torch.float32) for r in rows])
            for i in range(len(rows[0]))]
    return torch.cat(cols, dim=1), spec


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
# Weighted aggregation
# --------------------------------------------------------------------------- #

def weighted_sum(x, w):
    """x: [M, N], w: [M] -> [N]."""
    N = x.shape[1]
    return _ws.weighted_sum(_pad_to(x, 1, _ws.TILE_N), w)[:N]


def _pad_q8(q, scales):
    """Pad [M, Np] int8 + [M, Np/QTILE] scales to the kernel block width.
    Zero-padded q contributes nothing regardless of the padded scale."""
    return (_pad_to(q, q.ndim - 1, _q8.TILE_N),
            _pad_to(scales, scales.ndim - 1, _q8.QPB))


def weighted_sum_q8(q, scales, w, n: int = None):
    """Fused dequantize + weighted sum. q: [M, Np] int8 (Np % QTILE == 0),
    scales: [M, Np/QTILE], w: [M] -> [n] f32 (n defaults to Np)."""
    M, Np = q.shape
    if Np % QTILE:
        raise ValueError(f"quantized payload must be {QTILE}-aligned")
    n = Np if n is None else n
    qp, sp = _pad_q8(q, scales)
    return _q8.wsum_q8(qp, sp, w)[:n]


# --------------------------------------------------------------------------- #
# int8 compression
# --------------------------------------------------------------------------- #

def quantize(x):
    """x: [N] -> (q int8 [Np], scales [Np/QTILE], N), Np padded to
    QUANT_BLOCK on every device (the reference's default path)."""
    N = x.shape[0]
    q, s = _q.quantize(_pad_to(x.to(torch.float32), 0, QUANT_BLOCK))
    return q, s, N


def dequantize(q, scales, n, dtype=torch.float32):
    return _q.dequantize(q, scales, dtype)[:n]


def dequantize_batch(q, scales, n, dtype=torch.float32):
    """q [K, Np] int8 + scales [K, Np/QTILE] -> [K, n] in ONE launch."""
    return _q.dequantize(q, scales, dtype)[:, :n]


# --------------------------------------------------------------------------- #
# Kernels of later slices
# --------------------------------------------------------------------------- #

def _later(name: str, item: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"ops.{name} is not ported yet (ROADMAP.md, queue 2 {item})")
    missing.__name__ = name
    return missing


pairwise_dists = _later("pairwise_dists", "item 8, gram_and_norms")
multikrum_scores = _later("multikrum_scores", "item 8, gram_and_norms")
pairwise_dists_q8 = _later("pairwise_dists_q8", "item 7, gram_q8")
multikrum_scores_q8 = _later("multikrum_scores_q8", "item 7, gram_q8")
add_q8_delta = _later("add_q8_delta", "item 6, add_q8_delta")
wkv6 = _later("wkv6", "item 9, wkv6")
