"""MultiKRUM scoring (paper §2.6), twin of ``repro.core.scoring``.

MultiKRUM is similarity-based: it needs *all* models of a round at once, so
it is Sync only (paper Table 3). The accuracy and loss scorers are the
batched engine ``repro_torch.fed.scorebatch``. Scores are negated so that
HIGHER IS BETTER for every method, and each call makes one device->host
transfer of the ``[M]`` scores.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.fed.scorebatch import stack_decoded_vecs
from repro_torch.kernels import ops


def _negated(scores) -> List[float]:
    """lower distance sum = better: ONE device->host transfer"""
    return (-scores.cpu().numpy()).tolist()


def multikrum_scores_for_round(models: Sequence, m: int) -> List[float]:
    """Score every model of a Sync round at once (higher = better).
    models: parameter dicts; m: the neighbourhood size."""
    x, _ = ops.flatten_batch(models)
    return _negated(ops.multikrum_scores(x, m))


def multikrum_scores_for_decoded(decoded: Sequence, m: int) -> List[float]:
    """MultiKRUM over a round's ``DecodedModel``s (higher = better).

    When every model arrived int8-packed with one padded length, the Gram
    matrix comes straight off the packed payloads (``gram_q8``): no f32
    ``[M, N]`` stack. Otherwise (delta envelopes, raw or mixed rounds) the
    models stack into ``[M, n]`` on their device, one batched dequantize
    per int8 length group, and ``gram_and_norms`` takes the stack."""
    if (all(d.is_q8 for d in decoded)
            and len({int(d.q.shape[0]) for d in decoded}) == 1):
        q = torch.stack([d.q for d in decoded])
        s = torch.stack([d.scales for d in decoded])
        return _negated(ops.multikrum_scores_q8(q, s, m))
    d0 = decoded[0]
    device = (d0.q if d0.is_q8 else d0.vec()).device
    x = stack_decoded_vecs(decoded, int(d0.n), device)
    return _negated(ops.multikrum_scores(x, m))


# JL projections are a pure function of (n, sketch_dim, seed): cached, and
# bounded (one [4k, k] f32 projection is large for big models), so evict
MAX_JL_CACHE = 8
_JL_CACHE: "OrderedDict" = OrderedDict()


def _jl_projection(n: int, sketch_dim: int, seed: int):
    """(sampled coordinates, projection [len(idx), k] on the CPU): the
    reference's numpy draws, so both packages sketch alike."""
    key = (n, sketch_dim, seed)
    hit = _JL_CACHE.get(key)
    if hit is None:
        rng = np.random.default_rng(seed)
        k = min(sketch_dim, n)
        # sparse JL: sample 4k coordinates, then a dense gaussian on those
        idx = rng.choice(n, size=min(n, 4 * k), replace=False)
        proj = rng.normal(0, 1.0 / np.sqrt(k), (len(idx), k)).astype(np.float32)
        _JL_CACHE[key] = hit = (torch.from_numpy(idx), torch.from_numpy(proj))
        while len(_JL_CACHE) > MAX_JL_CACHE:
            _JL_CACHE.popitem(last=False)
    else:
        _JL_CACHE.move_to_end(key)
    return hit


def multikrum_sketched(models: Sequence, m: int, *, sketch_dim: int = 4096,
                       seed: int = 0) -> List[float]:
    """MultiKRUM on Johnson-Lindenstrauss sketches (beyond the paper).

    A random projection keeps pairwise L2 distances within (1 +- eps), so
    the krum ranking is stable while the cost per model drops from O(N) to
    O(sketch_dim). The projection is cached per (n, sketch_dim, seed)."""
    vecs = [ops.flatten_pytree(p)[0] for p in models]
    idx, proj = _jl_projection(int(vecs[0].shape[0]), sketch_dim, seed)
    device = vecs[0].device
    idx, proj = idx.to(device), proj.to(device)
    x = torch.stack([v[idx] @ proj for v in vecs])
    return _negated(ops.multikrum_scores(x, m))
