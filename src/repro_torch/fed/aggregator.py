"""Silo-level aggregation: FedAvg over client weights + the FedOpt family for
applying cross-silo deltas (paper Table 5 mixes FedAvg and FedYogi silos).

The cross-silo merge runs in flat-vector space end to end: peer models
arrive as ``DecodedModel``s (int8 peers still packed), quantized peers flow
through the fused ``wsum_q8`` kernel without materializing as f32, and the
caller unflattens the merged vector back into its params exactly once.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.wire import DecodedModel
from repro_torch.kernels import ops
from repro_torch.optim.fedopt import ServerOptimizer, make_server_optimizer


def _normalized(weights: Sequence[float]) -> np.ndarray:
    """Weights normalised in float64, then cast to f32 (as the reference)."""
    w = np.asarray(weights, np.float64)
    return (w / w.sum()).astype(np.float32)


def fedavg_params(params_list: Sequence, weights: Sequence[float]):
    """Sample-count-weighted average of parameter dicts (kernel-backed).
    The weights stay on the host: the kernel takes up to 64 by value."""
    vecs, spec = ops.flatten_batch(params_list)
    w = torch.from_numpy(_normalized(weights))
    return ops.unflatten_pytree(ops.weighted_sum(vecs, w), spec)


class SiloAggregator:
    """Aggregates client updates within one silo and applies cross-silo
    models via a configurable server optimizer (fedavg / fedyogi / ...)."""

    def __init__(self, silo_id: str, server_opt: str = "fedavg"):
        self.silo_id = silo_id
        self.server_opt: ServerOptimizer = make_server_optimizer(server_opt)
        self._opt_state = None

    def aggregate_clients(self, results: List[Tuple]):
        """results: [(params, n_samples, loss)] -> silo local model."""
        return fedavg_params([r[0] for r in results], [r[1] for r in results])

    def apply_cross_silo_vec(self, own_vec, peers: List[DecodedModel],
                             weights: List[float]):
        """Merge peer models into the silo's flat f32 vector [n].

        weights[0] is the self-weight; weights[1:] align with ``peers``.
        int8 peers are grouped by padded length and consumed by one fused
        kernel call per group; f32 peers add their (cached) vectors."""
        if not peers:
            return own_vec
        w = _normalized(weights)
        n = int(own_vec.shape[0])
        mixed = float(w[0]) * own_vec
        groups: dict = {}
        f32_peers = []
        for wi, p in zip(w[1:], peers):
            if p.is_q8:
                groups.setdefault(int(p.q.shape[0]), []).append((wi, p))
            else:
                f32_peers.append((wi, p))
        for grp in groups.values():
            gw = torch.tensor([float(wi) for wi, _ in grp],
                              dtype=torch.float32, device=own_vec.device)
            # the [M, N] code stack lives only for the call
            mixed = mixed + ops.weighted_sum_q8(
                torch.stack([p.q for _, p in grp]),
                torch.stack([p.scales for _, p in grp]), gw, n)
        for wi, p in f32_peers:
            mixed = mixed + float(wi) * p.vec()[:n]
        # mixed - own, then own + eta * delta: the reference's order, so the
        # float32 roundings match; mixed goes before the server step makes
        # its two vectors
        delta = mixed - own_vec
        del mixed
        if self._opt_state is None:
            self._opt_state = self.server_opt.init(own_vec)
        new, self._opt_state = self.server_opt.apply(own_vec, delta,
                                                     self._opt_state)
        return new

    def apply_cross_silo(self, own_params, peer_params: List,
                         weights: List[float]):
        """Params-facing wrapper over the flat-vector merge."""
        if not peer_params:
            return own_params
        spec = ops.make_flatten_spec(own_params)
        own_vec, _ = ops.flatten_pytree(own_params, spec)
        peers = [DecodedModel(int(v.shape[0]), vec=v)
                 for v, _ in (ops.flatten_pytree(p, spec) for p in peer_params)]
        new_vec = self.apply_cross_silo_vec(own_vec, peers, weights)
        return ops.unflatten_pytree(new_vec, spec)
