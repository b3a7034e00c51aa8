"""Server-side federated optimizers (Reddi et al., Adaptive Federated
Optimization): FedAvg, FedAdagrad, FedYogi, FedAdam.

The server treats the aggregated client delta as a pseudo-gradient:
  delta = weighted_avg(client_params) - server_params
  FedAvg:  x <- x + eta * delta                      (eta = 1 reproduces paper)
  adaptive: moment updates on delta per the FedOpt family.
``params`` and ``delta`` are nested dicts of tensors or single flat tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_map

F32 = torch.float32


@dataclass(frozen=True)
class ServerOptimizer:
    name: str
    init: Callable
    apply: Callable  # (server_params, delta, state) -> (params, state)


def fedavg(eta: float = 1.0) -> ServerOptimizer:
    def init(params):
        return ()

    def apply(params, delta, state):
        new = tree_map(lambda p, d: (p.to(F32) + eta * d.to(F32)).to(p.dtype),
                       params, delta)
        return new, state

    return ServerOptimizer("fedavg", init, apply)


def _adaptive(name: str, eta: float, b1: float, b2: float, tau: float):
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
                "v": tree_map(lambda p: torch.full_like(p, tau ** 2, dtype=F32),
                              params)}

    def apply(params, delta, state):
        df = tree_map(lambda d: d.to(F32), delta)
        m = tree_map(lambda m, d: b1 * m + (1 - b1) * d, state["m"], df)
        if name == "fedadagrad":
            v = tree_map(lambda v, d: v + d * d, state["v"], df)
        elif name == "fedyogi":
            v = tree_map(lambda v, d: v - (1 - b2) * d * d * torch.sign(v - d * d),
                         state["v"], df)
        else:  # fedadam
            v = tree_map(lambda v, d: b2 * v + (1 - b2) * d * d, state["v"], df)
        new = tree_map(
            lambda p, mi, vi: (p.to(F32) + eta * mi / (torch.sqrt(vi) + tau)
                               ).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v}

    return ServerOptimizer(name, init, apply)


def make_server_optimizer(name: str, *, eta: float = 1.0, b1: float = 0.9,
                          b2: float = 0.99, tau: float = 1e-3) -> ServerOptimizer:
    if name == "fedavg":
        return fedavg(eta)
    if name in ("fedyogi", "fedadam", "fedadagrad"):
        # paper evaluates FedYogi vs FedAvg (Table 5 runs 3 vs 4)
        eta_a = 0.01 if eta == 1.0 else eta
        return _adaptive(name, eta_a, b1, b2, tau)
    raise ValueError(f"unknown server optimizer {name!r}")
