"""Client-side (local) optimizers: SGD(+momentum), Adam/AdamW.

Functional interface over nested dicts of tensors, as in ``repro``:
opt.init(params) -> state; opt.update(grads, state, params, lr) ->
(new_params, new_state). The paper's clients use plain SGD lr=0.01.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        new_params = tree_map(lambda p, m: p - lr * m, params, new_m)
        return new_params, new_m

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": z, "v": tree_map(torch.zeros_like, z), "t": 0}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        gf = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], gf)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], gf)
        # the reference computes the bias corrections in float32
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)

        def step(p, mi, vi):
            upd = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        new_params = tree_map(step, params, m, v)
        return new_params, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def make_optimizer(name: str, *, momentum: float = 0.0,
                   weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(momentum, weight_decay)
    if name in ("adam", "adamw"):
        return adam(weight_decay=weight_decay if name == "adamw" else 0.0)
    raise ValueError(f"unknown optimizer {name!r}")
