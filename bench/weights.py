"""Weights and seeds of a run, made by the benchmark: the same seed gives
the same bits, on the device, in a few large draws.

A family's reference lists its leaves (``param_specs``): path, shape,
dtype and init. All normal leaves come from one float32 draw and all
uniform ones from another, each leaf a slice of it, scaled and cast to
its dtype; constant and formula leaves ('ones', 'zeros', 'value') are
made on the device as they are. Every pod starts from the same weights:
the federation's model at the start of a round.
"""
from __future__ import annotations

import hashlib

import torch

F32 = torch.float32


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run, from ``--seed`` of any size."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def make(specs, seed: int, device) -> dict:
    """{path: tensor} from ``specs`` [(path, shape, dtype, init)]."""
    g = generator(seed, "weights", device)
    count = lambda shape: int(torch.Size(shape).numel())
    by_kind = {"normal": 0, "uniform": 0}
    for _, shape, _, init in specs:
        if init[0] in by_kind:
            by_kind[init[0]] += count(shape)
    normal = torch.randn(by_kind["normal"], generator=g, device=device,
                         dtype=F32)
    uniform = torch.rand(by_kind["uniform"], generator=g, device=device,
                         dtype=F32)
    used = {"normal": 0, "uniform": 0}
    out = {}
    for path, shape, dtype, init in specs:
        n = count(shape)
        kind = init[0]
        if kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            out[path] = fill(shape, dtype=dtype, device=device)
            continue
        if kind == "value":
            out[path] = init[1](device).reshape(shape).to(dtype)
            continue
        src = normal if kind == "normal" else uniform
        x = src[used[kind]:used[kind] + n].view(shape)
        used[kind] += n
        if kind == "normal":
            out[path] = (x * init[1]).to(dtype)
        elif kind == "uniform":
            lo, hi = init[1], init[2]
            out[path] = (x * (hi - lo) + lo).to(dtype)
        else:
            raise ValueError(f"{path}: unknown init {init}")
    return out


def nest(flat: dict) -> dict:
    """{'a/b': t} -> {'a': {'b': t}}: the program's parameter tree."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def flatten(tree, prefix: str = "") -> dict:
    """Inverse of ``nest``, keys in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def stack(flat: dict, pods: int) -> dict:
    """Every leaf repeated over a leading pod dimension."""
    return {p: x.unsqueeze(0).expand(pods, *x.shape).contiguous()
            for p, x in flat.items()}
