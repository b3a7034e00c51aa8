"""The UnifyFL exchange over stacked pods, written plainly: one scale a
leaf int8 coding, the score matrix collapsed by its policy, the policy's
weight row of each pod, and each pod's merge ``sum_j W[i, j] g_j`` in
float32, cast to the leaf's dtype. The semantics are the paper's round as
the JAX package states it (``repro/core/exchange.py``); nothing here
imports the program.

Trees are lists of ``{path: tensor}`` dicts, one a pod.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def q8(x):
    """-> (int8 codes as float32, float32 scale): the scale is the leaf's
    largest magnitude times f32(1/127) (1.0 for an all-zero leaf), codes
    rounded half to even and clipped to +-127."""
    x = x.to(F32)
    amax = x.abs().amax()
    scale = amax * (1.0 / 127.0) if float(amax) > 0 else \
        torch.ones_like(amax)
    return torch.round(x / scale).clamp(-127, 127), scale


def dq8(codes, scale, dtype):
    return (codes * scale).to(dtype)


def gather(pods, compression: str):
    """The models every pod receives: each pod's leaves, int8-coded and
    decoded back to their dtype under ``int8``."""
    if compression == "none":
        return pods
    if compression != "int8":
        raise ValueError(compression)
    return [{p: dq8(*q8(x), x.dtype) for p, x in pod.items()}
            for pod in pods]


def collapse(mat, how: str):
    """[scorer, model] -> [model]."""
    if how == "median":
        s = torch.sort(mat, dim=0).values
        n = mat.shape[0]
        return (s[(n - 1) // 2] + s[n // 2]) * 0.5
    if how == "mean":
        return mat.mean(dim=0)
    if how == "min":
        return mat.amin(dim=0)
    if how == "max":
        return mat.amax(dim=0)
    raise ValueError(how)


def policy_row(scores, me: int, ex: dict):
    """Pod ``me``'s weights over the n models, self included."""
    n = scores.shape[0]
    policy = ex["policy"]
    row = torch.zeros(n, dtype=F32)
    if policy == "all":
        return torch.full((n,), 1.0 / n, dtype=F32)
    if policy == "self":
        row[me] = 1.0
        return row
    peers = [j for j in range(n) if j != me]
    vals = [float(scores[j]) for j in peers]
    if policy == "top_k":
        k = min(ex.get("k", 1), n - 1)
        thresh = sorted(vals)[-k]
        picked = [j for j, s in zip(peers, vals) if s >= thresh]
    elif policy == "above_average":
        avg = sum(vals) / len(vals)
        picked = [j for j, s in zip(peers, vals) if s >= avg]
    else:
        raise ValueError(policy)
    mix = ex.get("mix_rate", 0.5)
    if not picked:
        row[me] = 1.0
        return row
    for j in picked:
        row[j] = (1.0 - mix) / len(picked)
    row[me] = mix
    return row


def merge(gathered, W):
    """Pod i's leaves: sum_j W[i, j] gathered_j in float32, in the leaf's
    dtype."""
    out = []
    for i in range(W.shape[0]):
        pod = {}
        for p, x in gathered[0].items():
            acc = torch.zeros(x.shape, dtype=F32, device=x.device)
            for j, g in enumerate(gathered):
                acc += float(W[i, j]) * g[p].to(F32)
            pod[p] = acc.to(x.dtype)
        out.append(pod)
    return out


def mean(pods):
    """The 'all' policy without scoring: every pod gets the float32 mean."""
    m = {}
    for p, x in pods[0].items():
        acc = torch.zeros(x.shape, dtype=F32, device=x.device)
        for pod in pods:
            acc += pod[p].to(F32)
        m[p] = (acc / len(pods)).to(x.dtype)
    return [m for _ in pods]
