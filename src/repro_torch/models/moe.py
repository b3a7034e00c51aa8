"""Mixture-of-Experts layer on one device: top-k routing, capacity-bounded,
sort-free dispatch. Twin of ``repro.models.moe`` without a mesh: the
reference's no-mesh branch, ``_moe_local`` over all experts.

Routing picks each token's top k experts from a stable descending sort, so
ties go to the lower expert id, as ``lax.top_k`` breaks them. Capacity
ranks come from an exclusive one-hot cumsum in token-major order (earlier
tokens win); a pick over its expert's capacity is dropped (GShard) and its
token keeps the other picks' contributions. At decode with batch B the
capacity is ``ceil(B k / E cf)``: 1 for OLMoE at batch 4, so a token whose
expert an earlier token of the batch already took loses that contribution.
That is the reference's semantics, kept as it is.

The combine is deterministic: each token sums its kept contributions in
ascending expert id, in the output dtype, as the reference's expert-major
scatter adds them (no atomics, so the bf16 bits repeat from run to run).
The expert products are batched matmuls in plain PyTorch; no TPU kernel
stands behind this layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def init_moe(generator: torch.Generator, cfg: ModelConfig, device,
             n_layers: int):
    """One ``[n_layers, ...]`` stack of MoE weights; the router stays
    float32 whatever the param dtype."""
    e, d, f, n = cfg.moe.n_experts, cfg.d_model, cfg.d_ff, n_layers
    pd = L.dtype_of(cfg.param_dtype)
    p = {"router": L.dense_init(generator, (n, d, e), d, torch.float32,
                                device),
         "wi": L.dense_init(generator, (n, e, d, f), d, pd, device),
         "wo": L.dense_init(generator, (n, e, f, d), f, pd, device)}
    if cfg.gated_mlp:
        p["wg"] = L.dense_init(generator, (n, e, d, f), d, pd, device)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(1, min(n_tokens, c))


def _route(router_w, x2d, cfg: ModelConfig):
    """x2d [T, D] -> (top_p [T, k] in x's dtype, top_i [T, k], aux)."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :m.top_k], top_i[:, :m.top_k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = m.n_experts
    f_e = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    return top_p.to(x2d.dtype), top_i, aux


def _dispatch_indices(top_i, n_experts: int, capacity: int):
    """Sort-free capacity ranking. top_i: [T, k] expert ids. Returns
    (buf_idx [E, C] token indices, T in empty slots; slot_of [T, k], the
    capacity slot or -1 where the pick was dropped)."""
    T, k = top_i.shape
    flat = top_i.reshape(-1)          # token-major: earlier tokens win
    onehot = F.one_hot(flat, n_experts)
    ranks = torch.cumsum(onehot, dim=0) - onehot    # exclusive rank
    my_rank = torch.gather(ranks, 1, flat[:, None])[:, 0]
    keep = my_rank < capacity
    n_slots = n_experts * capacity
    # kept picks land on distinct slots; dropped ones on one spare slot
    dest = torch.where(keep, flat * capacity + my_rank, n_slots)
    buf = torch.full((n_slots + 1,), T, dtype=top_i.dtype,
                     device=top_i.device)
    buf[dest] = torch.arange(T, device=top_i.device).repeat_interleave(k)
    slot = torch.where(keep, my_rank, -1).reshape(T, k)
    return buf[:n_slots].reshape(n_experts, capacity), slot


def _moe_local(p, x2d, cfg: ModelConfig):
    """Route tokens [T, D] to every expert. Returns (out [T, D], aux)."""
    m = cfg.moe
    T, D = x2d.shape
    C = _capacity(T, cfg)
    probs, idx, aux = _route(p["router"], x2d, cfg)
    buf_idx, slot = _dispatch_indices(idx, m.n_experts, C)
    # gather tokens (the sentinel T gathers a zero row)
    xpad = torch.cat([x2d, x2d.new_zeros((1, D))])
    xe = xpad[buf_idx]                                  # [E, C, D]
    h = torch.bmm(xe, p["wi"].to(xe.dtype))
    if cfg.gated_mlp:
        g = torch.bmm(xe, p["wg"].to(xe.dtype))
        h = L._act(cfg.mlp_act)(g) * h
    else:
        h = L._act(cfg.mlp_act)(h)
    y = torch.bmm(h, p["wo"].to(xe.dtype))              # [E, C, D]
    return _combine(y, idx, slot, probs), aux


def _combine(y, top_i, slot, top_p):
    """Expert outputs y [E, C, D] back to token order [T, D]: each token's
    kept picks summed in ascending expert id, in y's dtype, each output row
    scaled by its router probability (cast to y's dtype), as the
    reference's expert-major scatter-add sums them; a dropped pick (slot
    -1) reads a zero row."""
    E, C, D = y.shape
    order = torch.argsort(top_i, dim=-1, stable=True)
    e_s, s_s = torch.gather(top_i, 1, order), torch.gather(slot, 1, order)
    p_s = torch.gather(top_p, 1, order).to(y.dtype)
    src = torch.where(s_s >= 0, e_s * C + s_s, E * C)
    rows = torch.cat([y.reshape(-1, D), y.new_zeros((1, D))])
    out = torch.zeros((top_i.shape[0], D), dtype=y.dtype, device=y.device)
    for j in range(top_i.shape[1]):
        out = out + rows[src[:, j]] * p_s[:, j, None]
    return out


def moe_block(p, x, cfg: ModelConfig):
    """x [B, S, D] -> (out [B, S, D], aux scalar)."""
    B, S, D = x.shape
    out, aux = _moe_local(p, x.reshape(-1, D), cfg)
    return out.reshape(B, S, D), aux
