"""Mixture-of-Experts layer: top-k routing, capacity-bounded, sort-free
dispatch. Twin of ``repro.models.moe``.

On plain tensors it is the reference's no-mesh branch, ``_moe_local`` over
all experts. On DTensors of a mesh with a ``model`` axis it is the
reference's two shardings over that axis, one ``local_map`` body a rank
(DTensor has no rule for the dispatch's index put):

  - 'ep': experts partitioned (olmoe: 64 experts / 16 ranks). Tokens are
    replicated over ``model``; each rank routes its token block over all
    experts and runs its own expert block (``_moe_shard``, the reference's
    ``_moe_local_offset``); the partial outputs are summed over ``model``
    (a Partial -> Replicate redistribute, the all-reduce).
  - 'tp': every rank holds all experts with the ff dim sharded (mixtral:
    8 experts < 16 ranks); the same sum adds the ff partials.

The load-balance loss is each token block's, averaged over the batch axes
(the reference's ``pmean`` over data and model of values equal on every
``model`` rank), summed as each block's loss over the block count. Under 'fsdp' the batch axes take ``model`` too; the port
keeps the tokens replicated over ``model`` there (batch over the other
batch axes only), since a sum over ``model`` of partial outputs is only
the layer's output when every ``model`` rank holds the same tokens.

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

from repro_torch import pshard
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


def _moe_local(p, x2d, cfg: ModelConfig, info=None):
    """Route tokens [T, D] to every expert. Returns (out [T, D], aux);
    ``info``, if given, receives the routing it used (``idx``, ``buf_idx``
    [E, C], ``slot``)."""
    T, D = x2d.shape
    probs, idx, aux, buf_idx, slot = route_and_dispatch(p["router"], x2d,
                                                        cfg)
    if info is not None:
        info.update(idx=idx, buf_idx=buf_idx, slot=slot)
    # gather tokens (the sentinel T gathers a zero row)
    xpad = torch.cat([x2d, x2d.new_zeros((1, D))])
    y = _experts(p, xpad[buf_idx], cfg)                 # [E, C, D]
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


def _experts(p, xe, cfg: ModelConfig):
    """Expert MLPs over dispatched tokens xe [E, C, D] -> [E, C, D]."""
    h = torch.bmm(xe, p["wi"].to(xe.dtype))
    if cfg.gated_mlp:
        g = torch.bmm(xe, p["wg"].to(xe.dtype))
        h = L._act(cfg.mlp_act)(g) * h
    else:
        h = L._act(cfg.mlp_act)(h)
    return torch.bmm(h, p["wo"].to(xe.dtype))


def route_and_dispatch(router_w, x2d, cfg: ModelConfig):
    """The routing every shard computes alike: (probs [T, k], idx [T, k],
    aux, buf_idx [E, C], slot [T, k])."""
    C = _capacity(x2d.shape[0], cfg)
    probs, idx, aux = _route(router_w, x2d, cfg)
    buf_idx, slot = _dispatch_indices(idx, cfg.moe.n_experts, C)
    return probs, idx, aux, buf_idx, slot


def _moe_shard(p_l, x2d, cfg: ModelConfig, e_lo: int, e_per: int,
               info=None):
    """EP shard body (the reference's ``_moe_local_offset``): tokens [T, D]
    routed over every expert, the local expert block [e_lo, e_lo + e_per)
    run -> (partial out [T, D]: each token's picks of this block, in
    ascending expert id; aux). ``info``, if given, receives the dispatch
    the block ran: ``idx``, its rows of ``buf_idx`` and ``slot`` with the
    other blocks' picks -1."""
    T, D = x2d.shape
    probs, idx, aux, buf_idx, slot = route_and_dispatch(p_l["router"], x2d,
                                                        cfg)
    xpad = torch.cat([x2d, x2d.new_zeros((1, D))])
    rows = buf_idx[e_lo:e_lo + e_per]
    y = _experts(p_l, xpad[rows], cfg)
    local = (idx >= e_lo) & (idx < e_lo + e_per)
    slot = torch.where(local, slot, -1)
    if info is not None:
        info.update(idx=idx, buf_idx=rows, slot=slot)
    return _combine(y, idx - e_lo, slot, probs), aux


def moe_block(p, x, cfg: ModelConfig):
    """x [B, S, D] -> (out [B, S, D], aux scalar)."""
    B, S, D = x.shape
    if pshard._is_dtensor(x) and "model" in x.device_mesh.mesh_dim_names:
        return _moe_sharded(p, x, cfg)
    out, aux = _moe_local(p, x.reshape(-1, D), cfg)
    return out.reshape(B, S, D), aux


def _moe_sharded(p, x, cfg: ModelConfig):
    """The ``model``-axis branches on DTensors (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mdim = names.index("model")
    n_model = mesh.size(mdim)
    ep = m.sharding == "ep" and m.n_experts % n_model == 0
    with pshard.use_mesh(mesh):
        bd = pshard.resolve_spec(pshard.BATCH)[0]
    bd = tuple(a for a in ((bd,) if isinstance(bd, str) else bd or ())
               if a != "model") or None
    x = pshard.place(x, mesh, bd, None, None)
    x_pl = tuple(x.placements)
    if ep:
        w_spec = {"router": (None, None), "wi": ("model", None, None),
                  "wo": ("model", None, None), "wg": ("model", None, None)}
    else:
        w_spec = {"router": (None, None), "wi": (None, None, "model"),
                  "wo": (None, "model", None), "wg": (None, None, "model")}
    keys = [k for k in ("router", "wi", "wo", "wg") if k in p]
    ws = [pshard.place_as(p[k], mesh, pshard.placements(w_spec[k], mesh))
          for k in keys]
    varies = {mdim} | {j for j, pl in enumerate(x_pl) if pl.is_shard()}
    e_per = m.n_experts // n_model if ep else m.n_experts
    mi = mesh.get_local_rank(mdim) if ep else 0
    n_blocks = 1
    for j, pl in enumerate(x_pl):
        n_blocks *= mesh.size(j) if pl.is_shard() else 1
    # every model rank holds the same aux: the first adds it, the others
    # add zero (kept on the graph, so every rank's backward runs alike);
    # the token blocks' mean as a sum of aux / n_blocks (a Partial('avg')
    # output's gradient reaches each rank undivided)
    aux_w = (1.0 if mesh.get_local_rank(mdim) == 0 else 0.0) / n_blocks

    def body(xl, *wl):
        p_l = dict(zip(keys, wl))
        xl2 = xl.reshape(-1, D)
        if ep:
            out, aux = _moe_shard(p_l, xl2, cfg, mi * e_per, e_per)
        else:
            out, aux = _moe_local(p_l, xl2, cfg)
        return out.reshape(xl.shape), aux * aux_w

    D = x.shape[-1]
    out_pl = tuple(Partial() if j == mdim else pl for j, pl in
                   enumerate(x_pl))
    aux_pl = tuple(Partial() if j == mdim or pl.is_shard() else Replicate()
                   for j, pl in enumerate(x_pl))
    fn = local_map(
        body, out_placements=(out_pl, aux_pl),
        in_placements=(x_pl,) + tuple(tuple(w.placements) for w in ws),
        in_grad_placements=(pshard.grad_placements(x_pl, {mdim}),) + tuple(
            pshard.grad_placements(tuple(w.placements), varies)
            for w in ws),
        device_mesh=mesh)
    out, aux = fn(x, *ws)
    return (out.redistribute(mesh, x_pl),
            aux.redistribute(mesh, (Replicate(),) * mesh.ndim))
