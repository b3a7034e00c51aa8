"""Shared layers, twin of ``repro.models.layers``: norms, RoPE, grouped-query
attention (chunked online softmax for prefill, a gather for decode), the
MLP, the embedding and the logits.

Norms, softmax and cross-entropy compute in float32 whatever the compute
dtype, and every cast is the reference's: attention scores accumulate in
float32 (the reference's ``preferred_element_type``: the operands go in as
float32, whose products of bf16 values are exact), the probabilities are
cast to ``v``'s dtype before ``p @ v``, and each weight is cast to the
activation dtype before its product. Attention is plain PyTorch, as the
reference's is plain ``jnp``: no TPU kernel stands behind it.

The reference's sharding constraints stand at the same points as
``pshard.constrain`` calls: on DTensors under an installed mesh they
redistribute, on plain tensors they return their argument. ``remat``
wraps a family's layer body in ``torch.utils.checkpoint`` by
``cfg.remat``, as the reference wraps its scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import pshard
from repro_torch.config import ModelConfig


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(generator: torch.Generator, shape, in_axis_size, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) init drawn from ``generator`` on the
    generator's device (a CPU generator gives the same numbers on every
    device), then moved to ``device``."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * scale).to(device=device, dtype=dtype)


def layer_at(tree, i: int):
    """Slice ``i`` of every leaf of a tree of ``[n, ...]`` stacked layers."""
    return {k: (layer_at(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def unstack_layers(tree, n: int):
    """The ``n`` slices of a tree of ``[n, ...]`` stacked layers, each leaf
    unbound once. Under a gradient a stacked leaf then gets its ``[n, ...]``
    gradient as one stack of its slices' gradients; ``layer_at`` in a loop
    gives it a zero-filled ``[n, ...]`` tensor a layer, summed."""
    parts = {k: (unstack_layers(v, n) if isinstance(v, dict)
                 else torch.unbind(v)) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    outputs of products without batch dims (``mm``, ``addmm``) are saved,
    everything else is recomputed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(body, mode: str):
    """``body`` rematerialised by ``mode``: 'full' keeps only its inputs
    and recomputes it in the backward (``jax.checkpoint``), 'dots' keeps
    its weight products' outputs too, 'none' keeps everything. Without a
    gradient being taken, or inside a ``torch.func`` transform (which
    takes no saved-tensor hooks), ``body`` runs as it is: the values are
    the same bits either way."""
    if mode not in ("full", "dots", "none"):
        raise ValueError(f"remat: unknown mode {mode!r}")
    if mode == "none":
        return body

    def run(*args):
        if not torch.is_grad_enabled() or \
                torch._C._functorch.maybe_current_level() is not None:
            return body(*args)
        if mode == "full":
            return ckpt.checkpoint(body, *args, use_reentrant=False)
        return ckpt.checkpoint(
            body, *args, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_dots))
    return run


def remat_forwards(mode: str) -> int:
    """The times a training step runs a layer's whole forward when
    ``cfg.remat`` is ``mode``: twice under 'full', whose backward
    recomputes it, once otherwise ('dots' recomputes only what lies
    between the saved products; RWKV-6, the RG-LRU and the
    encoder-decoder take 'dots' as 'none')."""
    return 2 if mode == "full" else 1


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #

def rms_norm(x, scale, eps=1e-6, zero_centered=False):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    if zero_centered:
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-6):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable). Rotates in
    float32 and casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, hd/2]
    ang = ang[..., None, :]                         # [..., S, 1, hd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention (chunked online-softmax for prefill, gather for decode)
# --------------------------------------------------------------------------- #

ATTN_CHUNK = 1024  # KV-chunk size: keeps scores O(S * chunk) not O(S^2)
NEG = -1e30        # the reference's mask value


def _gqa_scores(q, k):
    """q: [B,S,KV,G,hd]; k: [B,T,KV,hd] -> scores [B,KV,G,S,T] in f32."""
    return torch.einsum("bskgh,btkh->bkgst", q.to(torch.float32),
                        k.to(torch.float32))


def _gqa_out(p, v):
    """p: [B,KV,G,S,T]; v: [B,T,KV,hd] -> [B,KV,G,S,hd] in v's dtype."""
    return torch.einsum("bkgst,btkh->bkgsh", p.to(v.dtype), v)


def _kv_reader(q_shape, kv_shape, mesh, q_pl, kv_pl):
    """The slice of a rank's local k and v heads that its local q heads
    read (q head h reads KV head h // G): a function of local k, v."""
    G = q_shape[2] // kv_shape[2]
    (_, _, n_h, _), (_, _, h0, _) = pshard.local_shape_and_offset(
        q_shape, mesh, q_pl)
    kv_lo = pshard.local_shape_and_offset(kv_shape, mesh, kv_pl)[1][2]
    lo, n_kv = h0 // G - kv_lo, max(1, n_h // G)

    def read(k, v):
        if k.shape[2] == n_kv:
            return k, v
        return k[:, :, lo:lo + n_kv], v[:, :, lo:lo + n_kv]
    return read


def _by_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (attention, q [B, S, H, hd], k and v
    [B, T, KV, hd]) on DTensors, one ``local_map`` body a rank: DTensor
    has no rule for the grouped-query products once the head dim is
    sharded. Each rank takes its q heads and, from a k and v replicated
    over the head-sharding axes, the KV heads those q heads read (head h
    reads h // G); k's and v's gradients are then partial over those
    axes. Plain tensors: ``fn`` itself."""
    if not pshard._is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    q_pl = tuple(q.placements)
    b_pl = tuple(p if p.is_shard(0) else Replicate() for p in q_pl)
    head_dims = {j for j, p in enumerate(q_pl) if p.is_shard(2)}
    # k, v: the batch as q's; their heads sharded alike where q's heads
    # split whole KV groups, else replicated and sliced in the body
    h_local = pshard.local_shape_and_offset(q.shape, mesh, q_pl)[0][2]
    kv_pl = tuple(Shard(2) if j in head_dims and h_local >= G else b_pl[j]
                  for j in range(mesh.ndim))
    k, v = (pshard.place_as(a, mesh, kv_pl) for a in (k, v))
    read = _kv_reader(q.shape, k.shape, mesh, q_pl, kv_pl)

    def body(ql, kl, vl):
        return fn(ql, *read(kl, vl), **kw)

    kv_grad = pshard.grad_placements(kv_pl, head_dims)
    return local_map(body, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def chunked_attention(q, k, v, *, q_offset, window: Optional[int],
                      causal: bool = True):
    """Online-softmax attention over KV chunks of ATTN_CHUNK keys.

    q: [B, S, H, hd] grouped into KV groups internally. k, v: [B, T, KV,
    hd], padded with zeros to whole chunks; padded keys, and keys outside
    the causal or sliding window, get an additive NEG. q_offset: absolute
    position of q[0] minus that of k[0]. ``m``, ``l`` and ``acc`` are f32.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd) * (1.0 / math.sqrt(hd))
    n_chunks = max(1, (T + ATTN_CHUNK - 1) // ATTN_CHUNK)
    pad_T = n_chunks * ATTN_CHUNK
    if pad_T != T:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_T - T))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_T - T))
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        lo = c * ATTN_CHUNK
        k_blk, v_blk = k[:, lo:lo + ATTN_CHUNK], v[:, lo:lo + ATTN_CHUNK]
        s = _gqa_scores(qg, k_blk)                       # [B,KV,G,S,C]
        kv_pos = lo + torch.arange(ATTN_CHUNK, device=q.device)
        valid = (kv_pos < T)[None, :]
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
        s = s + torch.where(valid, 0.0, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _gqa_out(p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, n_valid: int):
    """Single-token attention against a cache. q: [B, 1, H, hd]; caches:
    [B, W, KV, hd]; the first ``n_valid`` slots hold keys (in a rolling
    cache in any order: positions were rotary-encoded at write time)."""
    B, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd) * (1.0 / math.sqrt(hd))
    s = _gqa_scores(qg, k_cache)                         # [B,KV,G,1,W]
    valid = torch.arange(W, device=q.device) < n_valid
    s = torch.where(valid, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = _gqa_out(p, v_cache)                           # [B,KV,G,1,hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd)
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# Attention block (projections + rope + norm)
# --------------------------------------------------------------------------- #

def init_attention(generator: torch.Generator, cfg: ModelConfig, device,
                   n_layers: int):
    """One ``[n_layers, ...]`` stack of attention weights."""
    hd = cfg.resolved_head_dim
    d, L = cfg.d_model, n_layers
    pd = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(generator, (L, d, cfg.n_heads, hd), d, pd, device),
        "wk": dense_init(generator, (L, d, cfg.n_kv_heads, hd), d, pd,
                         device),
        "wv": dense_init(generator, (L, d, cfg.n_kv_heads, hd), d, pd,
                         device),
        "wo": dense_init(generator, (L, cfg.n_heads, hd, d),
                         cfg.n_heads * hd, pd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, cfg.n_heads, hd), dtype=pd, device=device)
        p["bk"] = torch.zeros((L, cfg.n_kv_heads, hd), dtype=pd,
                              device=device)
        p["bv"] = torch.zeros((L, cfg.n_kv_heads, hd), dtype=pd,
                              device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=pd, device=device)
        p["k_norm"] = torch.ones((L, hd), dtype=pd, device=device)
    return p


def _heads(x, w):
    """x [B, S, D] @ w [D, H, hd] -> [B, S, H, hd], w cast to x's dtype."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(
        -1, w.shape[1:])


def _project_qkv(p, x, cfg: ModelConfig, positions, kv_heads=None):
    """q, k, v after bias, norm and rope; ``kv_heads`` (default
    ``_heads``) projects k and v."""
    kv_heads = kv_heads or _heads
    q, k, v = _heads(x, p["wq"]), kv_heads(x, p["wk"]), kv_heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = pshard.constrain(q, pshard.BATCH, None, "model", None)
    k = pshard.constrain(k, pshard.BATCH, None,
                         "model" if cfg.n_kv_heads >= 16 else None, None)
    return q, k, v


def _out_proj(out, wo):
    """out [B, S, H, hd] @ wo [H, hd, D] -> [B, S, D]."""
    return out.flatten(-2) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])


def attention_block(p, x, cfg: ModelConfig, *, positions, causal=True):
    """Full-sequence self attention (prefill). Returns (out, (k, v))."""
    if pshard._is_dtensor(x):
        return _attention_tp(p, x, cfg, positions, causal)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, q_offset=0, window=cfg.attn_window,
                            causal=causal)
    return _out_proj(out, p["wo"]), (k, v)


class _ScatteredGradProduct(torch.autograd.Function):
    """``x @ w`` for a ``w`` replicated over a group whose ranks each read
    part of the product's columns (a replicated k read by q-head shards):
    the forward computes the whole product on every rank; the backward
    reduce-scatters the product's partial gradient by column blocks, so
    each rank forms its block of dw (all-gathered: dw is replicated) and
    its partial dx. XLA partitions the reference's program so (its
    per-device FLOPs show the backward's products at a 1/n share)."""

    @staticmethod
    def forward(ctx, x, w, group, n: int):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.n = group, n
        return x @ w

    @staticmethod
    def backward(ctx, g):
        import warnings
        from torch.distributed import _functional_collectives as funcol
        x, w = ctx.saved_tensors
        n, group = ctx.n, ctx.group
        c = w.shape[1] // n
        r = torch.distributed.get_rank(group)
        with warnings.catch_warnings():
            # newer torch renames these two (``*_single``); both do
            warnings.simplefilter("ignore", FutureWarning)
            g_l = funcol.reduce_scatter_tensor(
                g.reshape(-1, w.shape[1]).t().contiguous(), "sum", 0, group)
            g_l = g_l.t()                               # [tokens, c]
            dx = (g_l @ w[:, r * c:(r + 1) * c].t()).reshape(x.shape)
            dw_l = x.reshape(-1, x.shape[-1]).t() @ g_l     # [D, c]
            dw = funcol.all_gather_tensor(dw_l.t().contiguous(), 0,
                                          group).t()
        return dx, dw, None, None


def _tp_dims(h_pl, dim: int) -> set:
    """Mesh dims on which a hidden activation's ``dim`` is sharded."""
    return {j for j, q in enumerate(h_pl) if q.is_shard(dim)}


def _local_block(body, mesh, ins, in_pls, grad_pls, out_pls):
    """``local_map(body)`` over DTensors placed as ``in_pls``; ``out_pls``
    a list of placements for one output, a tuple of them for several."""
    from torch.distributed.tensor.experimental import local_map
    ins = [pshard.place_as(t, mesh, pl) for t, pl in zip(ins, in_pls)]
    return local_map(body, out_placements=out_pls,
                     in_placements=tuple(in_pls),
                     in_grad_placements=tuple(grad_pls),
                     device_mesh=mesh)(*ins)


def _attention_tp(p, x, cfg: ModelConfig, positions, causal):
    """``attention_block`` on DTensors, tensor-parallel as the reference's
    constraints make XLA's program: q (and k, v where the KV heads split
    over ``model``) sharded by heads, the rest of a layer's inputs
    replicated over those axes, the output a partial sum all-reduced by
    the closing ``constrain``. One ``local_map`` body a rank (DTensor's
    own strategies gather whole weights in the backward); a rank whose q
    heads read only some of a replicated k's heads slices them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q_pl = pshard.spec_placements((B, S, H, hd), mesh, pshard.BATCH, None,
                                  "model", None)
    k_pl = pshard.spec_placements(
        (B, S, KV, hd), mesh, pshard.BATCH, None,
        "model" if KV >= 16 else None, None)
    tp, kv_tp = _tp_dims(q_pl, 2), _tp_dims(k_pl, 2)
    x_pl = tuple(Replicate() if j in tp else q for j, q in enumerate(q_pl))
    n = mesh.ndim
    # a k and v replicated over q's head shards: their products' backward
    # by column blocks over that group (_ScatteredGradProduct)
    scatter = len(tp) == 1 and not kv_tp and \
        (KV * hd) % mesh.size(min(tp)) == 0
    kv_heads = None
    if scatter:
        j = min(tp)
        group, size = mesh.get_group(j), mesh.size(j)

        def kv_heads(xl, w):
            wf = w.to(xl.dtype).reshape(w.shape[0], -1)
            return _ScatteredGradProduct.apply(xl, wf, group, size) \
                .unflatten(-1, w.shape[1:])
    heads = lambda dims, d: tuple(Shard(d) if j in dims else Replicate()
                                  for j in range(n))
    w_pl = {"wq": heads(tp, 1), "wk": heads(kv_tp, 1), "wv": heads(kv_tp, 1),
            "wo": heads(tp, 0), "bq": heads(tp, 0), "bk": heads(kv_tp, 0),
            "bv": heads(kv_tp, 0), "q_norm": heads((), 0),
            "k_norm": heads((), 0)}
    keys = [k for k in w_pl if k in p]
    varies = tp | {j for j, q in enumerate(x_pl) if q.is_shard()}
    batch_dims = varies - tp
    # the scattered products hand back whole (replicated) dw over tp
    w_grad = {k: pshard.grad_placements(
        w_pl[k], batch_dims if scatter and k in ("wk", "wv") else varies)
        for k in keys}
    read = _kv_reader((B, S, H, hd), (B, S, KV, hd), mesh, q_pl, k_pl)
    pos_pl = tuple(q if q.is_shard(0) else Replicate() for q in x_pl)

    def body(xl, posl, *wl):
        pl = dict(zip(keys, wl))
        q, k, v = _project_qkv(pl, xl, cfg, posl, kv_heads)
        out = chunked_attention(q, *read(k, v), q_offset=0,
                                window=cfg.attn_window, causal=causal)
        return _out_proj(out, pl["wo"]), k, v

    kv_out = tuple(Shard(2) if j in kv_tp else pos_pl[j] for j in range(n))
    out_pl = tuple(Partial() if j in tp else x_pl[j] for j in range(n))
    out, k, v = _local_block(
        body, mesh, [x, positions] + [p[k] for k in keys],
        [x_pl, pos_pl] + [w_pl[k] for k in keys],
        [pshard.grad_placements(x_pl, tp), pos_pl] +
        [w_grad[k] for k in keys],
        (out_pl, kv_out, kv_out))
    return pshard.constrain(out, pshard.BATCH, None, None), (k, v)


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg: ModelConfig):
    """One-token decode. x: [B, 1, D]; caches [B, W, KV, hd], written in
    place at slot ``pos % W`` (rolling window) or ``min(pos, W - 1)``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    W = cache_k.shape[1]
    rolling = cfg.attn_window is not None and W <= cfg.attn_window
    slot = pos % W if rolling else min(pos, W - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    out = _by_heads(decode_attention, q, cache_k, cache_v,
                    n_valid=min(pos + 1, W))
    return _out_proj(out, p["wo"]), cache_k, cache_v


def roll_slots(x, shift: int, dim: int):
    """``torch.roll(x, shift, dim)`` as two slices joined (the same
    elements moved; DTensor has a rule for these, not for ``roll`` in
    every torch release)."""
    W = x.shape[dim]
    if shift % W == 0:
        return x
    shift %= W
    return torch.cat([x.narrow(dim, W - shift, shift),
                      x.narrow(dim, 0, W - shift)], dim=dim)


def cache_width(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attn_window is not None:
        return min(cfg.attn_window, seq_len)
    return seq_len


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #

def init_mlp(generator: torch.Generator, cfg: ModelConfig, device,
             n_layers: int, d_ff: Optional[int] = None):
    """One ``[n_layers, ...]`` stack of MLP weights."""
    d, f, L = cfg.d_model, d_ff or cfg.d_ff, n_layers
    pd = dtype_of(cfg.param_dtype)
    p = {"wi": dense_init(generator, (L, d, f), d, pd, device),
         "wo": dense_init(generator, (L, f, d), f, pd, device)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(generator, (L, d, f), d, pd, device)
    return p


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_block(p, x, cfg: ModelConfig):
    if pshard._is_dtensor(x):
        return _mlp_tp(p, x, cfg)
    h = x @ p["wi"].to(x.dtype)
    if cfg.gated_mlp:
        h = _act(cfg.mlp_act)(x @ p["wg"].to(x.dtype)) * h
    else:
        h = _act(cfg.mlp_act)(h)
    return h @ p["wo"].to(x.dtype)


def _mlp_tp(p, x, cfg: ModelConfig):
    """``mlp_block`` on DTensors, tensor-parallel as the reference's
    constraints (h, g: (BATCH, None, 'model')) make XLA's program: the ff
    dim sharded, the output a partial sum all-reduced by the closing
    ``constrain``; one ``local_map`` body a rank (as ``_attention_tp``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    B, S, _ = x.shape
    F = p["wi"].shape[-1]
    h_pl = pshard.spec_placements((B, S, F), mesh, pshard.BATCH, None,
                                  "model")
    tp = _tp_dims(h_pl, 2)
    n = mesh.ndim
    x_pl = tuple(Replicate() if j in tp else q for j, q in enumerate(h_pl))
    w_pl = {"wi": tuple(Shard(1) if j in tp else Replicate()
                        for j in range(n)),
            "wo": tuple(Shard(0) if j in tp else Replicate()
                        for j in range(n))}
    w_pl["wg"] = w_pl["wi"]
    keys = [k for k in ("wi", "wg", "wo") if k in p]
    varies = tp | {j for j, q in enumerate(x_pl) if q.is_shard()}
    out = _local_block(
        lambda xl, *wl: mlp_block(dict(zip(keys, wl)), xl, cfg), mesh,
        [x] + [p[k] for k in keys], [x_pl] + [w_pl[k] for k in keys],
        [pshard.grad_placements(x_pl, tp)] +
        [pshard.grad_placements(w_pl[k], varies) for k in keys],
        [Partial() if j in tp else x_pl[j] for j in range(n)])
    return pshard.constrain(out, pshard.BATCH, None, None)


# --------------------------------------------------------------------------- #
# Embedding / logits
# --------------------------------------------------------------------------- #

def init_embedding(generator: torch.Generator, cfg: ModelConfig, device):
    pd = dtype_of(cfg.param_dtype)
    V = cfg.padded_vocab()
    emb = torch.randn((V, cfg.d_model), generator=generator,
                      device=generator.device) * 0.02
    p = {"embedding": emb.to(device=device, dtype=pd)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.d_model, V), cfg.d_model,
                                  pd, device)
    return p


def _lookup(table, tokens):
    """``table[tokens]``; a DTensor table in a ``local_map`` body a rank
    (DTensor's index rules do not take a vocab-sharded table in every
    torch release): each rank looks up the tokens its rows hold, zero
    rows elsewhere, and the partial sums over the vocab's shards are the
    lookup (summed by the caller's ``constrain``). The tokens are
    replicated over those shards; the table's gradient is partial where
    it is replicated and the tokens are not."""
    if not pshard._is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = {j for j, q in enumerate(table.placements) if q.is_shard(0)}
    t_pl = tuple(Shard(0) if j in vocab else Replicate()
                 for j in range(mesh.ndim))
    tok = tokens if pshard._is_dtensor(tokens) else \
        pshard.from_replicated(tokens, mesh, (Replicate(),) * mesh.ndim)
    k_pl = tuple(Replicate() if j in vocab else q
                 for j, q in enumerate(tok.placements))
    v0 = pshard.local_shape_and_offset(table.shape, mesh, t_pl)[1][0]

    def body(tl, tk):
        t = tk.long() - v0
        inside = (t >= 0) & (t < tl.shape[0])
        rows = tl[torch.where(inside, t, 0)]
        return torch.where(inside[..., None], rows, 0.0)

    batch_dims = {j for j, q in enumerate(k_pl) if q.is_shard()}
    return _local_block(
        body, mesh, [table, tok], [t_pl, k_pl],
        [pshard.grad_placements(t_pl, batch_dims), k_pl],
        [Partial() if j in vocab else k_pl[j] for j in range(mesh.ndim)])


def embed(p, tokens, cfg: ModelConfig):
    x = _lookup(p["embedding"], tokens).to(dtype_of(cfg.compute_dtype))
    if cfg.arch_id.startswith(("gemma", "recurrentgemma")):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return pshard.constrain(x, pshard.BATCH, None, None)


def logits_out(p, x, cfg: ModelConfig):
    """x [B, S, D] -> logits [B, S, padded vocab] in x.dtype."""
    if cfg.tie_embeddings:
        w = p["embedding"].to(x.dtype).T
    else:
        w = p["unembed"].to(x.dtype)
    logits = pshard.constrain(x @ w, pshard.BATCH, None, "model")
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _vocab_sharded_nll(logits, targets, vocab_size: int):
    """Per-token NLL of a DTensor whose vocab dim is sharded: each shard's
    logsumexp and gold logit in a ``local_map`` body (DTensor has no rule
    for a gather along a sharded dim), the shards' logsumexps combined by
    a logsumexp over their stack and the gold logits summed (Partial)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vocab_dims = [j for j, p in enumerate(pl) if p == Shard(2)]
    batch_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    targets = pshard.place_as(targets, mesh, batch_pl)
    off = pshard.local_shape_and_offset(logits.shape, mesh, pl)[1][2]
    lse_pl = tuple(Shard(2) if j in vocab_dims else batch_pl[j]
                   for j in range(len(pl)))
    gold_pl = tuple(Partial() if j in vocab_dims else batch_pl[j]
                    for j in range(len(pl)))

    def body(lf, tg):
        lf = lf.to(torch.float32)
        cols = off + torch.arange(lf.shape[-1], device=lf.device)
        if logits.shape[-1] > vocab_size:
            lf = lf + torch.where(cols >= vocab_size, -1e30, 0.0)
        t = tg.long() - off
        inside = (t >= 0) & (t < lf.shape[-1])
        gold = torch.gather(lf, -1, torch.where(inside, t, 0)[..., None])
        gold = torch.where(inside, gold[..., 0], 0.0)
        return torch.logsumexp(lf, dim=-1, keepdim=True), gold

    lse_parts, gold = local_map(body, out_placements=(lse_pl, gold_pl),
                                in_placements=(pl, batch_pl),
                                device_mesh=mesh)(logits, targets)
    return torch.logsumexp(lse_parts, dim=-1) - gold


def cross_entropy(logits, targets, vocab_size: int, mask=None):
    """Next-token CE in f32 with padded-vocab masking. targets: [B, S]."""
    if pshard._is_dtensor(logits) and any(
            p.is_shard(2) for p in logits.placements):
        nll = _vocab_sharded_nll(logits, targets, vocab_size)
        if mask is not None:
            nll = nll * mask
            return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.mean(nll)
    lf = logits.to(torch.float32)
    V = lf.shape[-1]
    if V > vocab_size:
        cols = torch.arange(V, device=lf.device)
        lf = lf + torch.where(cols >= vocab_size, -1e30, 0.0)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
