"""Shared layers, twin of ``repro.models.layers``: norms, RoPE, grouped-query
attention (chunked online softmax for prefill, a gather for decode), the
MLP, the embedding and the logits.

Norms, softmax and cross-entropy compute in float32 whatever the compute
dtype, and every cast is the reference's: attention scores accumulate in
float32 (the reference's ``preferred_element_type``: the operands go in as
float32, whose products of bf16 values are exact), the probabilities are
cast to ``v``'s dtype before ``p @ v``, and each weight is cast to the
activation dtype before its product. Attention is plain PyTorch, as the
reference's is plain ``jnp``: no TPU kernel stands behind it. The
reference's sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_proj(out, wo):
    """out [B, S, H, hd] @ wo [H, hd, D] -> [B, S, D]."""
    return out.flatten(-2) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])


def attention_block(p, x, cfg: ModelConfig, *, positions, causal=True):
    """Full-sequence self attention (prefill). Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, q_offset=0, window=cfg.attn_window,
                            causal=causal)
    return _out_proj(out, p["wo"]), (k, v)


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
    out = decode_attention(q, cache_k, cache_v, n_valid=min(pos + 1, W))
    return _out_proj(out, p["wo"]), cache_k, cache_v


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
    h = x @ p["wi"].to(x.dtype)
    if cfg.gated_mlp:
        g = x @ p["wg"].to(x.dtype)
        h = _act(cfg.mlp_act)(g) * h
    else:
        h = _act(cfg.mlp_act)(h)
    return h @ p["wo"].to(x.dtype)


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


def embed(p, tokens, cfg: ModelConfig):
    x = p["embedding"][tokens].to(dtype_of(cfg.compute_dtype))
    if cfg.arch_id.startswith(("gemma", "recurrentgemma")):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def logits_out(p, x, cfg: ModelConfig):
    """x [B, S, D] -> logits [B, S, padded vocab] in x.dtype."""
    if cfg.tie_embeddings:
        w = p["embedding"].to(x.dtype).T
    else:
        w = p["unembed"].to(x.dtype)
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def cross_entropy(logits, targets, vocab_size: int, mask=None):
    """Next-token CE in f32 with padded-vocab masking. targets: [B, S]."""
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
