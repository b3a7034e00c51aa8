"""Plain reference of the ``dense`` family (Qwen3): a decoder-only
transformer with RMSNorm, grouped-query attention with a per-head RMSNorm
on q and k and rotary embeddings (half-split), a SwiGLU MLP and tied
embeddings, next-token cross-entropy averaged over the tokens.

Everything computes in float32 through ``Numerics`` (the judge) or with
fp8 operands (the control), from the bf16 parameters it is given. Each
layer is recomputed in the backward (``torch.utils.checkpoint``) so that
4,096-token rows fit beside the program's peak; the logits are over the
published vocabulary (the embedding table's padding rows are never read).

Layout of the parameters, the one the benchmark makes and hands to both
sides: per-layer leaves stacked ``[L, ...]``; ``wq`` [L, d, H, hd], ``wk``
and ``wv`` [L, d, KV, hd], ``wo`` [L, H, hd, d], MLP ``wi`` (up), ``wg``
(gate) [L, d, f] and ``wo`` [L, f, d]. Departure from the published model:
none in the forward; the init is the benchmark's own (``param_specs``).
"""
from __future__ import annotations

import math

import torch
from torch.utils import checkpoint as ckpt

F32 = torch.float32
BF16 = torch.bfloat16


def param_specs(cfg: dict):
    """[(path, shape, dtype, init)]: init ('normal', std), ('ones',)."""
    L, d, H, KV = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, f, Vp = cfg["head_dim"], cfg["d_ff"], cfg["padded_vocab"]
    dt = BF16 if cfg["param_dtype"] == "bfloat16" else F32
    fan = lambda n: ("normal", 1.0 / math.sqrt(n))
    return [
        ("embed/embedding", (Vp, d), dt, ("normal", 0.02)),
        ("final_norm", (d,), dt, ("ones",)),
        ("layers/attn/k_norm", (L, hd), dt, ("ones",)),
        ("layers/attn/q_norm", (L, hd), dt, ("ones",)),
        ("layers/attn/wk", (L, d, KV, hd), dt, fan(d)),
        ("layers/attn/wo", (L, H, hd, d), dt, fan(H * hd)),
        ("layers/attn/wq", (L, d, H, hd), dt, fan(d)),
        ("layers/attn/wv", (L, d, KV, hd), dt, fan(d)),
        ("layers/attn_norm", (L, d), dt, ("ones",)),
        ("layers/mlp/wg", (L, d, f), dt, fan(d)),
        ("layers/mlp/wi", (L, d, f), dt, fan(d)),
        ("layers/mlp/wo", (L, f, d), dt, fan(f)),
        ("layers/mlp_norm", (L, d), dt, ("ones",)),
    ]


def forward_flops(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of one token's forward at a row of ``seq_len`` tokens:
    the weight products (2 a multiply-add), causal attention's two
    products over the (seq_len + 1) / 2 keys a token sees on average, and
    the logits over the published vocabulary. Norms, softmax and the
    lookup are not counted."""
    L, d, H, KV = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    hd, f, V = cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"]
    proj = d * H * hd * 2 + 2 * d * KV * hd + 3 * d * f
    attn = 2 * H * hd * (seq_len + 1) / 2
    return 2.0 * (L * (proj + attn) + d * V)


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x, cos, sin, attn_norm, q_norm, k_norm, wq, wk, wv, wo,
           mlp_norm, wg, wi, w2, *, cfg, num):
    B, S, d = x.shape
    H, KV, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], \
        cfg["norm_eps"]
    h = _rms(x, attn_norm, eps).reshape(B * S, d)
    q = num.mm(h, wq.reshape(d, H * hd)).reshape(B, S, H, hd)
    k = num.mm(h, wk.reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = num.mm(h, wv.reshape(d, KV * hd)).reshape(B, S, KV, hd)
    q = _rope(_rms(q, q_norm, eps), cos, sin)
    k = _rope(_rms(k, k_norm, eps), cos, sin)
    G = H // KV
    k = k.repeat_interleave(G, dim=2)          # query head h reads h // G
    v = v.repeat_interleave(G, dim=2)
    s = num.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = num.einsum("bhst,bthd->bshd", p, v).reshape(B * S, H * hd)
    x = x + num.mm(o, wo.reshape(H * hd, d)).reshape(B, S, d)
    h = _rms(x, mlp_norm, eps).reshape(B * S, d)
    g = torch.nn.functional.silu(num.mm(h, wg)) * num.mm(h, wi)
    return x + num.mm(g, w2).reshape(B, S, d)


def loss(params: dict, batch: dict, cfg: dict, num):
    """Mean next-token cross-entropy of ``batch`` ({'tokens', 'targets'}
    [B, S]) under ``params`` ({path: tensor}); float32 throughout."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    P = {k: v.to(F32) for k, v in params.items()}
    emb = P["embed/embedding"]
    x = emb[tokens]
    hd, V = cfg["head_dim"], cfg["vocab_size"]
    half = hd // 2
    freqs = cfg["rope_theta"] ** (-torch.arange(half, dtype=F32,
                                                device=x.device) / half)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    names = ["attn_norm", "attn/q_norm", "attn/k_norm", "attn/wq",
             "attn/wk", "attn/wv", "attn/wo", "mlp_norm", "mlp/wg",
             "mlp/wi", "mlp/wo"]
    layer = lambda *a: _layer(*a, cfg=cfg, num=num)
    for i in range(cfg["n_layers"]):
        ws = [P["layers/" + n][i] for n in names]
        if torch.is_grad_enabled():
            x = ckpt.checkpoint(layer, x, cos, sin, *ws, use_reentrant=False)
        else:
            x = layer(x, cos, sin, *ws)
    x = _rms(x, P["final_norm"], cfg["norm_eps"]).reshape(B * S, -1)
    logits = num.mm(x, emb[:V].t())
    nll = torch.logsumexp(logits, -1) - \
        logits.gather(-1, targets.reshape(-1, 1)).squeeze(-1)
    return nll.mean()
