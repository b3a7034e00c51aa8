"""SeamlessM4T-medium backbone: a transformer encoder-decoder. Twin of
``repro.models.encdec``.

The speech frontend (the w2v-BERT conformer) is a stub, as in the
reference: ``frames`` [B, S_src, D] (float32, cast to the compute dtype)
go to the encoder directly, S_src = seq_len // 4. The decoder runs causal
self-attention over the text/unit tokens and cross-attention over the
encoder memory: no rope, no qk-norm and no mask across modalities, every
memory slot attended. No TPU kernel stands behind this family.

Params keep the reference's layout (``enc_layers`` and ``dec_layers``
stacked ``[L, ...]``). The cache is the self-attention's ``"k"``, ``"v"``
``[L, B, seq, KV, hd]`` and the memory projected once a decoder layer,
``"mem_k"``, ``"mem_v"`` ``[L, B, src_len(seq), KV, hd]``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

SRC_FRACTION = 4  # S_src = seq_len // 4


def src_len(seq_len: int) -> int:
    return max(1, seq_len // SRC_FRACTION)


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig, device,
                   n: int):
    """One ``[n, ...]`` stack of encoder layers."""
    pd = L.dtype_of(cfg.param_dtype)
    return {"attn_norm": torch.ones((n, cfg.d_model), dtype=pd, device=device),
            "attn": L.init_attention(generator, cfg, device, n),
            "mlp_norm": torch.ones((n, cfg.d_model), dtype=pd, device=device),
            "mlp": L.init_mlp(generator, cfg, device, n)}


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig, device,
                   n: int):
    """One ``[n, ...]`` stack of decoder layers."""
    pd = L.dtype_of(cfg.param_dtype)

    def ones():
        return torch.ones((n, cfg.d_model), dtype=pd, device=device)

    return {"self_norm": ones(),
            "self_attn": L.init_attention(generator, cfg, device, n),
            "cross_norm": ones(),
            "cross_attn": L.init_attention(generator, cfg, device, n),
            "mlp_norm": ones(),
            "mlp": L.init_mlp(generator, cfg, device, n)}


def init_params(generator: torch.Generator, cfg: ModelConfig, device):
    """Random init on ``device``, drawn from ``generator`` on its own
    device."""
    pd = L.dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(generator, cfg, device),
        "enc_layers": init_enc_layer(generator, cfg, device,
                                     cfg.n_enc_layers),
        "dec_layers": init_dec_layer(generator, cfg, device, cfg.n_layers),
        "enc_norm": torch.ones((cfg.d_model,), dtype=pd, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=device),
    }


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(params, frames, cfg: ModelConfig):
    """frames [B, S_src, D] stub embeddings -> encoder memory [B, S_src, D],
    non-causal self-attention."""
    B, S, _ = frames.shape
    x = frames.to(L.dtype_of(cfg.compute_dtype))
    positions = _positions(B, S, x.device)
    for i in range(cfg.n_enc_layers):
        lp = L.layer_at(params["enc_layers"], i)
        h, _ = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions, causal=False)
        x = x + h
        x = x + L.mlp_block(lp["mlp"],
                            L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), cfg)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attention(p, x, memory, cfg: ModelConfig):
    """Queries from x [B, S, D], keys and values from the encoder memory
    [B, M, D]; every memory slot attended."""
    mem = memory.to(x.dtype)
    q, k, v = L._heads(x, p["wq"]), L._heads(mem, p["wk"]), \
        L._heads(mem, p["wv"])
    out = L.chunked_attention(q, k, v, q_offset=0, window=None, causal=False)
    return L._out_proj(out, p["wo"])


def _cross_decode(p, x, mem_k, mem_v, cfg: ModelConfig):
    """One token's cross-attention over every slot of the projected memory
    (a padded memory's zero slots included, as the reference attends)."""
    q = L._heads(x, p["wq"])
    out = L.decode_attention(q, mem_k, mem_v, n_valid=mem_k.shape[1])
    return L._out_proj(out, p["wo"])


def decode_stack(params, tokens, memory, cfg: ModelConfig, *,
                 collect_kv: bool = False):
    """tokens [B, S] over the memory -> (hidden [B, S, D], kv or None):
    with ``collect_kv`` the self-attention's keys and values, each
    [L, B, S, KV, hd]."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    positions = _positions(B, S, x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = L.layer_at(params["dec_layers"], i)
        h, (k, v) = L.attention_block(
            lp["self_attn"], L.rms_norm(x, lp["self_norm"], cfg.norm_eps),
            cfg, positions=positions)
        x = x + h
        x = x + _cross_attention(
            lp["cross_attn"], L.rms_norm(x, lp["cross_norm"], cfg.norm_eps),
            memory, cfg)
        x = x + L.mlp_block(lp["mlp"],
                            L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), cfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def loss_fn(params, batch, cfg: ModelConfig):
    memory = encode(params, batch["frames"], cfg)
    x, _ = decode_stack(params, batch["tokens"], memory, cfg)
    logits = L.logits_out(params["embed"], x, cfg)
    ce = L.cross_entropy(logits, batch["targets"], cfg.vocab_size,
                         batch.get("mask"))
    return ce, {"loss": ce, "ce": ce, "aux": torch.zeros_like(ce)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    dt = L.dtype_of(cfg.compute_dtype)
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    self_shape = (cfg.n_layers, batch, seq_len, *kv)
    mem_shape = (cfg.n_layers, batch, src_len(seq_len), *kv)
    return {"k": torch.zeros(self_shape, dtype=dt, device=device),
            "v": torch.zeros(self_shape, dtype=dt, device=device),
            "mem_k": torch.zeros(mem_shape, dtype=dt, device=device),
            "mem_v": torch.zeros(mem_shape, dtype=dt, device=device)}


def prefill(params, batch, cfg: ModelConfig):
    """batch: {"frames" [B, M, D], "tokens" [B, S]} -> (logits [B, S, V],
    cache at position S, the memory projected once a decoder layer)."""
    memory = encode(params, batch["frames"], cfg)
    x, (k, v) = decode_stack(params, batch["tokens"], memory, cfg,
                             collect_kv=True)
    logits = L.logits_out(params["embed"], x, cfg)
    cross = params["dec_layers"]["cross_attn"]
    mem_k = torch.stack([L._heads(memory, cross["wk"][i])
                         for i in range(cfg.n_layers)])
    mem_v = torch.stack([L._heads(memory, cross["wv"][i])
                         for i in range(cfg.n_layers)])
    return logits, {"k": k, "v": v, "mem_k": mem_k, "mem_v": mem_v}


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """token [B] ints at absolute position ``pos`` -> (logits [B, V], the
    cache with this token's self-attention keys and values written in)."""
    x = L.embed(params["embed"], token[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = L.layer_at(params["dec_layers"], i)
        h, _, _ = L.attention_decode(
            lp["self_attn"], L.rms_norm(x, lp["self_norm"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, cfg)
        x = x + h
        x = x + _cross_decode(
            lp["cross_attn"], L.rms_norm(x, lp["cross_norm"], cfg.norm_eps),
            cache["mem_k"][i], cache["mem_v"][i], cfg)
        x = x + L.mlp_block(lp["mlp"],
                            L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_out(params["embed"], x, cfg)[:, 0], cache
