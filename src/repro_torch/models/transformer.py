"""Decoder-only transformer LM, the ``dense``, ``vlm`` and ``moe`` families.
Twin of ``repro.models.transformer``.

Params keep the reference's layout: the per-layer leaves are stacked
``[L, ...]`` as ``jax.vmap`` makes them, so a reference init installs leaf
for leaf (``repro_torch.interop``). The forward is a Python loop over the
layers (no scan, no rematerialisation: the port serves, it does not train
LMs yet). The KV cache is ``{"k", "v"}``, each ``[L, B, W, KV, hd]`` in the
compute dtype; ``decode_step`` writes the new token's keys into it in place
and returns it. A ``moe`` layer has ``"moe"`` (``models/moe.py``, its
experts stacked ``[L, E, ...]``) in place of ``"mlp"``; its load-balance
loss is summed over the layers.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib


def init_params(generator: torch.Generator, cfg: ModelConfig, device):
    """Random init on ``device``, drawn from ``generator`` on its own device
    (a generator on the card keeps a 1.7 B init off the host)."""
    n, pd = cfg.n_layers, L.dtype_of(cfg.param_dtype)

    def ones():
        return torch.ones((n, cfg.d_model), dtype=pd, device=device)

    layers = {"attn_norm": ones(),
              "attn": L.init_attention(generator, cfg, device, n),
              "mlp_norm": ones()}
    if cfg.family == "moe":
        layers["moe"] = moe_lib.init_moe(generator, cfg, device, n)
    else:
        layers["mlp"] = L.init_mlp(generator, cfg, device, n)
    return {"embed": L.init_embedding(generator, cfg, device),
            "layers": layers,
            "final_norm": torch.ones((cfg.d_model,), dtype=pd,
                                     device=device)}


# --------------------------------------------------------------------------- #
# Full-sequence forward (prefill; the loss for the CPU parity tests)
# --------------------------------------------------------------------------- #

def _ffn(lp, x, cfg: ModelConfig):
    """The MLP or the MoE block of one layer -> (out, aux)."""
    xn = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_lib.moe_block(lp["moe"], xn, cfg)
    return L.mlp_block(lp["mlp"], xn, cfg), None


def forward(params, tokens, cfg: ModelConfig, *, collect_kv: bool = False):
    """tokens [B, S] -> (hidden [B, S, D], aux, kv or None): ``aux`` the
    MoE load-balance loss summed over the layers (0 for a dense model);
    with ``collect_kv`` the keys and values of every layer, each
    [L, B, S, KV, hd]."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = L.layer_at(params["layers"], i)
        h, (k, v) = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        x = x + h
        h, aux_i = _ffn(lp, x, cfg)
        x = x + h
        if aux_i is not None:
            aux = aux + aux_i
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def logits_fn(params, tokens, cfg: ModelConfig):
    x, aux, _ = forward(params, tokens, cfg)
    return L.logits_out(params["embed"], x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy plus ``aux_loss_coef`` times the MoE
    load-balance loss (a dense model has none)."""
    logits, aux = logits_fn(params, batch["tokens"], cfg)
    ce = L.cross_entropy(logits, batch["targets"], cfg.vocab_size,
                         batch.get("mask"))
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    loss = ce + coef * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# Serving: prefill + single-token decode with a KV cache
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    W = L.cache_width(cfg, seq_len)
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = L.dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params, tokens, cfg: ModelConfig):
    """Returns (logits [B, S, V], cache at position S)."""
    x, _, (k, v) = forward(params, tokens, cfg, collect_kv=True)
    logits = L.logits_out(params["embed"], x, cfg)
    S = tokens.shape[1]
    W = L.cache_width(cfg, S)
    if W < S:  # rolling window cache: keep last W keys in rolled slot order
        k = torch.roll(k[:, :, S - W:], shifts=(S - W) % W, dims=2)
        v = torch.roll(v[:, :, S - W:], shifts=(S - W) % W, dims=2)
    return logits, {"k": k, "v": v}


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """token [B] ints at absolute position ``pos`` -> (logits [B, V], the
    cache with this token's keys and values written in)."""
    x = L.embed(params["embed"], token[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = L.layer_at(params["layers"], i)
        h, _, _ = L.attention_decode(
            lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, cfg)
        x = x + h
        x = x + _ffn(lp, x, cfg)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_out(params["embed"], x, cfg)[:, 0], cache
