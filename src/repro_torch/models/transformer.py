"""Decoder-only transformer LM, the ``dense``, ``vlm`` and ``moe`` families.
Twin of ``repro.models.transformer``.

Params keep the reference's layout: the per-layer leaves are stacked
``[L, ...]`` as ``jax.vmap`` makes them, so a reference init installs leaf
for leaf (``repro_torch.interop``). The forward is a Python loop over the
layers (no scan), each layer's body rematerialised by ``cfg.remat``
(``layers.remat``) as the reference's scan body is. The KV cache is ``{"k", "v"}``, each ``[L, B, W, KV, hd]`` in the
compute dtype; ``decode_step`` writes the new token's keys into it in place
and returns it. A ``moe`` layer has ``"moe"`` (``models/moe.py``, its
experts stacked ``[L, E, ...]``) in place of ``"mlp"``; its load-balance
loss is summed over the layers.
"""
from __future__ import annotations

import torch

from repro_torch import pshard
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

    def body(x, lp):
        h, kv = L.attention_block(
            lp["attn"], L.rms_norm(x, lp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        x = x + h
        h, aux_i = _ffn(lp, x, cfg)
        x = pshard.constrain(x + h, pshard.BATCH, None, None)
        return x, aux_i, kv

    body_fn = L.remat(body, cfg.remat)
    for lp in L.unstack_layers(params["layers"], cfg.n_layers):
        x, aux_i, (k, v) = body_fn(x, lp)
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


def cache_spec(cfg: ModelConfig, batch: int):
    kv_ax = "model" if cfg.n_kv_heads >= 16 else None
    b_ax = "data" if batch > 1 else None  # pod handled by stacking in multi-pod
    # batch=1 long-decode: shard the window dim over data instead of batch
    w_ax = "data" if batch == 1 else None
    return {"k": pshard.resolve_spec(None, b_ax, w_ax, kv_ax, None),
            "v": pshard.resolve_spec(None, b_ax, w_ax, kv_ax, None)}


def prefill(params, tokens, cfg: ModelConfig):
    """Returns (logits [B, S, V], cache at position S)."""
    x, _, (k, v) = forward(params, tokens, cfg, collect_kv=True)
    logits = L.logits_out(params["embed"], x, cfg)
    S = tokens.shape[1]
    W = L.cache_width(cfg, S)
    if W < S:  # rolling window cache: keep last W keys in rolled slot order
        k = L.roll_slots(k[:, :, S - W:], (S - W) % W, dim=2)
        v = L.roll_slots(v[:, :, S - W:], (S - W) % W, dim=2)
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


# --------------------------------------------------------------------------- #
# Sharding rules
# --------------------------------------------------------------------------- #

def param_rules(cfg: ModelConfig):
    if cfg.sharding_mode == "dp":
        # pure data parallelism over BOTH axes: params replicated (fits for
        # <=3B), only gradient all-reduces, no param all-gathers
        return [(r".*", (None, None, None, None))]
    if cfg.sharding_mode == "fsdp":
        # pure ZeRO-3: every weight matrix sharded over BOTH mesh axes on one
        # dim; no tensor parallelism, so no per-layer activation all-reduces,
        # only per-layer param all-gathers + gradient reduce-scatters
        dm = ("data", "model")
        ep = cfg.moe and cfg.moe.n_experts % 16 == 0
        return [
            # vocab over ONE axis only (the reference's gather partitioner
            # takes no multi-axis-sharded gather operand)
            (r"embed/embedding", ("model", None)),
            (r"embed/unembed", (None, dm)),
            (r"attn/wq$", (None, dm, None, None)),
            (r"attn/w[kv]$", (None, dm, None, None)),
            (r"attn/wo$", (None, None, None, dm)),
            (r"moe/router", (None, None, None)),
            (r"moe/w[igo]$", (None, "model", "data", None) if ep
             else (None, None, dm, None)),
            (r"mlp/w[ig]$", (None, None, dm)),
            (r"mlp/wo$", (None, dm, None)),
            (r"norm", (None, None)),
        ]
    fsdp = "data" if cfg.fsdp else None
    kv_ax = "model" if cfg.n_kv_heads >= 16 else None
    return [
        # embedding rows stay vocab-sharded only (as the reference keeps
        # them: its gather partitioner takes no (vocab, d)-sharded table)
        (r"embed/embedding", ("model", None)),
        (r"embed/unembed", (fsdp, "model")),
        (r"attn/wq$", (None, fsdp, "model", None)),     # [L, D, H, hd]
        (r"attn/w[kv]$", (None, fsdp, kv_ax, None)),
        (r"attn/wo$", (None, "model", None, fsdp)),     # [L, H, hd, D]
        (r"attn/b[qkv]$", (None, None, None)),
        (r"moe/router", (None, None, None)),
        (r"moe/w[ig]$", (None, "model", fsdp, None))
        if (cfg.moe and cfg.moe.sharding == "ep")
        else (r"moe/w[ig]$", (None, None, fsdp, "model")),  # [L, E, D, F]
        (r"moe/wo$", (None, "model", None, fsdp))
        if (cfg.moe and cfg.moe.sharding == "ep")
        else (r"moe/wo$", (None, None, "model", fsdp)),     # [L, E, F, D]
        (r"mlp/w[ig]$", (None, fsdp, "model")),         # [L, D, F]
        (r"mlp/wo$", (None, "model", fsdp)),            # [L, F, D]
        (r"norm", (None, None)),
    ]
