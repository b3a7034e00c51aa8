"""Shared layer helpers (the part of ``repro.models.layers`` the CNN and
RWKV-6 use). Norms, softmax and cross-entropy compute in float32 whatever
the compute dtype, as the reference does."""
from __future__ import annotations

import math

import torch

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
