"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay and a matrix-valued state per head. Twin of
``repro.models.rwkv6``.

Time-mix: ddlerp token-shift, r/k/v/g projections, decay w_t from a
low-rank MLP, bonus u, and per head the WKV recurrence

    y_t = (S + diag(u) k_t v_t^T)^T r_t ;  S <- diag(w_t) S + k_t v_t^T

Prefill and training run the recurrence through ``kernels.ops.wkv6`` (on
the card the CUDA kernels, forward and backward; on the CPU the token
scan); decode steps one token in plain PyTorch, as the reference does.
Params keep the reference's layout: the per-layer leaves are stacked
``[L, ...]`` as ``jax.vmap`` makes them, so a reference init installs leaf
for leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import pshard
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

LORA_DIM = 32
DECAY_LORA = 64
GN_EPS = 64e-5


def init_params(generator: torch.Generator, cfg: ModelConfig, device):
    """Random init on ``device``, drawn from ``generator`` on its own device
    (a generator on the card keeps a 1.6 B init off the host)."""
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    hs = cfg.rwkv_head_size
    pd = L.dtype_of(cfg.param_dtype)

    def dense(shape, fan_in):
        return L.dense_init(generator, (n, *shape), fan_in, pd, device)

    def uniform(shape, scale, shift, dtype):
        u = torch.rand((n, *shape), generator=generator,
                       device=generator.device)
        return (u * scale + shift).to(device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=device)

    layers = {
        "ln1": ones(n, d),
        "ln2": ones(n, d),
        "mix_mu": uniform((5, d), 0.5, 0.0, pd),
        "mix_w1": dense((d, 5 * LORA_DIM), d),
        "mix_w2": dense((5, LORA_DIM, d), LORA_DIM),
        "wr": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wg": dense((d, d), d),
        "wo": dense((d, d), d),
        "decay_base": uniform((d,), -6.0, -1.0, torch.float32),
        "decay_w1": dense((d, DECAY_LORA), d),
        "decay_w2": dense((DECAY_LORA, d), DECAY_LORA),
        "bonus_u": uniform((d // hs, hs), 0.5, 0.0, torch.float32),
        "gn_scale": ones(n, d),
        "cmix_mu": uniform((2, d), 0.5, 0.0, pd),
        "cm_wr": dense((d, d), d),
        "cm_wk": dense((d, ff), d),
        "cm_wv": dense((ff, d), ff),
    }
    return {"embed": L.init_embedding(generator, cfg, device),
            "layers": layers, "final_norm": ones(d)}


# --------------------------------------------------------------------------- #
# WKV recurrence
# --------------------------------------------------------------------------- #

def wkv(r, k, v, w, u, state):
    """r, k, v, w: [B, T, H, hs]; u: [H, hs]; state: [B, H, hs, hs] f32.
    On the card the ``WKV6`` Function (the ``wkv6`` kernel forward, the
    ``wkv6_backward`` kernel backward); on the CPU the token scan, which
    autograd differentiates. DTensors go through ``_wkv_sharded``."""
    if pshard._is_dtensor(r):
        return _wkv_sharded(ops.wkv6, r, k, v, w, u, state)
    return ops.wkv6(r, k, v, w, u, state)


def _wkv_sharded(fn, r, k, v, w, u, state):
    """``fn`` (``wkv`` on [B, T, H, hs] or ``wkv_step`` on [B, H, hs]) on
    DTensors: every (batch, head) block is independent, so a ``local_map``
    body runs it on each rank's block (batch over the batch axes, heads
    over ``model``, as the reference constrains r and k). DTensor has no
    rule for the kernel's op, nor for the step's products once the heads
    are sharded; u's gradient is partial over the batch axes."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    h = r.dim() - 2                               # the head dim
    spec = (pshard.BATCH,) + (None,) * (h - 1) + ("model", None)
    r, k, v, w = (pshard.place(a, mesh, *spec) for a in (r, k, v, w))
    # u and the state follow r's batch and head sharding
    pl_a = tuple(r.placements)
    pl_u = tuple(Shard(0) if p.is_shard(h) else Replicate() for p in pl_a)
    pl_s = tuple(Shard(1) if p.is_shard(h) else p for p in pl_a)
    u, state = pshard.place_as(u, mesh, pl_u), \
        pshard.place_as(state, mesh, pl_s)
    batch_dims = {j for j, p in enumerate(pl_a) if p.is_shard(0)}
    fn = local_map(fn, out_placements=(pl_a, pl_s),
                   in_placements=(pl_a,) * 4 + (pl_u, pl_s),
                   in_grad_placements=(pl_a,) * 4 + (
                       pshard.grad_placements(pl_u, batch_dims), pl_s),
                   device_mesh=mesh)
    return fn(r, k, v, w, u, state)


def wkv_step(r, k, v, w, u, state):
    """Single-token recurrence. r, k, v, w: [B, H, hs]; state: [B, H, hs,
    hs] f32."""
    if pshard._is_dtensor(r):
        return _wkv_sharded(wkv_step, r, k, v, w, u, state)
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    uf = u.to(torch.float32)[None, :, :, None]
    y = torch.einsum("bhkv,bhk->bhv", state + uf * kv, rf)
    state = state * wf[..., None] + kv
    return y.to(r.dtype), state


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #

def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift for the 5 projections: [B,S,D] -> 5 x
    [B,S,D]."""
    delta = x_prev - x
    base = x + delta * p["mix_mu"][0].to(x.dtype)   # coarse mix for the lora
    lo = torch.tanh(base @ p["mix_w1"].to(x.dtype))
    lo = lo.reshape(*x.shape[:-1], 5, LORA_DIM)
    adj = torch.einsum("bsnr,nrd->bsnd", lo, p["mix_w2"].to(x.dtype))
    return [x + delta * (p["mix_mu"][i].to(x.dtype) + adj[..., i, :])
            for i in range(5)]


class _Silu(torch.autograd.Function):
    """``F.silu`` whose backward is, in every mode, the formula PyTorch
    takes for it when grad mode is on (``torch.func.grad`` differentiates
    so): its fused backward differs by ulps, and RWKV-6's training at the
    smoke preset is ill-conditioned enough that they move a 2-round
    federated run by 1e-2 (``tests/test_torch_lm_train_recurrent.py``)."""

    @staticmethod
    def forward(x):
        return F.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        s = torch.sigmoid(x)
        return grad * s * (1.0 + x * (1.0 - s))


def time_mix(p, x, cfg: ModelConfig, x_prev, state):
    """x: [B,S,D]; x_prev: [B,1,D] last token of the previous segment;
    state: [B,H,hs,hs]. Returns (out, new_x_prev, new_state)."""
    B, S, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, shifted)
    r = xr @ p["wr"].to(x.dtype)
    k = xk @ p["wk"].to(x.dtype)
    v = xv @ p["wv"].to(x.dtype)
    g = _Silu.apply(xg @ p["wg"].to(x.dtype))
    dw = (torch.tanh(xw) @ p["decay_w1"].to(x.dtype)) @ \
        p["decay_w2"].to(x.dtype)
    w = torch.exp(-torch.exp(p["decay_base"].to(torch.float32) +
                             dw.to(torch.float32)))   # in (0, 1), [B,S,D]
    rh, kh, vh, wh = (a.reshape(B, S, H, hs) for a in (r, k, v, w))
    rh = pshard.constrain(rh, pshard.BATCH, None, "model", None)
    kh = pshard.constrain(kh, pshard.BATCH, None, "model", None)
    if S == 1:
        y, state = wkv_step(rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0],
                            p["bonus_u"], state)
        y = y[:, None]
    else:
        y, state = wkv(rh, kh, vh, wh, p["bonus_u"], state)
    # group-norm over heads: population variance, as jnp.var
    yf = y.to(torch.float32).reshape(B, S, H, hs)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yf = (yf - mu) * torch.rsqrt(var + GN_EPS)
    y = (yf.reshape(B, S, D) * p["gn_scale"].to(torch.float32)).to(x.dtype)
    out = (y * g) @ p["wo"].to(x.dtype)
    return pshard.constrain(out, pshard.BATCH, None, None), x[:, -1:], state


def channel_mix(p, x, x_prev):
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    delta = shifted - x
    xk = x + delta * p["cmix_mu"][0].to(x.dtype)
    xr = x + delta * p["cmix_mu"][1].to(x.dtype)
    r = torch.sigmoid(xr @ p["cm_wr"].to(x.dtype))
    k = pshard.constrain(xk @ p["cm_wk"].to(x.dtype), pshard.BATCH, None,
                         "model")
    k = torch.square(F.relu(k))
    v = k @ p["cm_wv"].to(x.dtype)
    return pshard.constrain(r * v, pshard.BATCH, None, None), x[:, -1:]


def _layer(cfg, x, lp, st):
    """st: dict(tm_x [B,1,D], cm_x [B,1,D], wkv [B,H,hs,hs])."""
    h, tm_x, wkv_s = time_mix(lp, L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                              st["tm_x"], st["wkv"])
    x = x + h
    h, cm_x = channel_mix(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                          st["cm_x"])
    x = x + h
    return x, {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv_s}


def init_state(cfg: ModelConfig, batch: int, device):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    dt = L.dtype_of(cfg.compute_dtype)
    z = lambda *s: torch.zeros(s, dtype=dt, device=device)
    return {"tm_x": z(cfg.n_layers, batch, 1, d),
            "cm_x": z(cfg.n_layers, batch, 1, d),
            "wkv": torch.zeros((cfg.n_layers, batch, d // hs, hs, hs),
                               dtype=torch.float32, device=device)}


def state_spec(cfg: ModelConfig, batch: int):
    b_ax = "data" if batch > 1 else None  # pod handled by stacking in multi-pod
    return {"tm_x": pshard.resolve_spec(None, b_ax, None, None),
            "cm_x": pshard.resolve_spec(None, b_ax, None, None),
            "wkv": pshard.resolve_spec(None, b_ax, "model", None, None)}


def forward(params, tokens, cfg: ModelConfig, state=None):
    """tokens [B, S] -> (final-normed x [B, S, D], new state); a Python loop
    over the stacked layers."""
    B, _ = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    if state is None:
        state = init_state(cfg, B, x.device)
    new = {name: [] for name in state}
    # the reference rematerialises its scan body under 'full' only
    layer = L.remat(lambda x, lp, st: _layer(cfg, x, lp, st),
                    "full" if cfg.remat == "full" else "none")
    for i, lp in enumerate(L.unstack_layers(params["layers"], cfg.n_layers)):
        x, st = layer(x, lp, {name: s[i] for name, s in state.items()})
        for name in new:
            new[name].append(st[name])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {name: torch.stack(s) for name, s in new.items()}


def loss_fn(params, batch, cfg: ModelConfig):
    x, _ = forward(params, batch["tokens"], cfg)
    logits = L.logits_out(params["embed"], x, cfg)
    ce = L.cross_entropy(logits, batch["targets"], cfg.vocab_size,
                         batch.get("mask"))
    return ce, {"loss": ce, "ce": ce, "aux": torch.zeros((), device=ce.device)}


def prefill(params, tokens, cfg: ModelConfig):
    x, state = forward(params, tokens, cfg)
    return L.logits_out(params["embed"], x, cfg), state


def decode_step(params, token, pos, state, cfg: ModelConfig):
    del pos  # recurrent: position-free
    x, new_state = forward(params, token[:, None], cfg, state)
    return L.logits_out(params["embed"], x, cfg)[:, 0], new_state


def param_rules(cfg: ModelConfig):
    return [
        (r"embed/embedding", ("model", None)),
        (r"embed/unembed", (None, "model")),
        (r"w[rkvg]$|wo$|cm_wr", (None, None, "model")),   # [L, D, D]
        (r"cm_wk", (None, None, "model")),                 # [L, D, F]
        (r"cm_wv", (None, "model", None)),                 # [L, F, D]
        (r"decay_w|mix_w", (None, None, None)),
        (r".*", (None, None, None, None)),
    ]
