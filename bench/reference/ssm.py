"""Plain reference of the ``ssm`` family (RWKV-6 "Finch", arXiv:2404.05892)
in the form the port runs it: RMSNorm before each block; the time mix
with its data-dependent token shift (a low-rank ``tanh`` adapter of
width 32 for the five mixes), r/k/v/g projections, the per-channel decay
``w = exp(-exp(decay_base + lora(x)))`` (adapter width 64), the bonus
``u``, per head the recurrence

    y_t = (S + diag(u) k_t v_t^T)^T r_t ;  S <- diag(w_t) S + k_t v_t^T

from a zero state, a group norm over each head (population variance,
eps 64e-5), the gate ``silu(g)`` and the output projection; the channel
mix ``sigmoid(r) * (relu(k)^2 @ wv)`` with its own token shift; untied
embeddings. Departures from the published model, all the port's: RMSNorm
in place of LayerNorm (eps 1e-6) and no LayerNorm after the embedding;
the decay adapter's ``tanh`` taken of its input, not of its first
product; the base of the token shift's adapter mixed by r's mix.

The recurrence is computed exactly, in chunks of 16 tokens: every decay
is ``exp`` of a difference of the cumulative log-decays, never above 0,
and ``log w = -exp(.)`` is formed without taking a log. Everything
computes in float32 (or with fp8 product operands, the control); each
layer is recomputed in the backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch.utils import checkpoint as ckpt

F32 = torch.float32
BF16 = torch.bfloat16
LORA = 32
DECAY_LORA = 64
GN_EPS = 64e-5
CHUNK = 16


def _layer_ratios(L: int, device):
    """Per layer: layer / (L - 1) and 1 - layer / L, as [L, 1]."""
    i = torch.arange(L, dtype=F32, device=device)[:, None]
    return i / max(L - 1, 1), 1.0 - i / L


def _mixes(L: int, d: int, n: int, device):
    """The token-shift mixes of RWKV-6's init, [L, n, d] (n = 5: the base
    and r, k, v, w, g of the port's order; n = 2: the channel mix's k, r):
    1 - (i / d) ^ (1 - layer / L), the value mix less 0.3 layer / (L - 1),
    the gate's exponent halved."""
    r01, r1a0 = _layer_ratios(L, device)
    ddd = torch.arange(d, dtype=F32, device=device)[None, :] / d
    base = 1.0 - ddd ** r1a0
    if n == 2:
        return torch.stack([base, base], dim=1)
    v = 1.0 - (ddd ** r1a0 + 0.3 * r01)
    g = 1.0 - ddd ** (0.5 * r1a0)
    return torch.stack([base, base, v, base, g], dim=1)


def _decay(L: int, d: int, device):
    """-6 + 5 (i / (d - 1)) ^ (0.7 + 1.3 layer / (L - 1)), [L, d]."""
    r01, _ = _layer_ratios(L, device)
    n = torch.arange(d, dtype=F32, device=device)[None, :] / (d - 1)
    return -6.0 + 5.0 * n ** (0.7 + 1.3 * r01)


def _bonus(L: int, H: int, hs: int, device):
    """(layer / (L - 1)) (1 - i / (d - 1)) plus a zigzag of +-0.1, as
    [L, H, hs]."""
    r01, _ = _layer_ratios(L, device)
    d = H * hs
    n = torch.arange(d, dtype=F32, device=device)[None, :]
    zig = ((n + 1) % 3 - 1) * 0.1
    return (r01 * (1.0 - n / (d - 1)) + zig).reshape(L, H, hs)


def _gn_scale(L: int, d: int, device):
    """((1 + layer) / L) ^ 0.7, [L, d]."""
    i = torch.arange(L, dtype=F32, device=device)[:, None]
    return ((1.0 + i) / L) ** 0.7 * torch.ones(L, d, device=device)


def param_specs(cfg: dict):
    """[(path, shape, dtype, init)]: init ('normal', std), ('uniform', lo,
    hi), ('ones',), ('zeros',) or ('value', fn(device) -> float32).

    RWKV-6's own init (the RWKV-LM v6 training code), with normal draws of
    the same scale in place of its orthogonal matrices, and small draws in
    place of its zero matrices, so that the first step's gradient reaches
    every leaf, the recurrence's backward included: the time mix's output
    and the channel mix's value and receptance normal at a tenth of the
    fan-in scale, the adapters' first and second matrices uniform in
    +-0.01; k and g at a tenth of r's and v's scale; the embedding uniform
    in +-1e-4, the head at half the fan-in scale; the mixes, the decay,
    the bonus and the group norm's scale by its formulas."""
    L, d, f, hs, Vp = cfg["n_layers"], cfg["d_model"], cfg["d_ff"], \
        cfg["rwkv_head_size"], cfg["padded_vocab"]
    H = d // hs
    dt = BF16 if cfg["param_dtype"] == "bfloat16" else F32
    fan = lambda n, gain=1.0: ("normal", gain / math.sqrt(n))
    small = ("uniform", -0.01, 0.01)
    return [
        ("embed/embedding", (Vp, d), dt, ("uniform", -1e-4, 1e-4)),
        ("embed/unembed", (d, Vp), dt, fan(d, 0.5)),
        ("final_norm", (d,), dt, ("ones",)),
        ("layers/bonus_u", (L, H, hs), F32,
         ("value", lambda dev: _bonus(L, H, hs, dev))),
        ("layers/cm_wk", (L, d, f), dt, fan(d)),
        ("layers/cm_wr", (L, d, d), dt, fan(d, 0.1)),
        ("layers/cm_wv", (L, f, d), dt, fan(f, 0.1)),
        ("layers/cmix_mu", (L, 2, d), dt,
         ("value", lambda dev: _mixes(L, d, 2, dev))),
        ("layers/decay_base", (L, d), F32,
         ("value", lambda dev: _decay(L, d, dev))),
        ("layers/decay_w1", (L, d, DECAY_LORA), dt, small),
        ("layers/decay_w2", (L, DECAY_LORA, d), dt, small),
        ("layers/gn_scale", (L, d), dt,
         ("value", lambda dev: _gn_scale(L, d, dev))),
        ("layers/ln1", (L, d), dt, ("ones",)),
        ("layers/ln2", (L, d), dt, ("ones",)),
        ("layers/mix_mu", (L, 5, d), dt,
         ("value", lambda dev: _mixes(L, d, 5, dev))),
        ("layers/mix_w1", (L, d, 5 * LORA), dt, small),
        ("layers/mix_w2", (L, 5, LORA, d), dt, small),
        ("layers/wg", (L, d, d), dt, fan(d, 0.1)),
        ("layers/wk", (L, d, d), dt, fan(d, 0.1)),
        ("layers/wo", (L, d, d), dt, fan(d, 0.1)),
        ("layers/wr", (L, d, d), dt, fan(d)),
        ("layers/wv", (L, d, d), dt, fan(d)),
    ]


def forward_flops(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of one token's forward: the weight products (2 a
    multiply-add; the adapters included) and the logits over the
    published vocabulary, plus the recurrence's least work a token and
    head (y = S^T r and the bonus: 2 hs^2 + 5 hs; the state's update:
    3 hs^2). Norms, mixes and the lookup are not counted."""
    L, d, f, hs, V = cfg["n_layers"], cfg["d_model"], cfg["d_ff"], \
        cfg["rwkv_head_size"], cfg["vocab_size"]
    H = d // hs
    proj = 5 * d * d + d * 5 * LORA + 5 * LORA * d \
        + 2 * d * DECAY_LORA + d * d + 2 * d * f
    wkv = H * (5 * hs * hs + 5 * hs) / 2.0
    return 2.0 * (L * (proj + wkv) + d * V)


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _shift(x):
    """The previous token's x (zeros before the first)."""
    return Fn.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u):
    """r, k, v, logw: [B, T, H, hs] float32 (logw = log w <= 0); u [H, hs]
    -> y [B, T, H, hs], from a zero state, in chunks of CHUNK tokens."""
    B, T, H, hs = r.shape
    C = CHUNK
    pad = (-T) % C
    if pad:
        r, k, v, logw = (Fn.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    N = (T + pad) // C
    # [B, H, N, C, hs]
    r, k, v, logw = (a.reshape(B, N, C, H, hs).permute(0, 3, 1, 2, 4)
                     for a in (r, k, v, logw))
    incl = torch.cumsum(logw, dim=3)           # sum of log w_j, j <= t
    excl = incl - logw                         # sum of log w_j, j < t
    # the weight of v_s in y_t, s < t: sum_c r_t k_s prod_{s<j<t} w_j
    t_idx = torch.arange(C, device=r.device)
    below = (t_idx[:, None] > t_idx[None, :])[..., None]    # [C, C, 1]
    gap = excl[..., :, None, :] - incl[..., None, :, :]      # [.., t, s, hs]
    decay = torch.exp(gap.masked_fill(~below, float("-inf")))
    A = torch.einsum("bhntc,bhnsc,bhntsc->bhnts", r, k, decay)
    y = A @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    # the state entering each chunk, from the chunks before it
    tail = torch.exp(incl[..., -1:, :] - incl)               # [.., s, hs]
    incr = torch.einsum("bhnsc,bhnsv->bhncv", k * tail, v)   # [B,H,N,hs,hs]
    whole = torch.exp(incl[..., -1, :])                      # [B, H, N, hs]
    S = torch.zeros(B, H, hs, hs, dtype=F32, device=r.device)
    states = []
    for n in range(N):
        states.append(S)
        S = whole[:, :, n, :, None] * S + incr[:, :, n]
    states = torch.stack(states, dim=2)                      # [B,H,N,hs,hs]
    y = y + torch.einsum("bhntc,bhncv->bhntv", r * torch.exp(excl), states)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, hs)
    return y[:, :T]


def _layer(x, ln1, mix_mu, mix_w1, mix_w2, wr, wk, wv, wg, wo, decay_base,
           decay_w1, decay_w2, bonus_u, gn_scale, ln2, cmix_mu, cm_wr, cm_wk,
           cm_wv, *, cfg, num):
    B, S, d = x.shape
    hs, eps = cfg["rwkv_head_size"], cfg["norm_eps"]
    H = d // hs
    mm = lambda a, w: num.mm(a.reshape(-1, a.shape[-1]), w).reshape(
        *a.shape[:-1], w.shape[-1])
    # time mix
    xa = _rms(x, ln1, eps)
    delta = _shift(xa) - xa
    base = xa + delta * mix_mu[0]
    lo = torch.tanh(mm(base, mix_w1)).reshape(B, S, 5, LORA)
    adj = num.einsum("bsnr,nrd->bsnd", lo, mix_w2)
    xr, xk, xv, xw, xg = (xa + delta * (mix_mu[i] + adj[:, :, i])
                          for i in range(5))
    r, k, v = mm(xr, wr), mm(xk, wk), mm(xv, wv)
    g = Fn.silu(mm(xg, wg))
    logw = -torch.exp(decay_base + mm(mm(torch.tanh(xw), decay_w1),
                                      decay_w2))
    y = wkv(*(a.reshape(B, S, H, hs) for a in (r, k, v, logw)), bonus_u)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + GN_EPS)).reshape(B, S, d) * gn_scale
    x = x + mm(y * g, wo)
    # channel mix
    xb = _rms(x, ln2, eps)
    delta = _shift(xb) - xb
    ck = xb + delta * cmix_mu[0]
    cr = xb + delta * cmix_mu[1]
    kk = torch.square(torch.relu(mm(ck, cm_wk)))
    return x + torch.sigmoid(mm(cr, cm_wr)) * mm(kk, cm_wv)


NAMES = ("ln1", "mix_mu", "mix_w1", "mix_w2", "wr", "wk", "wv", "wg", "wo",
         "decay_base", "decay_w1", "decay_w2", "bonus_u", "gn_scale", "ln2",
         "cmix_mu", "cm_wr", "cm_wk", "cm_wv")


def loss(params: dict, batch: dict, cfg: dict, num):
    """Mean next-token cross-entropy of ``batch`` under ``params``."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    P = {k: v.to(F32) for k, v in params.items()}
    x = P["embed/embedding"][tokens]
    layer = lambda *a: _layer(*a, cfg=cfg, num=num)
    for i in range(cfg["n_layers"]):
        ws = [P["layers/" + n][i] for n in NAMES]
        if torch.is_grad_enabled():
            x = ckpt.checkpoint(layer, x, *ws, use_reentrant=False)
        else:
            x = layer(x, *ws)
    x = _rms(x, P["final_norm"], cfg["norm_eps"]).reshape(B * S, -1)
    logits = num.mm(x, P["embed/unembed"][:, :cfg["vocab_size"]])
    nll = torch.logsumexp(logits, -1) - \
        logits.gather(-1, targets.reshape(-1, 1)).squeeze(-1)
    return nll.mean()
