"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrence and local
MQA attention in a repeating (rec, rec, attn) pattern. Twin of
``repro.models.rglru``.

Recurrent block: gate branch GeLU(x Wg) * RG_LRU(conv1d(x Wi)), then Wo.
RG-LRU:  r_t = sigmoid(x W_a + b_a);  i_t = sigmoid(x W_x + b_x)
         a_t = exp(-c * softplus(lam) * r_t),  c = 8
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the diagonal recurrence as a log-depth associative scan in
plain PyTorch (about log2 S doubling steps over [B, S, D], products of the
decays themselves, never differences of cumulative logs, which overflow
float32 within ten strongly decaying tokens); decode is the same scan over
one token. No TPU kernel stands behind this family.

Params keep the reference's layout: the groups stacked ``[G, ...]`` and the
``n_layers % 3`` trailing rec layers stacked ``[tail, ...]``. The cache is
``{"rec1", "rec2"[, "tail"]}`` recurrent states, each ``{"conv" [n, B, 3,
D] in the compute dtype, "h" [n, B, D] float32}``, and the local attention's
``"k"``, ``"v"`` ``[G, B, W, 1, hd]`` with W = min(window, seq);
``decode_step`` writes all of them in place and returns the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

CONV_WIDTH = 4
LRU_C = 8.0


def _n_groups_tail(cfg: ModelConfig):
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    if pat != ("rec", "rec", "attn"):
        raise ValueError("only the griffin 2:1 pattern is wired")
    return cfg.n_layers // 3, cfg.n_layers % 3  # tail layers are 'rec'


def init_rec_block(generator: torch.Generator, cfg: ModelConfig, device,
                   n: int):
    """One ``[n, ...]`` stack of recurrent blocks; ``lru_lam`` stays
    float32 whatever the param dtype."""
    d = cfg.d_model
    pd = L.dtype_of(cfg.param_dtype)

    def dense(shape, fan_in):
        return L.dense_init(generator, (n, *shape), fan_in, pd, device)

    lam = torch.rand((n, d), generator=generator, device=generator.device)
    return {
        "norm": torch.ones((n, d), dtype=pd, device=device),
        "wg": dense((d, d), d),
        "wi": dense((d, d), d),
        "wo": dense((d, d), d),
        "conv_w": dense((CONV_WIDTH, d), CONV_WIDTH),
        "lru_wa": dense((d, d), d),
        "lru_wx": dense((d, d), d),
        "lru_ba": torch.zeros((n, d), dtype=pd, device=device),
        "lru_bx": torch.zeros((n, d), dtype=pd, device=device),
        "lru_lam": (0.9 + 0.2 * lam).to(device=device, dtype=torch.float32),
        "mlp_norm": torch.ones((n, d), dtype=pd, device=device),
    }


def init_group(generator: torch.Generator, cfg: ModelConfig, device, n: int):
    """One ``[n, ...]`` stack of (rec, rec, attn) groups."""
    pd = L.dtype_of(cfg.param_dtype)

    def ones():
        return torch.ones((n, cfg.d_model), dtype=pd, device=device)

    return {
        "rec1": init_rec_block(generator, cfg, device, n),
        "rec1_mlp": L.init_mlp(generator, cfg, device, n),
        "rec2": init_rec_block(generator, cfg, device, n),
        "rec2_mlp": L.init_mlp(generator, cfg, device, n),
        "attn_norm": ones(),
        "attn": L.init_attention(generator, cfg, device, n),
        "attn_mlp_norm": ones(),
        "attn_mlp": L.init_mlp(generator, cfg, device, n),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig, device):
    """Random init on ``device``, drawn from ``generator`` on its own
    device."""
    n_groups, tail = _n_groups_tail(cfg)
    params = {
        "embed": L.init_embedding(generator, cfg, device),
        "groups": init_group(generator, cfg, device, n_groups),
        "final_norm": torch.ones((cfg.d_model,),
                                 dtype=L.dtype_of(cfg.param_dtype),
                                 device=device),
    }
    if tail:
        params["tail"] = {"rec": init_rec_block(generator, cfg, device, tail),
                          "mlp": L.init_mlp(generator, cfg, device, tail)}
    return params


# --------------------------------------------------------------------------- #
# RG-LRU + conv
# --------------------------------------------------------------------------- #

def _conv1d(x, w, tail):
    """Depthwise causal conv, width CONV_WIDTH, its taps summed in order
    0..3 in x's dtype. x [B, S, D]; tail [B, W-1, D], the last inputs."""
    S = x.shape[1]
    xx = torch.cat([tail, x], dim=1)
    out = xx[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, CONV_WIDTH):
        out = out + xx[:, i:i + S] * w[i].to(x.dtype)
    return out, xx[:, -(CONV_WIDTH - 1):]


def rg_lru(x, r_gate, i_gate, lam, h0):
    """x, r, i: [B, S, D] float32; h0 [B, D]. Returns (y [B, S, D], hS
    [B, D]). h0 is folded into b_0 as the reference folds it; the scan
    combines (a1, b1) then (a2, b2) into (a2 a1, a2 b1 + b2), each step
    with the element ``shift`` tokens earlier, shift = 1, 2, 4, ..."""
    log_a = -LRU_C * F.softplus(lam) * r_gate             # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) \
        * (i_gate * x)
    b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    a = torch.cat([torch.ones_like(a[:, :1]), a[:, 1:]], dim=1)
    S, shift = x.shape[1], 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b, b[:, -1]


def rec_block(p, x, cfg: ModelConfig, st):
    """st: {conv [B, 3, D], h [B, D]}. Returns (out, new st)."""
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    gate = F.gelu(xn @ p["wg"].to(x.dtype), approximate="tanh")
    z, conv_tail = _conv1d(xn @ p["wi"].to(x.dtype), p["conv_w"],
                           st["conv"])
    r = torch.sigmoid((xn @ p["lru_wa"].to(x.dtype)).to(torch.float32)
                      + p["lru_ba"].to(torch.float32))
    i = torch.sigmoid((xn @ p["lru_wx"].to(x.dtype)).to(torch.float32)
                      + p["lru_bx"].to(torch.float32))
    h, h_last = rg_lru(z.to(torch.float32), r, i, p["lru_lam"], st["h"])
    out = (gate * h.to(gate.dtype)) @ p["wo"].to(x.dtype)
    return out, {"conv": conv_tail, "h": h_last}


def _rec_sub(cfg, x, p_rec, p_mlp, st):
    h, st = rec_block(p_rec, x, cfg, st)
    x = x + h
    x = x + L.mlp_block(p_mlp, L.rms_norm(x, p_rec["mlp_norm"],
                                          cfg.norm_eps), cfg)
    return x, st


def _group_fwd(cfg, x, gp, positions, st):
    """One (rec, rec, attn) group over a whole sequence. Returns (x, the
    rec states, (k, v))."""
    x, st1 = _rec_sub(cfg, x, gp["rec1"], gp["rec1_mlp"], st["rec1"])
    x, st2 = _rec_sub(cfg, x, gp["rec2"], gp["rec2_mlp"], st["rec2"])
    h, kv = L.attention_block(gp["attn"],
                              L.rms_norm(x, gp["attn_norm"], cfg.norm_eps),
                              cfg, positions=positions)
    x = x + h
    x = x + L.mlp_block(gp["attn_mlp"],
                        L.rms_norm(x, gp["attn_mlp_norm"], cfg.norm_eps), cfg)
    return x, {"rec1": st1, "rec2": st2}, kv


# --------------------------------------------------------------------------- #
# States / caches
# --------------------------------------------------------------------------- #

def _zero_rec_state(cfg, batch, n, dt, device):
    return {"conv": torch.zeros((n, batch, CONV_WIDTH - 1, cfg.d_model),
                                dtype=dt, device=device),
            "h": torch.zeros((n, batch, cfg.d_model), dtype=torch.float32,
                             device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    n_groups, tail = _n_groups_tail(cfg)
    dt = L.dtype_of(cfg.compute_dtype)
    W = L.cache_width(cfg, seq_len)
    shape = (n_groups, batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"rec1": _zero_rec_state(cfg, batch, n_groups, dt, device),
             "rec2": _zero_rec_state(cfg, batch, n_groups, dt, device),
             "k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if tail:
        cache["tail"] = _zero_rec_state(cfg, batch, tail, dt, device)
    return cache


def _stack(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


# --------------------------------------------------------------------------- #
# Forward / loss / serve
# --------------------------------------------------------------------------- #

def forward(params, tokens, cfg: ModelConfig, *, collect_kv: bool = False):
    """tokens [B, S] from zero states -> (hidden [B, S, D], cache): the
    states after the last token and, with ``collect_kv``, the last W keys
    and values in rolled slot order (slot = pos % W)."""
    B, S = tokens.shape
    n_groups, tail = _n_groups_tail(cfg)
    cache = init_cache(cfg, B, S, tokens.device)
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    sts, ks, vs = [], [], []
    for g in range(n_groups):
        st = {"rec1": L.layer_at(cache["rec1"], g),
              "rec2": L.layer_at(cache["rec2"], g)}
        x, st, (k, v) = _group_fwd(cfg, x, L.layer_at(params["groups"], g),
                                   positions, st)
        sts.append(st)
        ks.append(k)
        vs.append(v)
    cache["rec1"] = _stack([s["rec1"] for s in sts])
    cache["rec2"] = _stack([s["rec2"] for s in sts])
    if collect_kv:
        k, v = torch.stack(ks), torch.stack(vs)
        W = L.cache_width(cfg, S)
        if W < S:  # rolling window: keep the last W keys in slot order
            k = torch.roll(k[:, :, S - W:], shifts=(S - W) % W, dims=2)
            v = torch.roll(v[:, :, S - W:], shifts=(S - W) % W, dims=2)
        cache["k"], cache["v"] = k, v
    if tail:
        tst = []
        for t in range(tail):
            tp = L.layer_at(params["tail"], t)
            x, st = _rec_sub(cfg, x, tp["rec"], tp["mlp"],
                             L.layer_at(cache["tail"], t))
            tst.append(st)
        cache["tail"] = _stack(tst)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, cache


def loss_fn(params, batch, cfg: ModelConfig):
    x, _ = forward(params, batch["tokens"], cfg)
    logits = L.logits_out(params["embed"], x, cfg)
    ce = L.cross_entropy(logits, batch["targets"], cfg.vocab_size,
                         batch.get("mask"))
    return ce, {"loss": ce, "ce": ce, "aux": torch.zeros_like(ce)}


def prefill(params, tokens, cfg: ModelConfig):
    """Returns (logits [B, S, V], cache at position S)."""
    x, cache = forward(params, tokens, cfg, collect_kv=True)
    return L.logits_out(params["embed"], x, cfg), cache


def _write(states, i: int, st) -> None:
    for k, v in st.items():
        states[k][i] = v


def decode_step(params, token, pos: int, cache, cfg: ModelConfig):
    """token [B] ints at absolute position ``pos`` -> (logits [B, V], the
    cache with the new states and this token's keys written in)."""
    n_groups, tail = _n_groups_tail(cfg)
    x = L.embed(params["embed"], token[:, None], cfg)
    for g in range(n_groups):
        gp = L.layer_at(params["groups"], g)
        x, st = _rec_sub(cfg, x, gp["rec1"], gp["rec1_mlp"],
                         L.layer_at(cache["rec1"], g))
        _write(cache["rec1"], g, st)
        x, st = _rec_sub(cfg, x, gp["rec2"], gp["rec2_mlp"],
                         L.layer_at(cache["rec2"], g))
        _write(cache["rec2"], g, st)
        h, _, _ = L.attention_decode(
            gp["attn"], L.rms_norm(x, gp["attn_norm"], cfg.norm_eps),
            cache["k"][g], cache["v"][g], pos, cfg)
        x = x + h
        x = x + L.mlp_block(gp["attn_mlp"],
                            L.rms_norm(x, gp["attn_mlp_norm"], cfg.norm_eps),
                            cfg)
    for t in range(tail):
        tp = L.layer_at(params["tail"], t)
        x, st = _rec_sub(cfg, x, tp["rec"], tp["mlp"],
                         L.layer_at(cache["tail"], t))
        _write(cache["tail"], t, st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.logits_out(params["embed"], x, cfg)[:, 0], cache
