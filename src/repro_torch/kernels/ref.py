"""Plain PyTorch versions of the kernels (twins of ``repro.kernels.ref``).

They are what a wrapper runs on a CPU tensor, and the yardstick a CUDA
kernel is held against on the card: the same arithmetic, written as whole-
tensor operations.
"""
from __future__ import annotations

import torch


def multikrum_dists(x):
    """x: [M, N] flattened models -> pairwise squared L2 [M, M] (f32)."""
    xf = x.to(torch.float32)
    sq = torch.sum(xf * xf, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (xf @ xf.T)
    return torch.clamp(d, min=0.0)


def krum_from_dists(d, m: int):
    """MultiKRUM score per model from its [M, M] distances: the sum of its
    min(m, M-1) smallest distances to the others (lower = more central)."""
    M = d.shape[0]
    d = d + torch.diag(torch.full((M,), float("inf"), device=d.device))
    return torch.sort(d, dim=1).values[:, :min(m, M - 1)].sum(dim=1)


def multikrum_scores(x, m: int):
    """MultiKRUM score per model (lower = better). x: [M, N]."""
    return krum_from_dists(multikrum_dists(x), m)


def weighted_sum(x, w):
    """x: [M, N] models, w: [M] weights -> [N] aggregate (f32 accumulate)."""
    return torch.einsum("m,mn->n", w.to(torch.float32),
                        x.to(torch.float32)).to(x.dtype)


def weighted_sum_ordered(x, w):
    """The weighted_sum kernel's own float32 arithmetic: ``acc = fma(w[m],
    x[m], acc)`` for m = 0..M-1 from 0, each step rounded once, emulated in
    float64. The product is exact there (24 + 24 bits); TwoSum recovers what
    the float64 sum dropped, which decides a float32 tie. Bit for bit what
    the kernel gives, at any layout and vector width; a yardstick for its
    order, not a path of the port. x: [M, N] f32, w: [M] -> [N] f32; or w
    [M, N], one weight an element (``wsum_q8``'s ``w_m s_m`` against its
    codes)."""
    acc = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    wf = w.to(device=x.device, dtype=torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    for m in range(x.shape[0]):
        p = wf[m] * x[m].to(torch.float64)
        s = p + acc
        pb = s - acc
        e = (p - pb) + (acc - (s - pb))      # s + e == p + acc exactly
        r = s.to(torch.float32)
        r64 = r.to(torch.float64)
        hi = torch.where(r64 > s, r, torch.nextafter(r, inf))
        lo = torch.where(r64 < s, r, torch.nextafter(r, -inf))
        tie = s == (hi.to(torch.float64) + lo.to(torch.float64)) * 0.5
        r = torch.where(tie & (e > 0), hi, torch.where(tie & (e < 0), lo, r))
        acc = r.to(torch.float64)
    return acc.to(torch.float32)


def quantize_int8(x, tile: int = 1024):
    """Symmetric per-tile int8 quantization. x: [N] (N % tile == 0).
    Returns (q int8 [N], scales f32 [N/tile])."""
    xt = x.to(torch.float32).reshape(-1, tile)
    amax = xt.abs().amax(dim=1)
    # amax * (1/127), not amax / 127: the reference's default (Pallas) path
    # compiles its division by the constant into this product, and the two
    # differ in the last bit for some tiles (its jnp oracle divides)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    # torch.round rounds half to even, like jnp.round
    q = torch.clamp(torch.round(xt / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_int8(q, scales, tile: int = 1024):
    qt = q.reshape(-1, tile).to(torch.float32)
    return (qt * scales[:, None]).reshape(-1)


def add_q8_delta(base, q, scales, tile: int = 1024):
    """Fused int8 delta-apply: base [N] f32 + q [N] int8 * scales [N/tile]
    -> [N] f32. ``base + q*s`` is evaluated in float64 (q*s is exact there)
    and rounded once to float32, as a fused multiply-add rounds it: the
    reference's default (Pallas) path compiles ``b + q*s`` into an FMA, and
    its jnp oracle, which rounds the product first, differs from it in the
    last bit for about a quarter of the elements. The reconstructed model is
    the next round's delta base, so those bits reach the wire and the CIDs."""
    N = q.shape[0]
    s = scales.to(torch.float64).repeat_interleave(tile)[:N]
    return (base.to(torch.float64) + q.to(torch.float64) * s).to(torch.float32)


def dequantize_rows(q, scales, tile: int = 1024):
    """q: [M, N] int8, scales: [M, N/tile] -> [M, N] f32."""
    M, N = q.shape
    qt = q.reshape(M, N // tile, tile).to(torch.float32)
    return (qt * scales[:, :, None]).reshape(M, N)


def wsum_q8(q, scales, w, tile: int = 1024):
    """Dequantize, then weighted sum. q: [M, N] int8, scales: [M, N/tile],
    w: [M] -> [N] f32."""
    x = dequantize_rows(q, scales, tile)
    return torch.einsum("m,mn->n", w.to(torch.float32), x)


def gram_and_norms(x):
    """x: [M, N] -> (G = X X^T [M, M] f32, sq [M, 1] f32)."""
    xf = x.to(torch.float32)
    return xf @ xf.T, torch.sum(xf * xf, dim=1, keepdim=True)


def gram_q8(q, scales, tile: int = 1024):
    """Dequantize, then X X^T and the row norms. q: [M, N] int8, scales:
    [M, N/tile] -> (G [M, M] f32, sq [M, 1] f32)."""
    return gram_and_norms(dequantize_rows(q, scales, tile))


def wkv6_naive(r, k, v, w, u, state):
    """Token-by-token WKV6 recurrence in float32. r, k, v, w: [B, T, H, hs];
    u: [H, hs]; state: [B, H, hs, hs] (key x value) -> (y [B, T, H, hs] in
    r.dtype, state' f32)."""
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = state.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhkv,bhk->bhv", S + uf * kv, rf[:, t]))
        S = S * wf[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv6_subchunks(r, k, v, w, u, state, chunk: int = 32, sub: int = 16):
    """The ``wkv6`` kernel's chunked arithmetic, written out in float32 for
    the tests (a yardstick of the algorithm, not a path of the port; the
    plain version is ``wkv6_naive``). Same arguments and results.

    Tokens go in chunks of ``chunk``, each split into sub-chunks of ``sub``.
    Every decay is a product of ``w`` taken outwards from a sub-chunk
    boundary (no log, exp or division; every factor in [0, 1]):
    ``rp_t = r_t * prod(w[start(t) .. t-1])``, ``ks_s = k_s * prod(w[s+1 ..
    end(s)])``, ``W_c = prod(w over sub-chunk c)``. Within a chunk with
    incoming state S, for t in sub-chunk a and s < t in sub-chunk b::

      A[t, s] = rp_t . (prod_{b<c<a} W_c) ks_s               (b < a)
      A[t, s] = sum_i r_t[i] k_s[i] prod(w[s+1 .. t-1])[i]   (b = a, a
                running product from r_t backwards)
      A[t, t] = sum_i r_t[i] u[i] k_t[i]
      y_t     = (rp_t * prod_{c<a} W_c) . S + sum_{s<=t} A[t, s] v_s
      S      <- diag(prod_c W_c) S + sum_s (ks_s * prod_{c>b} W_c) v_s^T

    A tail chunk is padded with r = k = v = 0 and w = 1, which changes
    nothing."""
    B, T, H, hs = r.shape
    C, nsub = chunk, chunk // sub
    pad = (-T) % C
    f = lambda a, fill: torch.cat(
        [a.to(torch.float32),
         torch.full((B, pad, H, hs), fill, device=r.device)], 1) \
        if pad else a.to(torch.float32)
    # [B, H, Tp, hs]
    rf, kf, vf = (f(a, 0.0).transpose(1, 2) for a in (r, k, v))
    wf = f(w, 1.0).transpose(1, 2)
    uf = u.to(torch.float32)[None, :, :]
    S = state.to(torch.float32).clone()
    ys = []
    for c0 in range(0, T + pad, C):
        R, K, V, W = (a[:, :, c0:c0 + C] for a in (rf, kf, vf, wf))
        rp, ks = torch.empty_like(R), torch.empty_like(K)
        Ws = []
        for c in range(nsub):
            P = torch.ones_like(R[:, :, 0])
            for t in range(c * sub, (c + 1) * sub):
                rp[:, :, t] = R[:, :, t] * P
                P = P * W[:, :, t]
            Ws.append(P)
            Q = torch.ones_like(K[:, :, 0])
            for s in reversed(range(c * sub, (c + 1) * sub)):
                ks[:, :, s] = K[:, :, s] * Q
                Q = Q * W[:, :, s]
        A = torch.zeros(B, H, C, C, device=r.device)
        for a in range(nsub):
            ta = slice(a * sub, (a + 1) * sub)
            for b in range(a):
                mid = torch.ones_like(Ws[0])
                for c in range(b + 1, a):
                    mid = mid * Ws[c]
                A[:, :, ta, b * sub:(b + 1) * sub] = torch.einsum(
                    "bhti,bhsi->bhts", rp[:, :, ta],
                    ks[:, :, b * sub:(b + 1) * sub] * mid[:, :, None])
            # the diagonal sub-chunk: offsets d = t - s, r_t carried back
            rP = R[:, :, ta].clone()
            Ka, Wa = K[:, :, ta], W[:, :, ta]
            for d in range(1, sub):
                A[:, :, a * sub + d:(a + 1) * sub,
                  a * sub:(a + 1) * sub - d].diagonal(dim1=2, dim2=3)[:] = \
                    torch.einsum("bhti,bhti->bht", rP[:, :, d:], Ka[:, :, :-d])
                rP[:, :, d:] = rP[:, :, d:] * Wa[:, :, :sub - d]
            A[:, :, ta, ta].diagonal(dim1=2, dim2=3)[:] = torch.einsum(
                "bhti,bhti->bht", R[:, :, ta] * uf[:, :, None], Ka)
        rq, kq = rp.clone(), ks.clone()
        before = torch.ones_like(Ws[0])
        for c in range(nsub):
            rq[:, :, c * sub:(c + 1) * sub] *= before[:, :, None]
            before = before * Ws[c]
        after = torch.ones_like(Ws[0])
        for c in reversed(range(nsub)):
            kq[:, :, c * sub:(c + 1) * sub] *= after[:, :, None]
            after = after * Ws[c]
        ys.append(torch.einsum("bhti,bhij->bhtj", rq, S)
                  + torch.einsum("bhts,bhsj->bhtj", A, V))
        S = before[..., None] * S + torch.einsum("bhsi,bhsj->bhij", kq, V)
    y = torch.cat(ys, 2)[:, :, :T].transpose(1, 2)
    return y.to(r.dtype), S


def wkv6_backward_naive(r, k, v, w, u, state, dy, dstate=None):
    """The gradients of ``wkv6_naive``, as an explicit reverse token scan in
    float32 (the yardstick of the ``wkv6_backward`` kernel; the model's CPU
    path differentiates ``wkv6_naive`` with autograd instead). r, k, v, w,
    dy: [B, T, H, hs]; u: [H, hs]; state, dstate: [B, H, hs, hs] (dstate
    None: the final state is discarded) -> (dr, dk, dv in r's dtype, dw in
    w's, du in u's, dstate0 in state's).

    With S_t = diag(w_t) S_{t-1} + k_t v_t^T and G_t the gradient of S_t
    (G_T = dstate), from t = T down to 1::

      dr_t = S_{t-1} dy_t + u * k_t (dy_t . v_t)
      dk_t = G_t v_t      + u * r_t (dy_t . v_t)
      dv_t = G_t^T k_t    + (r_t . (u * k_t)) dy_t
      dw_t = rowsum(G_t * S_{t-1})
      du  += r_t * k_t (dy_t . v_t)
      G_{t-1} = diag(w_t) G_t + r_t dy_t^T

    and dstate0 = G_0. The states S_{t-1} are kept from a forward scan."""
    rf, kf, vf, wf, dyf = (a.to(torch.float32) for a in (r, k, v, w, dy))
    uf = u.to(torch.float32)[None]
    S = state.to(torch.float32)
    states = []
    for t in range(r.shape[1]):
        states.append(S)
        S = S * wf[:, t, :, :, None] + torch.einsum(
            "bhk,bhv->bhkv", kf[:, t], vf[:, t])
    G = torch.zeros_like(S) if dstate is None else dstate.to(torch.float32)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf[0])
    for t in reversed(range(r.shape[1])):
        St = states[t]
        rt, kt, vt, wt, dyt = (a[:, t] for a in (rf, kf, vf, wf, dyf))
        dyv = torch.sum(dyt * vt, dim=-1, keepdim=True)
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", St, dyt) + uf * kt * dyv
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", G, vt) + uf * rt * dyv
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", G, kt) + torch.sum(
            rt * uf * kt, dim=-1, keepdim=True) * dyt
        dw[:, t] = torch.sum(G * St, dim=-1)
        du = du + torch.sum(rt * kt * dyv, dim=0)
        G = G * wt[..., None] + torch.einsum("bhk,bhv->bhkv", rt, dyt)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), G.to(state.dtype))
