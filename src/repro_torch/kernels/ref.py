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
    the kernel gives, at any layout and vector width: a yardstick for its
    order, and ``wsum_q8``'s plain version. x: [M, N] f32, w: [M] -> [N]
    f32; or w [M, N], one weight an element (``wsum_q8``'s ``w_m s_m``
    against its codes)."""
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
    """Dequantize, then weighted sum, in the arithmetic of the kernels:
    each weight folded into its model's tile scales (``w[m] * s[m, t]``,
    rounded once to float32), then ``acc = fma(w_m s_m, q_m, acc)`` for m
    = 0..M-1 from 0 (``weighted_sum_ordered``). The reference's Pallas
    kernel (its dot over m) gives these bits too; a dot of w with the
    dequantized rows, which rounds q * s first, differs in the last bit
    for a large share of the columns. q: [M, N] int8, scales: [M, N/tile],
    w: [M] -> [N] f32."""
    fw = w.to(device=q.device, dtype=torch.float32)[:, None] * \
        scales.to(device=q.device, dtype=torch.float32)
    return weighted_sum_ordered(q.to(torch.float32),
                                fw.repeat_interleave(tile, 1))


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


def _subchunk_a(R, K, W, u, sub: int):
    """A chunk's A[..., t, s] (the weight of v_s in y_t: zero above the
    diagonal, the bonus on it) as ``wkv6_subchunks`` forms it, with the
    sub-chunk products it is made of: rp, ks and each sub-chunk's W_c.
    R, K, W: [..., C, hs] f32; u: broadcasts against R[..., 0, :]."""
    C = R.shape[-2]
    nsub = C // sub
    rp, ks = torch.empty_like(R), torch.empty_like(K)
    Ws = []
    for c in range(nsub):
        P = torch.ones_like(R[..., 0, :])
        for t in range(c * sub, (c + 1) * sub):
            rp[..., t, :] = R[..., t, :] * P
            P = P * W[..., t, :]
        Ws.append(P)
        Q = torch.ones_like(K[..., 0, :])
        for s in reversed(range(c * sub, (c + 1) * sub)):
            ks[..., s, :] = K[..., s, :] * Q
            Q = Q * W[..., s, :]
    A = R.new_zeros(*R.shape[:-1], C)
    for a in range(nsub):
        ta = slice(a * sub, (a + 1) * sub)
        for b in range(a):
            mid = torch.ones_like(Ws[0])
            for c in range(b + 1, a):
                mid = mid * Ws[c]
            A[..., ta, b * sub:(b + 1) * sub] = torch.einsum(
                "...ti,...si->...ts", rp[..., ta, :],
                ks[..., b * sub:(b + 1) * sub, :] * mid[..., None, :])
        # the diagonal sub-chunk: offsets d = t - s, r_t carried back
        rP = R[..., ta, :].clone()
        Ka, Wa = K[..., ta, :], W[..., ta, :]
        for d in range(1, sub):
            A[..., a * sub + d:(a + 1) * sub,
              a * sub:(a + 1) * sub - d].diagonal(dim1=-2, dim2=-1)[:] = \
                torch.einsum("...ti,...ti->...t", rP[..., d:, :],
                             Ka[..., :-d, :])
            rP[..., d:, :] = rP[..., d:, :] * Wa[..., :sub - d, :]
        A[..., ta, ta].diagonal(dim1=-2, dim2=-1)[:] = torch.einsum(
            "...ti,...ti->...t", R[..., ta, :] * u[..., None, :], Ka)
    return A, rp, ks, Ws


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
        A, rp, ks, Ws = _subchunk_a(R, K, W, uf, sub)
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


def wkv6_backward_chunks(r, k, v, w, u, state, dy, dstate=None,
                         chunk: int = 32, sub: int = 16):
    """The ``wkv6_backward`` kernel's chunked arithmetic, written out in
    float32 (a yardstick of the algorithm, as ``wkv6_subchunks`` is of the
    forward; not a path of the port). Same arguments and results as
    ``wkv6_backward_naive``; a chunk is two sub-chunks (chunk = 2 sub).

    Inside a chunk with incoming state S_in and outgoing gradient G_out,
    every per-token state and gradient is a low-rank update of those two,
    so none is formed. With (channelwise products of w, every factor in
    [0, 1]; no log, exp or division) P_t = prod w[< t], Q_t = prod w[> t],
    D(a, c) = prod w[a < . < c] and M[t, s] = dy_t . v_s::

      dr_t = P_t (S_in dy_t) + sum_{s<t} D(s,t) k_s M[t,s] + u k_t M[t,t]
      dk_t = Q_t (G_out v_t) + sum_{t'>t} D(t,t') r_t' M[t',t]
             + u r_t M[t,t]
      dv   = A^T dY + KQ G_out              (A as ``wkv6_subchunks``)
      dw_t = P_t Q_t rowsum(G_out * S_in) + Q_t Z_t + P_t Z'_t + T4_t
      du  += r_t k_t M[t,t]

    with Z_t = sum_{s<t} D(s,t) k_s (G_out v_s), Z'_t = sum_{t'>t} D(t,t')
    r_t' (S_in dy_t') and T4_t = sum_{s<t<t'} D(s,t) D(t,t') r_t' k_s
    M[t',s]. A pair across the two sub-chunks factors at their boundary:
    D(s, t') = ksf_s rpf_t' for s in the first and t' in the second
    (ksf_s = prod w[s < . <= its end], rpf_t' = prod w[its start <= . <
    t']; KS0 = k ksf and RP1 = r rpf are ``wkv6_subchunks``' ks and rp),
    so those terms come from two products, Fx = M10 KS0 and Hx = M10^T
    RP1 (M10 = M[second, first]): dr_t += rpf_t Fx_t, dk_s += ksf_s Hx_s,
    and T4 gains ksf_t Zh_t (first sub-chunk; Zh_{t+1} = w_t Zh_t + k_t
    Hx_t) and rpf_t Zf_t (second; Zf_{t-1} = w_t Zf_t + r_t Fx_t). Pairs
    inside a sub-chunk
    are channelwise scans: F_{t+1}[x] = w_t F_t[x] + k_t M[x, t] gives
    dr's F_t[t], H_{t-1}[x] = w_t H_t[x] + r_t M[t, x] gives dk's H_t[t],
    and T4 inside a sub-chunk is a Horner sum over the shorter side (from
    H_t over s < t in its first half, from F_t over t' > t in its second).
    The chunk-boundary states come from two serial passes: S_in by S <-
    diag(W) S + KQ^T V, G_out backwards from dstate (or zeros) by G <-
    diag(W) G + RQ^T dY (RQ_t = r_t P_t, KQ_t = k_t Q_t, W = prod over the
    chunk); the last G is dstate0. A tail chunk is padded with r = k = v
    = dy = 0 and w = 1, which changes nothing."""
    assert chunk == 2 * sub, "a chunk is two sub-chunks"
    B, T, H, hs = r.shape
    C, L = chunk, sub
    pad = (-T) % C
    n = (T + pad) // C

    def chunks(a, fill):   # [B, T, H, hs] -> [B, H, n, C, hs] f32
        a = a.to(torch.float32)
        if pad:
            a = torch.cat([a, torch.full((B, pad, H, hs), fill,
                                         device=r.device)], 1)
        return a.reshape(B, n, C, H, hs).permute(0, 3, 1, 2, 4)

    R, K, V, DY = (chunks(a, 0.0) for a in (r, k, v, dy))
    W = chunks(w, 1.0)
    uf = u.to(torch.float32)[None, :, None, :]     # [1, H, 1, hs]
    at = lambda a, t: a[..., t, :]
    # products of w from the chunk's ends (P, Q) and from the boundary
    # between its sub-chunks (ksf over the first, rpf over the second)
    P, Q = torch.empty_like(W), torch.empty_like(W)
    p = torch.ones_like(W[..., 0, :])
    for t in range(C):
        P[..., t, :] = p
        p = p * at(W, t)
    Wc = p                                          # [B, H, n, hs]
    q = torch.ones_like(p)
    for t in reversed(range(C)):
        Q[..., t, :] = q
        q = q * at(W, t)
    ksf, rpf = torch.empty_like(W[..., :L, :]), torch.empty_like(W[..., :L, :])
    f = torch.ones_like(p)
    for t in reversed(range(L)):
        ksf[..., t, :] = f
        f = f * at(W, t)
    f = torch.ones_like(p)
    for t in range(L):
        rpf[..., t, :] = f
        f = f * at(W, L + t)
    KQ, RQ = K * Q, R * P

    # the two serial passes: each chunk's incoming state and outgoing
    # gradient
    S = state.to(torch.float32)
    s_in = []
    for c in range(n):
        s_in.append(S)
        S = Wc[:, :, c, :, None] * S + torch.einsum(
            "bhti,bhtj->bhij", KQ[:, :, c], V[:, :, c])
    G = torch.zeros_like(S) if dstate is None else dstate.to(torch.float32)
    g_out = [None] * n
    for c in reversed(range(n)):
        g_out[c] = G
        G = Wc[:, :, c, :, None] * G + torch.einsum(
            "bhti,bhtj->bhij", RQ[:, :, c], DY[:, :, c])
    Sin, Gout = torch.stack(s_in, 2), torch.stack(g_out, 2)

    # the chunk's products
    Y = torch.einsum("...tj,...ij->...ti", DY, Sin)      # S_in dy_t
    X = torch.einsum("...tj,...ij->...ti", V, Gout)      # G_out v_t
    M = torch.einsum("...tj,...sj->...ts", DY, V)
    A, rp, ks, _ = _subchunk_a(R, K, W, uf, L)
    dv = torch.einsum("...ts,...tj->...sj", A, DY) + torch.einsum(
        "...si,...ij->...sj", KQ, Gout)
    R1 = torch.sum(Gout * Sin, dim=-1)                   # [B, H, n, hs]
    M10 = M[..., L:, :L]
    Fx = torch.einsum("...ts,...si->...ti", M10, ks[..., :L, :])
    Hx = torch.einsum("...ts,...ti->...si", M10, rp[..., L:, :])
    Md = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]  # dy_t . v_t

    # the scans inside each sub-chunk, both at once: [..., 2, L, hs]
    two = lambda a: a.reshape(*a.shape[:-2], 2, L, hs)
    R2, K2, W2 = two(R), two(K), two(W)
    Mb = torch.stack([M[..., :L, :L], M[..., L:, L:]], -3)   # [.., 2, L, L]
    dr, dk, T4 = (torch.zeros_like(R2) for _ in range(3))
    F = torch.zeros_like(R2)         # F[..., a, x, :]: F_t[x]
    for t in range(L):
        dr[..., t, :] = at(F, t)
        if t >= L // 2:
            acc = torch.zeros_like(at(F, t))
            for x in reversed(range(t + 1, L)):
                acc = at(W2, x) * acc + at(R2, x) * at(F, x)
            T4[..., t, :] = acc
        F[..., t + 1:, :] = at(W2, t)[..., None, :] * F[..., t + 1:, :] \
            + at(K2, t)[..., None, :] * Mb[..., t + 1:, t, None]
    Hs = torch.zeros_like(R2)        # Hs[..., a, x, :]: H_t[x]
    for t in reversed(range(L)):
        dk[..., t, :] = at(Hs, t)
        if t < L // 2:
            acc = torch.zeros_like(at(Hs, t))
            for x in range(t):
                acc = at(W2, x) * acc + at(K2, x) * at(Hs, x)
            T4[..., t, :] = acc
        Hs[..., :t, :] = at(W2, t)[..., None, :] * Hs[..., :t, :] \
            + at(R2, t)[..., None, :] * Mb[..., t, :t, None]
    flat = lambda a: a.reshape(*a.shape[:-3], C, hs)
    dr, dk, T4 = flat(dr), flat(dk), flat(T4)
    dr[..., L:, :] += rpf * Fx
    dk[..., :L, :] += ksf * Hx
    dr = P * Y + dr + uf[..., None, :] * K * Md
    dk = Q * X + dk + uf[..., None, :] * R * Md
    dwa, dwb = torch.empty_like(R), torch.empty_like(R)
    z, zc = torch.zeros_like(at(R, 0)), torch.zeros_like(at(R, 0))
    for t in range(C):
        dwa[..., t, :] = at(P, t) * at(Q, t) * R1 + at(Q, t) * z
        if t < L:
            dwa[..., t, :] += at(ksf, t) * zc
            zc = at(W, t) * zc + at(K, t) * at(Hx, t)
        z = at(W, t) * z + at(K, t) * at(X, t)
    z, zc = torch.zeros_like(z), torch.zeros_like(z)
    for t in reversed(range(C)):
        dwb[..., t, :] = at(P, t) * z
        if t >= L:
            dwb[..., t, :] += at(rpf, t - L) * zc
            zc = at(W, t) * zc + at(R, t) * at(Fx, t - L)
        z = at(W, t) * z + at(R, t) * at(Y, t)
    dw = (dwa + dwb) + T4
    du = torch.sum(R * K * Md, dim=(0, 2, 3))              # [H, hs]

    back = lambda a, dt: a.permute(0, 2, 3, 1, 4).reshape(
        B, n * C, H, hs)[:, :T].to(dt)
    return (back(dr, r.dtype), back(dk, k.dtype), back(dv, v.dtype),
            back(dw, w.dtype), du.to(u.dtype), G.to(state.dtype))
