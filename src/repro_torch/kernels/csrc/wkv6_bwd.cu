// Backward of the WKV6 recurrence of RWKV-6 (the forward is wkv6.cu):
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S: [hs key, hs value])
//   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//
// Replaces no Pallas kernel: the reference differentiates its jnp forms
// (wkv_chunked on the TPU, src/repro/models/rwkv6.py:80-143) and its Pallas
// wkv6 has no VJP. Added so that RWKV-6 trains on the card; the plain
// version is ref.wkv6_backward_naive. With G_t the gradient of S_t (G_T the
// final state's, or 0), from t = T down to 1:
//
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (dy_t . v_t)
//   dk_t[i] = sum_j G_t[i,j] v_t[j]       + u[i] r_t[i] (dy_t . v_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i]       + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]  += r_t[i] k_t[i] (dy_t . v_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,     dstate0 = G_0.
//
// Bound: float32 operations, about 10 hs^2 a token and head (the forward
// recompute twice, the three row sums, the two G steps) against 20 bytes an
// element at f32, 12 at bf16.
//
// Design, token-serial and simple. One block per (batch, head) and role,
// hs threads:
// - rows (blockIdx.y role 0): thread i owns row i of S and of G, so dr,
//   dk, dw, du and the G step need no exchange between threads. S_{t-1} is
//   never rebuilt backwards (no division by w: w = 0 is an ordinary value).
//   A forward walk keeps S at every 32nd token in a workspace; the reverse
//   walk, at each chunk of 32 tokens, recomputes the chunk's states from
//   its checkpoint into a second workspace (its own rows only) and walks
//   them back. Both workspaces are [.., hs / 4, hs] float4, thread i at
//   column i: a warp's stores and loads are contiguous.
// - columns (role 1): thread j owns column j of G, whose step G[:, j] <-
//   w_t * G[:, j] + r_t dy_t[j] needs no state at all, and gives dv.
// A chunk's r, k, v, w and dy are staged in shared memory as float32, with
// the per-token dots dy . v and r . (u * k) computed once. du is written
// per (batch, head) and summed over the batch in order by a second kernel:
// no atomics, so a rerun gives the same bits. The tail chunk runs its own
// count of tokens, so any T >= 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCk = 32;  // tokens a chunk, and between two checkpoints

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Str {  // element strides of [B, T, H, hs]; the last axis is 1
  int64_t b, t, h;
};

template <int HS>
struct Stage {
  float r[kCk][HS], k[kCk][HS], v[kCk][HS], w[kCk][HS], dy[kCk][HS];
  float u[HS];
  float dyv[kCk];  // dy_t . v_t
  float ruk[kCk];  // sum_i r_t[i] u[i] k_t[i]
};

// Stage tokens [t0, t0 + nt) of (b, h) and their dots; a barrier before
// (the previous chunk's readers) and after.
template <int HS, typename T>
__device__ void stage(Stage<HS>& sm, const T* r, const T* k, const T* v,
                      const float* w, const T* dy, Str rs, Str ws, Str ds,
                      int b, int h, int t0, int nt) {
  const int i = threadIdx.x;
  __syncthreads();
  for (int tt = 0; tt < nt; ++tt) {
    const int64_t t = t0 + tt;
    const int64_t o = b * rs.b + t * rs.t + h * rs.h + i;
    sm.r[tt][i] = ld(r + o);
    sm.k[tt][i] = ld(k + o);
    sm.v[tt][i] = ld(v + o);
    sm.w[tt][i] = w[b * ws.b + t * ws.t + h * ws.h + i];
    sm.dy[tt][i] = ld(dy + b * ds.b + t * ds.t + h * ds.h + i);
  }
  __syncthreads();
  for (int tt = i; tt < nt; tt += HS) {
    float a = 0.f, c = 0.f;
#pragma unroll 16
    for (int j = 0; j < HS; ++j) {
      a = fmaf(sm.dy[tt][j], sm.v[tt][j], a);
      c = fmaf(sm.r[tt][j] * sm.u[j], sm.k[tt][j], c);
    }
    sm.dyv[tt] = a;
    sm.ruk[tt] = c;
  }
  __syncthreads();
}

// row i of a [hs, hs] matrix in a [hs / 4, hs] float4 workspace
template <int HS>
__device__ __forceinline__ void put_row(float4* p, const float (&x)[HS]) {
#pragma unroll
  for (int q = 0; q < HS / 4; ++q)
    p[q * HS + threadIdx.x] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}
template <int HS>
__device__ __forceinline__ void get_row(const float4* p, float (&x)[HS]) {
#pragma unroll
  for (int q = 0; q < HS / 4; ++q) {
    const float4 a = p[q * HS + threadIdx.x];
    x[4 * q] = a.x;
    x[4 * q + 1] = a.y;
    x[4 * q + 2] = a.z;
    x[4 * q + 3] = a.w;
  }
}

// S <- diag(w_t) S + k_t v_t^T on row i
template <int HS>
__device__ __forceinline__ void step_row(const Stage<HS>& sm, int tt,
                                         float (&S)[HS]) {
  const float wi = sm.w[tt][threadIdx.x], ki = sm.k[tt][threadIdx.x];
#pragma unroll
  for (int j = 0; j < HS; ++j) S[j] = fmaf(wi, S[j], ki * sm.v[tt][j]);
}

template <int HS, typename T>
__global__ void __launch_bounds__(HS) wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const T* __restrict__ dy, const float* __restrict__ dsT,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ ds0, float4* __restrict__ ckpt,
    float4* __restrict__ chunk, int H, int n_tok, int role0, Str rs, Str ws,
    Str ds) {
  __shared__ Stage<HS> sm;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int nck = (n_tok + kCk - 1) / kCk;
  const bool rows = blockIdx.y + role0 == 0;
  sm.u[i] = u[h * HS + i];   // read after stage()'s first barrier
  // the gradient of the final state: row i (rows) or column i (columns)
  float G[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j)
    G[j] = dsT == nullptr ? 0.f
           : rows        ? dsT[((int64_t)bh * HS + i) * HS + j]
                         : dsT[((int64_t)bh * HS + j) * HS + i];
  const auto out = [&](int t) {
    return (((int64_t)b * n_tok + t) * H + h) * HS + i;
  };

  if (!rows) {  // columns: dv only
    for (int c = nck - 1; c >= 0; --c) {
      const int t0 = c * kCk, nt = min(kCk, n_tok - t0);
      stage<HS>(sm, r, k, v, w, dy, rs, ws, ds, b, h, t0, nt);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float dyj = sm.dy[tt][i];
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < HS; ++j) a = fmaf(G[j], sm.k[tt][j], a);
        st(dv + out(t0 + tt), fmaf(sm.ruk[tt], dyj, a));
#pragma unroll
        for (int j = 0; j < HS; ++j)
          G[j] = fmaf(sm.w[tt][j], G[j], sm.r[tt][j] * dyj);
      }
    }
    return;
  }

  // rows: a forward walk for the checkpoints (chunk c's incoming state)
  float4* const cp = ckpt + (int64_t)bh * nck * (HS / 4) * HS;
  float4* const cs = chunk + (int64_t)bh * kCk * (HS / 4) * HS;
  float S[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j) S[j] = s0[((int64_t)bh * HS + i) * HS + j];
  for (int c = 0; c < nck; ++c) {
    put_row<HS>(cp + (int64_t)c * (HS / 4) * HS, S);
    if (c == nck - 1) break;
    stage<HS>(sm, r, k, v, w, dy, rs, ws, ds, b, h, c * kCk, kCk);
    for (int tt = 0; tt < kCk; ++tt) step_row<HS>(sm, tt, S);
  }
  // the reverse walk, a chunk at a time: its states recomputed, then G
  // stepped back through them
  float du_acc = 0.f;
  const float ui = sm.u[i];
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kCk, nt = min(kCk, n_tok - t0);
    stage<HS>(sm, r, k, v, w, dy, rs, ws, ds, b, h, t0, nt);
    get_row<HS>(cp + (int64_t)c * (HS / 4) * HS, S);
    for (int tt = 0; tt < nt; ++tt) {
      put_row<HS>(cs + (int64_t)tt * (HS / 4) * HS, S);   // S_{t-1}
      if (tt + 1 < nt) step_row<HS>(sm, tt, S);
    }
    for (int tt = nt - 1; tt >= 0; --tt) {
      get_row<HS>(cs + (int64_t)tt * (HS / 4) * HS, S);
      const float ri = sm.r[tt][i], ki = sm.k[tt][i], wi = sm.w[tt][i];
      const float dyv = sm.dyv[tt];
      float a = 0.f, e = 0.f, f = 0.f;
#pragma unroll
      for (int j = 0; j < HS; ++j) {
        a = fmaf(sm.dy[tt][j], S[j], a);
        e = fmaf(G[j], sm.v[tt][j], e);
        f = fmaf(G[j], S[j], f);
      }
      const int64_t o = out(t0 + tt);
      if (dr) st(dr + o, fmaf(ui * ki, dyv, a));
      if (dk) st(dk + o, fmaf(ui * ri, dyv, e));
      if (dw) dw[o] = f;
      du_acc = fmaf(ri * ki, dyv, du_acc);
#pragma unroll
      for (int j = 0; j < HS; ++j) G[j] = fmaf(wi, G[j], ri * sm.dy[tt][j]);
    }
  }
  if (du_part) du_part[(int64_t)bh * HS + i] = du_acc;
  if (ds0) {
#pragma unroll
    for (int j = 0; j < HS; ++j) ds0[((int64_t)bh * HS + i) * HS + j] = G[j];
  }
}

// du[h, i] = sum over b of du_part[b, h, i], b in order
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int B, int H, int hs) {
  const int h = blockIdx.x, i = threadIdx.x;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += du_part[((int64_t)b * H + h) * hs + i];
  du[h * hs + i] = a;
}

template <int HS, typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0,
                   const void* dy, const void* dsT, void* dr, void* dk,
                   void* dv, void* dw, void* du, void* du_part, void* ds0,
                   void* ckpt, void* chunk, int B, int H, int n_tok, Str rs,
                   Str ws, Str ds, cudaStream_t s) {
  const bool rows = dr || dk || dw || du || ds0, cols = dv != nullptr;
  if (!rows && !cols) return cudaSuccess;
  const dim3 grid(B * H, rows + cols);
  wkv6_bwd_kernel<HS, T><<<grid, HS, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const T*>(dy), static_cast<const float*>(dsT),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), du ? static_cast<float*>(du_part) : nullptr,
      static_cast<float*>(ds0), static_cast<float4*>(ckpt),
      static_cast<float4*>(chunk), H, n_tok, rows ? 0 : 1, rs, ws, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !du) return err;
  wkv6_du_kernel<<<H, HS, 0, s>>>(static_cast<const float*>(du_part),
                                  static_cast<float*>(du), B, H, HS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, dy: [B, T, H, hs] float32 (bf16 != 0: bfloat16), element
// strides (rb, rt, rh) for r, k and v, (db, dt, dh) for dy, the last axis
// contiguous; w: [B, T, H, hs] f32, strides (wb, wt, wh); u: [H, hs] f32;
// s0: [B, H, hs, hs] f32; dsT: the final state's gradient, the same, or
// null (none). Outputs, each null where its gradient is not wanted: dr, dk,
// dv [B, T, H, hs] contiguous in r's type; dw the same in f32; du [H, hs]
// f32 (du_part: [B, H, hs] f32 scratch when du is wanted); ds0 [B, H, hs,
// hs] f32. ckpt: [B, H, ceil(T / 32), hs, hs] f32 and chunk: [B, H, 32,
// hs, hs] f32 scratch, 16-byte aligned, when any of dr, dk, dw, du or ds0
// is wanted. hs is 16 or 64, T >= 1. Returns cudaErrorInvalidValue
// otherwise, else cudaGetLastError() after the launches.
int repro_wkv6_backward(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* dr, void* dk,
                        void* dv, void* dw, void* du, void* du_part,
                        void* ds0, void* ckpt, void* chunk, int B, int H,
                        int n_tok, int hs, int bf16, int64_t rb, int64_t rt,
                        int64_t rh, int64_t wb, int64_t wt, int64_t wh,
                        int64_t db, int64_t dt, int64_t dh, void* stream) {
  const bool rows = dr || dk || dw || du || ds0;
  if ((hs != 16 && hs != 64) || n_tok < 1 || B < 1 || H < 1 ||
      (du && !du_part) ||
      (rows && (!ckpt || !chunk ||
                (reinterpret_cast<uintptr_t>(ckpt) |
                 reinterpret_cast<uintptr_t>(chunk)) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Str rs{rb, rt, rh}, ws{wb, wt, wh}, ds{db, dt, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_WKV6_BWD(HS, T)                                                 \
  launch<HS, T>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, du_part, ds0, \
                ckpt, chunk, B, H, n_tok, rs, ws, ds, s)
  if (hs == 64)
    err = bf16 ? REPRO_WKV6_BWD(64, __nv_bfloat16) : REPRO_WKV6_BWD(64, float);
  else
    err = bf16 ? REPRO_WKV6_BWD(16, __nv_bfloat16) : REPRO_WKV6_BWD(16, float);
#undef REPRO_WKV6_BWD
  return static_cast<int>(err);
}

}  // extern "C"
