// WKV6 recurrence of RWKV-6 ("Finch") over a segment, exact:
//
//   y_t = (S + diag(u) k_t v_t^T)^T r_t
//   S  <- diag(w_t) S + k_t v_t^T            (S: [hs key, hs value] f32)
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6.py:68 (wkv6, body
// _kernel :25). That kernel evaluates 32-token chunks through cumulative
// log-decays and clips them at -25 before the inverse exponential
// (rwkv6.py:45), which departs from the recurrence wherever a chunk of one
// channel decays past e^-25. This kernel runs the recurrence token by token,
// as the reference's plain scan does (kernels/ref.py wkv6_naive), so no
// clip and no chunk padding: any T.
//
// Bound: per token and (b, h) it does about 7*hs^2 float32 operations on
// 12*hs bytes (bf16 r, k, v and y, f32 w), so at hs = 64 it is bound by the
// float32 rate, not by memory. Design: one block per (b, h), one thread per
// value column j, which keeps S[:, j] (hs floats) in registers for the
// whole segment. Tokens are staged 32 at a time: each thread loads element
// j of r_t, k_t, v_t, w_t (coalesced across the block) and stores it as f32
// in shared memory; the block then steps through the chunk reading r, k, w,
// u as broadcasts. y_j sums over the key index in four independent chains
// to shorten the dependent FMA latency. Keeping 8 tokens' loads in flight
// (4 memory round trips a chunk instead of 32) measured no faster on an
// H100, so the time goes to the token loop. Inputs are read through their
// [B, T, H, hs] strides, so no transposed copy is made. The chunked
// tensor-core form (wgmma over [C, hs] tiles) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// r, k, v share strides (sb, st, sh); w has its own; the last axis is
// contiguous. y is [B, T, H, HS] contiguous; s0, s1 are [B, H, HS, HS].
template <int HS, typename T>
__global__ void __launch_bounds__(HS) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s1,
    int H, int n_tok, int64_t sb, int64_t st, int64_t sh, int64_t wb,
    int64_t wt, int64_t wh) {
  __shared__ __align__(16) float rs[kChunk][HS];
  __shared__ __align__(16) float ks[kChunk][HS];
  __shared__ __align__(16) float ws[kChunk][HS];
  __shared__ float vs[kChunk][HS];
  __shared__ __align__(16) float us[HS];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  const float* s0p = s0 + (int64_t)bh * HS * HS + j;
  float S[HS];
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = s0p[i * HS];
  us[j] = u[h * HS + j];

  const int64_t in_off = (int64_t)b * sb + (int64_t)h * sh + j;
  const T* rp = r + in_off;
  const T* kp = k + in_off;
  const T* vp = v + in_off;
  const float* wp = w + (int64_t)b * wb + (int64_t)h * wh + j;
  const int64_t y_st = (int64_t)H * HS;
  T* yp = y + (int64_t)b * n_tok * y_st + (int64_t)h * HS + j;

  for (int t0 = 0; t0 < n_tok; t0 += kChunk) {
    const int n = min(kChunk, n_tok - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int c = 0; c < n; ++c) {
      const int64_t t = t0 + c;
      rs[c][j] = to_f32(rp[t * st]);
      ks[c][j] = to_f32(kp[t * st]);
      vs[c][j] = to_f32(vp[t * st]);
      ws[c][j] = wp[t * wt];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HS; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vj;
          acc[q] = fmaf(fmaf(uu[q], kv, S[i + q]), rr[q], acc[q]);
          S[i + q] = fmaf(S[i + q], ww[q], kv);
        }
      }
      store_as(yp + (t0 + c) * y_st, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  float* s1p = s1 + (int64_t)bh * HS * HS + j;
#pragma unroll
  for (int i = 0; i < HS; ++i) s1p[i * HS] = S[i];
}

template <int HS, typename T>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* s1, int B, int H,
            int n_tok, int64_t sb, int64_t st, int64_t sh, int64_t wb,
            int64_t wt, int64_t wh, cudaStream_t s) {
  wkv6_kernel<HS, T><<<B * H, HS, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s1), H, n_tok, sb, st, sh, wb,
      wt, wh);
}

}  // namespace

extern "C" {

// r, k, v: [B, T, H, hs] float32 (bf16 != 0: bfloat16), element strides
// (sb, st, sh) and a contiguous last axis; w: [B, T, H, hs] float32 with
// strides (wb, wt, wh); u: [H, hs] f32; s0: [B, H, hs, hs] f32; y: [B, T, H,
// hs] contiguous in r's type; s1: [B, H, hs, hs] f32. hs is 16 or 64.
// Returns cudaErrorInvalidValue for another hs, else cudaGetLastError().
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s1, int B, int H,
               int n_tok, int hs, int bf16, int64_t sb, int64_t st,
               int64_t sh, int64_t wb, int64_t wt, int64_t wh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WKV6(HS, T) \
  launch<HS, T>(r, k, v, w, u, s0, y, s1, B, H, n_tok, sb, st, sh, wb, wt, \
                wh, s)
  if (hs == 64) {
    if (bf16) REPRO_WKV6(64, __nv_bfloat16); else REPRO_WKV6(64, float);
  } else if (hs == 16) {
    if (bf16) REPRO_WKV6(16, __nv_bfloat16); else REPRO_WKV6(16, float);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WKV6
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
