// Shared by the WKV6 forward (wkv6.cu) and backward (wkv6_bwd.cu): the
// chunk sizes, loads of four elements, the float32-accurate TF32 product on
// the tensor cores (mma_x, mma3: up to three TF32 products a tile) with its
// fragment loads, the lane butterflies, and the diagonal sub-chunks of a
// chunk's A (diag_rows), every decay a product of w.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {  // one private copy per source file that includes this

constexpr int kC = 32;    // tokens a chunk
constexpr int kSub = 16;  // tokens a sub-chunk
constexpr int kLdA = kC + 8;  // rows of A^T (AT[s][t]): fragment loads hit
                              // 32 distinct banks

template <typename T> struct Raw;  // four elements as loaded
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f4(float4 x) { return x; }
__device__ __forceinline__ float4 to_f4(uint2 x) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a = hi + lo: hi the top 10 mantissa bits of a rounded to nearest (ties
// away from zero) by integer arithmetic, lo = a - hi exactly (the tensor
// cores read its top 10 mantissa bits)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a b over one m16n8k8 tile in TF32 products at float32 accuracy: a =
// ah + al, b = bh + bl; a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo is
// below float32's rounding), without the product of a lo part known to be
// zero: an operand that holds bf16 values (8 mantissa bits) is exact in
// TF32 (A_EXACT, B_EXACT). a: 4 values, b: 2, each as (hi, lo).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_x(float* d, const uint32_t* ah,
                                      const uint32_t* al, const uint32_t* bh,
                                      const uint32_t* bl) {
#define REPRO_MMA(A, B)                                                    \
  asm volatile(                                                            \
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, " \
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                     \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(B[0]), "r"(B[1]))
  if constexpr (!A_EXACT) REPRO_MMA(al, bh);
  if constexpr (!B_EXACT) REPRO_MMA(ah, bl);
  REPRO_MMA(ah, bh);
#undef REPRO_MMA
}

// all three products
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_x<false, false>(d, ah, al, bh, bl);
}

// An m16n8k8 A fragment of the matrix M[row][col] = X[col * ld + row]
// (X holds M transposed), rows r0 .., columns k0 ..; split.
__device__ __forceinline__ void frag_a(const float* X, int ld, int r0, int k0,
                                       int lane, uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (k0 + t) * ld + r0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * ld], hi[2], lo[2]);
  split(p[4 * ld + 8], hi[3], lo[3]);
}

// An m16n8k8 B fragment of M[k][n] = X[k * ld + n], k0 .., n0 ..; split.
__device__ __forceinline__ void frag_b(const float* X, int ld, int k0, int n0,
                                       int lane, uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (k0 + t) * ld + n0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[4 * ld], hi[1], lo[1]);
}

// The sum of v over groups of L adjacent lanes (a power of two <= 32): a
// fixed butterfly, every lane of a group gets the same total.
__device__ __forceinline__ float lane_sum(float v, int L) {
  for (int off = L >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One step of a butterfly that halves what each lane holds: lanes with bit
// 2 * N of their index set keep vals[N .. 2N) and the others vals[0 .. N),
// each adding its partner's copy (unrolled: the array stays in registers).
template <int N>
__device__ __forceinline__ void halve(float* vals, int lane) {
  const bool up = lane & (2 * N);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float give = up ? vals[j] : vals[j + N];
    const float keep = up ? vals[j + N] : vals[j];
    vals[j] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * N);
  }
}

// Rows p and 15 - p of both sub-chunks of A: A[t, s] for s < t = sum_i
// r_t[i] k_s[i] prod(w[s+1 .. t-1])[i], r_t carried backwards by a running
// product (15 pairs a sub-chunk: p of row p, 15 - p of row 15 - p). The
// warp's lanes take 2 adjacent channels each (HS = 16: lanes 0-7); the 15
// sums leave by a fixed butterfly that halves what each lane holds, and
// lane 2e writes sum e. One copy of the code serves every p.
// R, K and Wt hold a chunk's tokens in rows of LD floats.
template <int HS, int LD = HS>
__device__ __forceinline__ void diag_rows(const float* R, const float* K,
                                          const float* Wt, float* AT, int p,
                                          int lane) {
  const int c = 2 * lane;
  const bool on = c < HS;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const int base = sub * kSub;
    float vals[16];
    float2 rp = on ? *reinterpret_cast<const float2*>(R + (base + p) * LD + c)
                   : make_float2(0.f, 0.f);
    const float2 r2 =
        on ? *reinterpret_cast<const float2*>(R + (base + kSub - 1 - p) * LD +
                                              c)
           : make_float2(0.f, 0.f);
    float2 kk[kSub - 1], ww[kSub - 1];  // every load first
#pragma unroll
    for (int e = 0; e < kSub - 1; ++e) {
      const int sr = base + (e < p ? p - 1 - e : kSub - 2 - e);
      kk[e] = on ? *reinterpret_cast<const float2*>(K + sr * LD + c)
                 : make_float2(0.f, 0.f);
      ww[e] = on ? *reinterpret_cast<const float2*>(Wt + sr * LD + c)
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < kSub - 1; ++e) {
      if (e == p) rp = r2;  // the first row is done: the second
      vals[e] = fmaf(rp.y, kk[e].y, rp.x * kk[e].x);
      rp.x *= ww[e].x;
      rp.y *= ww[e].y;
    }
    vals[kSub - 1] = 0.f;
    // lane l ends with the sum over the warp of vals[l >> 1]
    halve<8>(vals, lane);
    halve<4>(vals, lane);
    halve<2>(vals, lane);
    halve<1>(vals, lane);
    const float sum = vals[0] + __shfl_xor_sync(0xffffffffu, vals[0], 1);
    const int e = lane >> 1;
    if ((lane & 1) == 0 && e < kSub - 1) {
      const int t = e < p ? p : kSub - 1 - p;
      const int sr = e < p ? p - 1 - e : kSub - 2 - e;
      AT[(base + sr) * kLdA + base + t] = sum;
    }
  }
}

}  // namespace
