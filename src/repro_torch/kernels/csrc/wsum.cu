// Weighted sum of M flattened models: out[n] = sum_m w[m] * x[m, n].
//
// Replaces the Pallas kernel src/repro/kernels/wsum.py:27 (weighted_sum,
// body _kernel :18), the intra-silo FedAvg of every round.
//
// Bound: memory. It reads M*N inputs once and writes N outputs, (M+1)*N*4
// bytes in float32, against 2*M*N flops. It is a one-touch stream: each
// thread owns V consecutive outputs, issues the loads of up to 8 model rows
// before their FMAs (M*16 bytes in flight a thread), and keeps the float32
// sums in registers. Plain vector loads reach most of the memory rate at
// N = 2^28; staging through shared memory or TMA would add a copy and buy
// nothing for data read once.
//
// The operand is [M, N] with row stride ld >= N, any N >= 1, so the caller
// hands over views and unpadded models. The vector is the widest that the
// base pointer and ld allow (16, 8 or 4 bytes; 2 for an odd bf16 offset);
// the ragged tail is masked. The sum over m runs in order 0..M-1 with fmaf
// from 0, whatever the width, so the bits do not depend on the layout.
//
// The weights come either as a device pointer, read through the read-only
// cache, or, for M <= 64 host weights (FedAvg's), by value in the kernel's
// parameters (__grid_constant__, read in place): no host-to-device copy, and
// no shared-memory staging or barrier before the first loads.
//
// The grid covers N with one vector a thread, 256 threads a block, halved
// down to 64 until the blocks cover every SM (the paper CNN's N = 62,006 at
// M = 2 takes 243 blocks of 128); at most 32 blocks of 256 an SM, beyond
// which threads stride. Offsets are 64-bit: M*N reaches 2^31.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSMs = 132;  // H100 SXM; elsewhere the grid only fits less well
constexpr int kMaxHostM = 64;
constexpr int kUnroll = 8;   // model rows whose loads a thread issues at once

struct HostWeights { float v[kMaxHostM]; };

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__global__ void weighted_sum_kernel(const T* __restrict__ x, int64_t ld,
                                    const float* __restrict__ wdev,
                                    const __grid_constant__ HostWeights wh,
                                    T* __restrict__ out, int M, int64_t N) {
  using Raw = typename RawOf<V * sizeof(T)>::type;
  const int64_t nvec = (N + V - 1) / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int64_t n0 = i * V;
    if (n0 + V <= N) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
      for (int m0 = 0; m0 < M; m0 += kUnroll) {
        Raw r[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          if (m0 + k < M)
            r[k] = *reinterpret_cast<const Raw*>(x + (m0 + k) * ld + n0);
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (m0 + k < M) {
            const float wm = wdev ? __ldg(wdev + m0 + k) : wh.v[m0 + k];
            const T* e = reinterpret_cast<const T*>(&r[k]);
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[j] = fmaf(wm, to_f32(e[j]), acc[j]);
          }
        }
      }
      Raw o;
      T* e = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_f32<T>(acc[j]);
      *reinterpret_cast<Raw*>(out + n0) = o;
    } else {  // the ragged tail: fewer than V outputs, one at a time
      for (int64_t n = n0; n < N; ++n) {
        float acc = 0.f;
        for (int m = 0; m < M; ++m)
          acc = fmaf(wdev ? __ldg(wdev + m) : wh.v[m], to_f32(x[m * ld + n]),
                     acc);
        out[n] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, int64_t ld, const float* wdev,
                   const HostWeights& wh, void* out, int M, int64_t N,
                   cudaStream_t s) {
  const int64_t work = (N + V - 1) / V;
  int threads = 256;
  while (threads > 64 && (work + threads - 1) / threads < kSMs) threads /= 2;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = (int64_t)kSMs * 32 * 256 / threads;
  if (blocks > cap) blocks = cap;
  weighted_sum_kernel<T, V><<<(int)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), ld, wdev, wh, static_cast<T*>(out), M, N);
  return cudaGetLastError();
}

// The widest vector (16, 8, 4 or 2 bytes) that every row start allows.
template <typename T>
cudaError_t dispatch(const void* x, int64_t ld, const float* wdev,
                     const HostWeights& wh, void* out, int M, int64_t N,
                     cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out) |
                      (M > 1 ? (uintptr_t)(ld * sizeof(T)) : 0);
  constexpr int E = sizeof(T);
  if (a % 16 == 0) return launch<T, 16 / E>(x, ld, wdev, wh, out, M, N, s);
  if (a % 8 == 0) return launch<T, 8 / E>(x, ld, wdev, wh, out, M, N, s);
  if (a % 4 == 0 || E == 4)
    return launch<T, 4 / E>(x, ld, wdev, wh, out, M, N, s);
  return launch<T, 1>(x, ld, wdev, wh, out, M, N, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [M, N] float32 (bf16 != 0: bfloat16), row stride ld >= N elements,
// element-aligned; weights: w_dev [M] float32 on the card, or (w_dev null,
// M <= 64) w_host [M] float32 in host memory, read before this returns;
// out: [N] in x's type.
int repro_weighted_sum(const void* x, int64_t ld, const void* w_dev,
                       const void* w_host, void* out, int M, int64_t N,
                       int bf16, void* stream) {
  HostWeights wh{};
  const float* wdev = static_cast<const float*>(w_dev);
  if (!wdev) {
    if (!w_host || M > kMaxHostM)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int m = 0; m < M; ++m) wh.v[m] = static_cast<const float*>(w_host)[m];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(x, ld, wdev, wh, out, M, N, s)
           : dispatch<float>(x, ld, wdev, wh, out, M, N, s);
  return static_cast<int>(err);
}

}  // extern "C"
