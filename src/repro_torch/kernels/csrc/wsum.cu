// Weighted sum of M flattened models: out[n] = sum_m w[m] * x[m, n].
//
// Replaces the Pallas kernel src/repro/kernels/wsum.py:27 (weighted_sum,
// body _kernel :18), the intra-silo FedAvg of every round.
//
// Bound: memory. It reads M*N inputs once and writes N outputs, (M+1)*N*4
// bytes in float32, against 2*M*N flops. Each thread owns 4 consecutive
// outputs, loads them as one 16-byte vector per model row, and keeps the
// float32 sums in registers across the loop over M; w sits in shared memory.
// Offsets are 64-bit: M*N reaches 2^31 at the sizes the silo merge sees.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct F4 { float v[4]; };

__device__ __forceinline__ F4 load4(const float* p) {
  float4 a = *reinterpret_cast<const float4*>(p);
  return F4{{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ F4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return F4{{a.x, a.y, b.x, b.y}};
}

__device__ __forceinline__ void store4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const F4& a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.v[0], a.v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.v[2], a.v[3]);
  uint2 bits;
  bits.x = *reinterpret_cast<const unsigned int*>(&lo);
  bits.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}

template <typename T>
__global__ void weighted_sum_kernel(const T* __restrict__ x,
                                    const float* __restrict__ w,
                                    T* __restrict__ out, int M, int64_t N) {
  extern __shared__ float sw[];
  for (int m = threadIdx.x; m < M; m += blockDim.x) sw[m] = w[m];
  __syncthreads();
  const int64_t n4 = N / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    F4 acc{{0.f, 0.f, 0.f, 0.f}};
    const T* col = x + 4 * i;
    for (int m = 0; m < M; ++m) {
      F4 v = load4(col + (int64_t)m * N);
      const float wm = sw[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[j] = fmaf(wm, v.v[j], acc.v[j]);
    }
    store4(out + 4 * i, acc);
  }
}

constexpr int kThreads = 256;

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [M, N] float32 (bf16 != 0: bfloat16), N % 4 == 0, 16/8-byte aligned;
// w: [M] float32; out: [N] in x's type.
int repro_weighted_sum(const void* x, const void* w, void* out, int M,
                       int64_t N, int bf16, void* stream) {
  const int grid = grid_for(N / 4);
  const size_t smem = (size_t)M * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    weighted_sum_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), M, N);
  } else {
    weighted_sum_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
