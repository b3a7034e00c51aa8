// Symmetric per-tile int8 quantize / dequantize (the int8 wire format).
//
// quantize replaces src/repro/kernels/quant.py:34 (body _q_kernel :19):
//   per 1024-element tile  s = amax * (1/127) (1.0 for an all-zero tile),
//                          q = clip(round_half_even(x / s), -127, 127).
// dequantize replaces the body _dq_kernel (quant.py:28) of both entry points,
// quant.py:79 (dequantize, K = 1) and quant.py:55 (dequantize_batch, K rows):
//   x = q * s[tile], written as float32 or bfloat16.
//
// Bound: memory. quantize reads 4 bytes and writes 1 (+4 per tile) per
// element; dequantize reads 1 (+4 per tile) and writes 4 (or 2). One block
// owns one tile: 256 threads x 4 elements, 16-byte loads, a warp-shuffle
// amax reduction, then each thread writes its 4 codes as one char4.
// Bit-exactness with the reference: the scale is amax times the float32
// constant 1/127, as the reference's compiled kernel forms it (XLA turns its
// division by a constant into that product); x / s is an IEEE division (no
// fast math, no reciprocal multiply) and rintf rounds half to even like
// jnp.round.
// Offsets are 64-bit: a [K, N] batch reaches 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = kTile / 4;

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile + 4 * threadIdx.x;
  const float4 v = *reinterpret_cast<const float4*>(x + base);
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, warp_max[i]);
  const float s = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;
  auto code = [s](float a) -> signed char {
    float r = rintf(a / s);
    r = fminf(fmaxf(r, -127.f), 127.f);
    return static_cast<signed char>(static_cast<int>(r));
  };
  *reinterpret_cast<char4*>(q + base) =
      make_char4(code(v.x), code(v.y), code(v.z), code(v.w));
  if (threadIdx.x == 0) scales[tile] = s;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 bits;
  bits.x = *reinterpret_cast<const unsigned int*>(&lo);
  bits.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}

// Flat [total] codes with scales [total / kTile]: a [K, N] batch with
// N % kTile == 0 is the same layout, its row k's tile t at k * N/kTile + t.
template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  T* __restrict__ out, int64_t total) {
  const int64_t n4 = total / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const char4 c = *reinterpret_cast<const char4*>(q + 4 * i);
    const float s = scales[(4 * i) / kTile];
    store4(out + 4 * i, (float)c.x * s, (float)c.y * s, (float)c.z * s,
           (float)c.w * s);
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// x: [N] float32, N % 1024 == 0 -> q: [N] int8, scales: [N / 1024] float32.
int repro_quantize(const void* x, void* q, void* scales, int64_t n,
                   void* stream) {
  const int64_t tiles = n / kTile;
  if (tiles > 0) {
    quantize_kernel<<<(unsigned)tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales));
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [total] int8, scales: [total / 1024] -> out: [total] float32 (bf16 != 0:
// bfloat16).
int repro_dequantize(const void* q, const void* scales, void* out,
                     int64_t total, int bf16, void* stream) {
  const int grid = grid_for(total / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), total);
  } else {
    dequantize_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
