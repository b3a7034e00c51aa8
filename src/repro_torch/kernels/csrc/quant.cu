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
// element: one block owns one tile, 256 threads x 4 elements, 16-byte loads,
// a warp-shuffle amax reduction, then each thread writes its 4 codes as one
// char4. dequantize reads 1 byte (+4 per tile) and writes 4 (or 2) per
// element kept: it takes [K, Np] codes with a row stride and writes only the
// n <= Np columns the caller keeps, into rows 16-byte aligned. A warp takes
// 512 codes at once, a thread 16 as four 4-byte loads (all in flight
// before its stores) and four float4 (or 4 x bf16) streaming stores, every
// warp-wide access one contiguous span; the grid is sized from the SM
// count and occupancy (stream.cuh).
// Bit-exactness with the reference: the scale is amax times the float32
// constant 1/127, as the reference's compiled kernel forms it (XLA turns its
// division by a constant into that product); x / s is an IEEE division (no
// fast math, no reciprocal multiply) and rintf rounds half to even like
// jnp.round. dequantize rounds (float)q * s once, and a bf16 output rounds
// that float32 product to nearest even, as the reference's astype does.
// Offsets are 64-bit: a [K, N] batch reaches 2^31 elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "stream.cuh"

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four products at out, 16-byte aligned for float (8 for bf16).
__device__ __forceinline__ void store4(float* o, const float* v) {
  stream::st(reinterpret_cast<float4*>(o),
                 make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  stream::st(reinterpret_cast<uint2*>(o),
                 make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                            *reinterpret_cast<const unsigned*>(&hi)));
}

// Row blockIdx.y of codes [K, >= n] (row stride ldq) and scales [K, >= n /
// 1024] (row stride lds) -> its first n outputs (row stride ldo, 16-byte
// aligned rows). Warp w takes chunks w, w + warps, ... of 512 codes: all
// four of its loads a thread, then the stores. Codes rows hold whole
// 1024-tiles, so a chunk's codes are always there; a chunk lies in one tile
// (one scale), and only a row's last chunk masks stores.
template <typename T, int QA>
__global__ void __launch_bounds__(stream::kMaxThreads)
dequantize_kernel(const int8_t* __restrict__ q, int64_t ldq,
                  const float* __restrict__ scales, int64_t lds,
                  T* __restrict__ out, int64_t ldo, int64_t n) {
  using namespace stream;
  constexpr int S = kWide;
  constexpr int kChunk = S * kSpan;
  q += blockIdx.y * ldq;
  scales += blockIdx.y * lds;
  out += blockIdx.y * ldo;
  const int lane = threadIdx.x % 32;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t warps = (int64_t)gridDim.x * blockDim.x / 32;
  for (int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       c < chunks; c += warps) {
    const int8_t* qc = q + c * kChunk + kVec * lane;
    unsigned w[S];
#pragma unroll
    for (int k = 0; k < S; ++k) w[k] = load_codes<QA>(qc + k * kSpan);
    const float s = ld(scales + c * kChunk / stream::kTile);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int64_t e = c * kChunk + k * kSpan + kVec * lane;
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = code(w[k], j) * s;
      if (e + kVec <= n) {
        store4(out + e, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (e + j < n) out[e + j] = from_f32<T>(v[j]);
      }
    }
  }
}

template <typename T, int QA>
cudaError_t launch_dq(const void* q, int64_t ldq, const float* s, int64_t lds,
                      void* out, int64_t ldo, int K, int64_t n,
                      cudaStream_t st) {
  constexpr auto kernel = &dequantize_kernel<T, QA>;
  constexpr int kChunk = stream::kWide * stream::kSpan;
  dim3 grid;
  int threads;
  stream::grid_for(reinterpret_cast<const void*>(kernel),
                   (n + kChunk - 1) / kChunk * 32, K, &grid, &threads);
  return stream::launch(kernel, grid, threads, st,
                        static_cast<const int8_t*>(q), ldq, s, lds,
                        static_cast<T*>(out), ldo, n);
}

template <typename T>
cudaError_t dispatch_dq(const void* q, int64_t ldq, const float* s,
                        int64_t lds, void* out, int64_t ldo, int K, int64_t n,
                        cudaStream_t st) {
  if (stream::code_align(q, K > 1 ? ldq : 0) == 4)
    return launch_dq<T, 4>(q, ldq, s, lds, out, ldo, K, n, st);
  return launch_dq<T, 1>(q, ldq, s, lds, out, ldo, K, n, st);
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

// q: [K, >= n] int8 codes, row stride ldq (rows of whole 1024-tiles);
// scales: [K, >= ceil(n / 1024)] float32, row stride lds -> out: [K, n],
// row stride ldo, float32 (bf16 != 0: bfloat16), rows 16-byte aligned.
int repro_dequantize(const void* q, int64_t ldq, const void* scales,
                     int64_t lds, void* out, int64_t ldo, int K, int64_t n,
                     int bf16, void* stream) {
  const int64_t esize = bf16 ? 2 : 4;
  if (K < 1 || K > 65535 || n < 1 ||
      ((reinterpret_cast<uintptr_t>(out) |
        (uintptr_t)(K > 1 ? ldo * esize : 0)) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_dq<__nv_bfloat16>(q, ldq, s, lds, out, ldo, K, n, st)
           : dispatch_dq<float>(q, ldq, s, lds, out, ldo, K, n, st);
  return static_cast<int>(err);
}

// repro_dequantize's arguments in order, each as an int64 (pointers
// included): one pointer to pass instead of ten typed values.
int repro_dequantize_packed(const int64_t* a) {
  return repro_dequantize(
      reinterpret_cast<const void*>(a[0]), a[1],
      reinterpret_cast<const void*>(a[2]), a[3], reinterpret_cast<void*>(a[4]),
      a[5], (int)a[6], a[7], (int)a[8], reinterpret_cast<void*>(a[9]));
}

}  // extern "C"
