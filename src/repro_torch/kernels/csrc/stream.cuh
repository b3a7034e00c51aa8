// Shared by the streaming int8 kernels, quantize and dequantize (quant.cu),
// wsum_q8 and add_q8_delta (q8agg.cu). A warp takes a chunk of S x 128
// elements at once (quantize: a whole 1024-tile, S = 8, on large
// payloads; a block of 8 warps a tile below): each thread S
// vectors of 4, spaced 128 apart, so that every warp-wide access is one
// contiguous span (128 bytes of codes, 512 of f32).
// (16 contiguous codes a thread, one 16-byte load, reached under half of
// the bound at N = 2^28: each warp-wide float4 store then writes half
// sectors spread over 2 KB.) S is 4 (four loads in flight a thread) for
// dequantize at every size and for add_q8_delta from kAddWideMin elements
// on; below that add_q8_delta takes S = 1, so that the paper CNN's 62,006
// elements spread over every SM. The grid is sized from the SM count and
// the blocks an SM holds.
//
// Cache hints: codes, quantize's input and add_q8_delta's base are read
// through the read-only path (ld.global.nc), and outputs go out with
// st.global.cs
// (evict first): at 2^28 dequantize runs faster so, and at the paper CNN's
// size the next kernel, which reads the output, no slower.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace stream {

constexpr int kTile = 1024;   // codes a scale
constexpr int kVec = 4;       // elements a thread moves in one access
constexpr int kSpan = 32 * kVec;   // elements a warp moves in one access
constexpr int kWide = 4;           // S of a large launch: a chunk of 512
constexpr int64_t kAddWideMin = int64_t{1} << 20;  // add_q8_delta's S = 4
constexpr int kMaxThreads = 256;

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}

template <typename T>
__device__ __forceinline__ void st(T* p, T v) {
  __stcs(p, v);
}

// 4 codes from an address aligned to QA bytes (4 or 1).
template <int QA>
__device__ __forceinline__ unsigned load_codes(const int8_t* p) {
  if constexpr (QA == 4) {
    return ld(reinterpret_cast<const unsigned*>(p));
  } else {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
    return (unsigned)ld(b) | ((unsigned)ld(b + 1) << 8) |
           ((unsigned)ld(b + 2) << 16) | ((unsigned)ld(b + 3) << 24);
  }
}

// Four floats at p, from an address aligned to BA bytes (16, 8 or 4).
template <int BA>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (BA == 16) {
    return ld(reinterpret_cast<const float4*>(p));
  } else if constexpr (BA == 8) {
    const float2 a = ld(reinterpret_cast<const float2*>(p));
    const float2 b = ld(reinterpret_cast<const float2*>(p) + 1);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(ld(p), ld(p + 1), ld(p + 2), ld(p + 3));
  }
}

// The alignment in bytes (16, 8 or 4) of a float operand at p.
inline int float_align(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
}

// Code j of a word of 4, as a float (exact: |q| <= 127).
__device__ __forceinline__ float code(unsigned w, int j) {
  return (float)((int)(w << (24 - 8 * j)) >> 24);
}

inline int code_align(const void* p, int64_t ld_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | (uintptr_t)ld_bytes;
  return a % 4 == 0 ? 4 : 1;
}

// SMs of the card, asked once (the port drives one type of card): no
// runtime call a launch.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks of `threads` that one SM holds of `kernel`, asked once a kernel
// and block size (the port drives one type of card).
inline int blocks_per_sm(const void* kernel, int threads) {
  struct Entry { const void* kernel; int threads, blocks; };
  static Entry cached[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cached[i].kernel == kernel && cached[i].threads == threads)
      return cached[i].blocks;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0);
  if (n < 1) n = 1;
  if (used < 64) cached[used++] = {kernel, threads, n};
  return n;
}

// `work` threads on each of `rows` rows (blockIdx.y): 256 threads a block,
// halved down to 64 until the blocks cover every SM, and at most the blocks
// the card holds at once (threads then stride).
inline void grid_for(const void* kernel, int64_t work, int rows, dim3* grid,
                     int* threads) {
  const int64_t sms = sm_count();
  int t = kMaxThreads;
  while (t > 64 && (work + t - 1) / t * rows < sms) t /= 2;
  int64_t bx = (work + t - 1) / t;
  int64_t cap = sms * blocks_per_sm(kernel, t) / rows;
  if (cap < 1) cap = 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  *grid = dim3((unsigned)bx, (unsigned)rows);
  *threads = t;
}

// Queue `kernel` and return its launch error: one runtime call a launch
// (cudaLaunchKernelEx returns what a cudaGetLastError after <<<>>> would).
// A refused launch's error is also cleared from the runtime's last-error
// slot, so that no later caller reports it again.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace stream
