// Symmetric per-tile int8 quantize / dequantize (the int8 wire format).
//
// quantize replaces src/repro/kernels/quant.py:34 (body _q_kernel :19):
//   per 1024-element tile  s = amax * (1/127) (1.0 for an all-zero tile),
//                          q = clip(round_half_even(x / s), -127, 127).
// dequantize replaces the body _dq_kernel (quant.py:28) of both entry points,
// quant.py:79 (dequantize, K = 1) and quant.py:55 (dequantize_batch, K rows):
//   x = q * s[tile], written as float32 or bfloat16.
//
// Bound: memory. quantize reads 4 bytes of each of the n elements it is
// given and writes 1 code of each of the Np >= n of the payload (+4 a
// tile). It takes the caller's [n] floats at any 4-byte alignment and
// writes the payload's zero padding itself: in the ragged tile the
// elements at n and beyond count as 0.0, and a tile wholly past n gets
// 1024 zero codes and the scale 1.0 with no load, the bytes that the
// reference's zero padding (F.pad to Np) gives. From kWarpTileMin tiles
// on, one warp owns one tile: each lane issues its eight 16-byte loads (32
// floats, spaced 128 apart, every warp-wide load one contiguous 512 bytes)
// before any arithmetic, amax is a warp-shuffle reduction (no shared
// memory, no barrier), and each lane writes its 32 codes as eight 4-byte
// streaming stores; warps stride over the tiles of a grid sized from the
// SM count and occupancy. Below it a block of 8 warps owns a tile, one
// load and 4 divisions a lane, the warp maxima meeting in shared memory:
// one warp a tile leaves a small launch (the paper CNN's 128 tiles) with a
// warp an SM, each lane's 32 IEEE divisions in a row, and no other warp
// to hide their latency.
// dequantize reads 1 byte (+4 per tile) and writes 4 (or 2) per
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

// Code of a over the scale s: IEEE division, half to even, clipped; as a
// byte of a little-endian word. A zero a takes the code 0 without its
// division (it divides s by s instead): a zero dividend fails the fast
// path's range check, and the slow path, taken lane by lane for the
// ragged tile's zeros and for all-zero tiles, made up most of a small
// launch's time; the division gives that code too.
__device__ __forceinline__ unsigned quant_byte(float a, float s) {
  const bool zero = a == 0.f;
  float r = rintf((zero ? s : a) / s);
  r = zero ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xffu;
}

__device__ __forceinline__ float amax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// x [n] float32 at an XA-byte alignment (16, 8 or 4) -> q [tiles * 1024]
// int8 and scales [tiles], 4-byte aligned. W warps own a tile: W = 1, warp
// w takes tiles w, w + warps, ... and lane l holds elements k * 128 + 4 l
// .. + 3 of it for k = 0..7, the amax a warp shuffle; W = 8, a block of
// 256 threads takes tiles b, b + blocks, ..., warp j holding elements j *
// 128 + 4 l .. + 3, and the eight warp maxima meet in shared memory (two
// slots, used in turns, so that one barrier a tile is enough). All of a
// lane's loads come before the max. Only the tile holding n masks its
// loads; the tiles past it load nothing.
template <int XA, int W>
__global__ void __launch_bounds__(stream::kMaxThreads)
quantize_kernel(const float* __restrict__ x, int64_t n,
                int8_t* __restrict__ q, float* __restrict__ scales,
                int64_t tiles) {
  using namespace stream;
  constexpr int V = kTile / kSpan / W;    // vectors of 4 a lane: 8 or 1
  const int lane = threadIdx.x % 32;
  const int sub = threadIdx.x / 32 % W;   // the warp's place in its tile
  const int64_t step = (int64_t)gridDim.x * blockDim.x / (32 * W);
  __shared__ float warp_max[2][W];
  int slot = 0;
  for (int64_t t = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) /
                   (32 * W);
       t < tiles; t += step) {
    const int64_t e0 = t * kTile + sub * kSpan + kVec * lane;
    // word k of the lane: codes e0 + k * W * 128 .. + 3
    unsigned* qw = reinterpret_cast<unsigned*>(q + e0);
    const bool first = sub == 0 && lane == 0;
    if (t * kTile >= n) {                 // wholly padding
#pragma unroll
      for (int k = 0; k < V; ++k) st(qw + k * W * 32, 0u);
      if (first) st(scales + t, 1.0f);
      continue;
    }
    float4 v[V];
    if ((t + 1) * kTile <= n) {
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = ld4<XA>(x + e0 + k * W * kSpan);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t e = e0 + k * W * kSpan;
        v[k] = make_float4(e < n ? ld(x + e) : 0.f,
                           e + 1 < n ? ld(x + e + 1) : 0.f,
                           e + 2 < n ? ld(x + e + 2) : 0.f,
                           e + 3 < n ? ld(x + e + 3) : 0.f);
      }
    }
    float m = amax4(v[0]);
#pragma unroll
    for (int k = 1; k < V; ++k) m = fmaxf(m, amax4(v[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if constexpr (W > 1) {
      if (lane == 0) warp_max[slot][sub] = m;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < W; ++j) m = fmaxf(m, warp_max[slot][j]);
      slot ^= 1;
    }
    const float s = m > 0.f ? m * (1.0f / 127.0f) : 1.0f;
#pragma unroll
    for (int k = 0; k < V; ++k)
      st(qw + k * W * 32, quant_byte(v[k].x, s) | quant_byte(v[k].y, s) << 8 |
                              quant_byte(v[k].z, s) << 16 |
                              quant_byte(v[k].w, s) << 24);
    if (first) st(scales + t, s);
  }
}

// Tiles from which one warp a tile is used (W = 1): below, a block a tile
// (W = 8) spreads a launch over more warps. On an H100 the two bodies
// cross between 1,024 and 4,096 tiles; from 2^26 elements on the warp
// body is 8-10 % faster (trace_kernels.py, quantize-scaling lines).
constexpr int64_t kWarpTileMin = 4096;

template <int XA, int W>
cudaError_t launch_q(const float* x, int64_t n, int8_t* q, float* s,
                     int64_t tiles, cudaStream_t st) {
  constexpr auto kernel = &quantize_kernel<XA, W>;
  dim3 grid;
  int threads = stream::kMaxThreads;
  if constexpr (W == 1) {
    stream::grid_for(reinterpret_cast<const void*>(kernel), tiles * 32, 1,
                     &grid, &threads);
  } else {                                // a tile a block of 256 threads
    const int64_t cap = int64_t{stream::sm_count()} *
        stream::blocks_per_sm(reinterpret_cast<const void*>(kernel), threads);
    grid = dim3((unsigned)(tiles < cap ? tiles : cap));
  }
  return stream::launch(kernel, grid, threads, st, x, n, q, s, tiles);
}

template <int XA>
cudaError_t pick_q(const float* x, int64_t n, int8_t* q, float* s,
                   int64_t tiles, int warps, cudaStream_t st) {
  if (warps == 0) warps = tiles >= kWarpTileMin ? 1 : 8;
  return warps == 1 ? launch_q<XA, 1>(x, n, q, s, tiles, st)
                    : launch_q<XA, 8>(x, n, q, s, tiles, st);
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

// x: [n] float32, 4-byte aligned -> q: [padded] int8 and scales:
// [padded / 1024] float32 (padded a multiple of 1024, at least n; both
// 4-byte aligned): the codes of x zero-padded to `padded` elements.
// warps: the warps a tile, 1 or 8, or 0 to choose from the tile count.
int repro_quantize(const void* x, int64_t n, void* q, void* scales,
                   int64_t padded, int warps, void* stream) {
  if (n < 0 || padded < n || padded % stream::kTile ||
      (warps != 0 && warps != 1 && warps != 8) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
        reinterpret_cast<uintptr_t>(scales)) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = padded / stream::kTile;
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const float* xf = static_cast<const float*>(x);
  int8_t* c = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (stream::float_align(x)) {
    case 16: err = pick_q<16>(xf, n, c, s, tiles, warps, st); break;
    case 8: err = pick_q<8>(xf, n, c, s, tiles, warps, st); break;
    default: err = pick_q<4>(xf, n, c, s, tiles, warps, st); break;
  }
  return static_cast<int>(err);
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
