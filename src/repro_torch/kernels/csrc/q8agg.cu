// Kernels over int8 payloads (the int8 wire format: per-1024-tile scales).
//
// wsum_q8: out[n] = sum_m w[m] * s[m, n / 1024] * q[m, n].
// Replaces the Pallas kernel src/repro/kernels/q8agg.py:51 (wsum_q8, body
// _wsum_kernel :39), the cross-silo merge of int8 peer models. The f32
// [M, N] matrix of dequantized models is never built.
// Bound: memory. It reads M*N int8 codes, M*N/1024 scales and writes N
// floats: M*N + 4*M*N/1024 + 4*N bytes. One block owns one 1024-wide
// quantization tile: it folds ws[m] = w[m] * s[m, tile] into shared memory
// once (the same f32 product the reference forms), then each of 256 threads
// streams 4 codes per model as one char4 and accumulates 4 outputs in
// registers. Offsets are 64-bit: M*N reaches 2^31.
//
// add_q8_delta: out[n] = base[n] + q[n] * s[n / 1024], rounded once.
// Replaces src/repro/kernels/q8agg.py:77 (add_q8_delta, body
// _add_delta_kernel :70), the rebuild of an int8-delta envelope onto its
// base; the f32 delta is never built. The reference's compiled kernel
// evaluates b + q*s as a fused multiply-add, so this one calls fmaf
// explicitly: a separate multiply and add would round twice and differ in
// the last bit for about a quarter of the elements, and the rebuilt model is
// the next round's delta base, so those bits would reach the wire.
// Bound: memory, 4 + 1 + 4 bytes per element plus 4 per tile. Each thread
// takes 4 elements: one char4 of codes, one float4 of base, one float4 store.
//
// gram_q8: G[i, j] = sum_tiles (s_i s_j) * sum_{n in tile} q_i q_j, and
// sq[i] = G[i, i]. Replaces src/repro/kernels/q8agg.py:122 (gram_q8, body
// _gram_kernel :99), MultiKRUM's distances straight off the int8 payloads.
// Per tile the product of two int8 rows is an exact int32 (127^2 * 1024 <
// 2^24, so its float conversion is exact too); it is scaled in f32 as the
// reference does, (s_i * s_j) * float(gq), and summed across tiles in f32.
// Bound: memory, M*N + 4*M*N/1024 bytes for 2*M^2*N integer operations
// (about M^2/2 dp4a per 4 codes, far below the card's int8 rate at M <= 64).
// N splits across blocks by whole tiles; a block stages one tile of all M
// rows in shared memory (16-byte loads), its threads take the M(M+1)/2 row
// pairs (several lanes a pair when M is small) and dot them with __dp4a,
// and a second pass sums the blocks' partials in a fixed order (gram.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = kTile / 4;

__global__ void wsum_q8_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ scales,
                               const float* __restrict__ w,
                               float* __restrict__ out, int M, int64_t N) {
  extern __shared__ float ws[];
  const int64_t tile = blockIdx.x;
  const int64_t tiles = N / kTile;
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    ws[m] = w[m] * scales[(int64_t)m * tiles + tile];
  __syncthreads();
  const int64_t col = tile * kTile + 4 * threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int m = 0; m < M; ++m) {
    const char4 c = *reinterpret_cast<const char4*>(q + (int64_t)m * N + col);
    const float f = ws[m];
    a0 = fmaf(f, (float)c.x, a0);
    a1 = fmaf(f, (float)c.y, a1);
    a2 = fmaf(f, (float)c.z, a2);
    a3 = fmaf(f, (float)c.w, a3);
  }
  *reinterpret_cast<float4*>(out + col) = make_float4(a0, a1, a2, a3);
}

__global__ void add_q8_delta_kernel(const float* __restrict__ base,
                                    const int8_t* __restrict__ q,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const char4 c = *reinterpret_cast<const char4*>(q + 4 * i);
    const float4 b = *reinterpret_cast<const float4*>(base + 4 * i);
    const float s = scales[(4 * i) / kTile];
    *reinterpret_cast<float4*>(out + 4 * i) =
        make_float4(fmaf((float)c.x, s, b.x), fmaf((float)c.y, s, b.y),
                    fmaf((float)c.z, s, b.z), fmaf((float)c.w, s, b.w));
  }
}

constexpr int kWords = kTile / 4;       // int32 words of codes per row tile
constexpr int kRowStride = kWords + 1;  // padded: rows fall on other banks

// Pass 1: block b sums its contiguous run of tiles into part[b] ([M, M]).
__global__ void gram_q8_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ scales,
                               float* __restrict__ part, int M, int64_t N,
                               int pairs, int L) {
  extern __shared__ int rows[];  // [M][kRowStride] codes, then [M] scales
  float* srow = reinterpret_cast<float*>(rows + M * kRowStride);
  const int64_t tiles = N / kTile;
  const int64_t per = (tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  const int slots = pairs * L;
  int pi[gram::kMaxSlots], pj[gram::kMaxSlots];
  float acc[gram::kMaxSlots];
#pragma unroll
  for (int k = 0; k < gram::kMaxSlots; ++k) {
    const int slot = threadIdx.x + k * gram::kThreads;
    pi[k] = pj[k] = 0;
    acc[k] = 0.f;
    if (slot < slots) gram::pair_of(slot / L, M, pi[k], pj[k]);
  }
  constexpr int kVecs = kTile / 16;      // 16-byte loads per row tile
  for (int64_t t = t0; t < t1; ++t) {
    for (int v = threadIdx.x; v < M * kVecs; v += blockDim.x) {
      const int m = v / kVecs, c = v % kVecs;
      const int4 w = *reinterpret_cast<const int4*>(
          q + (int64_t)m * N + t * kTile + 16 * c);
      int* dst = rows + m * kRowStride + 4 * c;
      dst[0] = w.x;
      dst[1] = w.y;
      dst[2] = w.z;
      dst[3] = w.w;
    }
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      srow[m] = scales[(int64_t)m * tiles + t];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < gram::kMaxSlots; ++k) {
      if (k * gram::kThreads < slots) {  // the same for the whole block
        const int slot = threadIdx.x + k * gram::kThreads;
        int g = 0;
        if (slot < slots) {
          const int* a = rows + pi[k] * kRowStride;
          const int* b = rows + pj[k] * kRowStride;
          for (int w = slot % L; w < kWords; w += L) g = __dp4a(a[w], b[w], g);
        }
        if (L > 1) g = gram::lane_sum(g, L);  // exact: int32
        if (slot < slots) acc[k] += (srow[pi[k]] * srow[pj[k]]) * (float)g;
      }
    }
    __syncthreads();
  }
  float* out = part + (int64_t)blockIdx.x * M * M;
#pragma unroll
  for (int k = 0; k < gram::kMaxSlots; ++k) {
    const int slot = threadIdx.x + k * gram::kThreads;
    if (slot < slots && slot % L == 0) {
      out[pi[k] * M + pj[k]] = acc[k];
      out[pj[k] * M + pi[k]] = acc[k];
    }
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // grid-stride beyond 32 blocks per SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" {

// q: [M, N] int8 (N % 1024 == 0); scales: [M, N / 1024] float32;
// w: [M] float32 -> out: [N] float32.
int repro_wsum_q8(const void* q, const void* scales, const void* w,
                  void* out, int M, int64_t N, void* stream) {
  const int64_t tiles = N / kTile;
  if (tiles > 0) {
    wsum_q8_kernel<<<(unsigned)tiles, kThreads, (size_t)M * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<const float*>(w), static_cast<float*>(out), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// base: [n] float32, q: [n] int8, scales: [n / 1024] float32, n % 1024 == 0
// -> out: [n] float32.
int repro_add_q8_delta(const void* base, const void* q, const void* scales,
                       void* out, int64_t n, void* stream) {
  add_q8_delta_kernel<<<grid_for(n / 4), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// q: [M, N] int8 (N % 1024 == 0, 1 <= M <= 64); scales: [M, N / 1024];
// part: [blocks, M, M] float32 scratch -> G: [M, M], sq: [M] float32.
int repro_gram_q8(const void* q, const void* scales, void* part, void* G,
                  void* sq, int M, int64_t N, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = M * (M + 1) / 2;
  const size_t smem = (size_t)M * kRowStride * sizeof(int) + M * sizeof(float);
  cudaError_t err = gram::allow_smem(gram_q8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_q8_kernel<<<blocks, gram::kThreads, smem, s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(part), M, N, pairs, gram::lanes_for(pairs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram::launch_reduce(
      static_cast<const float*>(part), blocks, M, static_cast<float*>(G),
      static_cast<float*>(sq), s));
}

}  // extern "C"
