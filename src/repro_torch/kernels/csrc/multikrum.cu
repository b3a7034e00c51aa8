// MultiKRUM's Gram matrix and row norms: G = X X^T, sq[i] = G[i, i], f32.
//
// Replaces the Pallas kernel src/repro/kernels/multikrum.py:40
// (gram_and_norms, body _kernel :24), which streams N through a sequential
// grid and carries G in its output block. ops.pairwise_dists then forms
// max(sq + sq^T - 2 G, 0).
//
// Bound: memory. It reads M*N floats once, 4*M*N bytes, for 2*M^2*N flops
// (M <= 64): the card's f32 rate outruns its memory rate up to about 20
// flops a byte, i.e. about M = 40, so small M is far from the compute bound.
// N splits across blocks by whole 2048-wide tiles (the padding contract).
// A block stages an [M, 256] slab of its run in shared memory (16-byte
// loads, rows padded by one word onto other banks), its threads take the
// M(M+1)/2 row pairs (several lanes a pair when M is small) and keep each
// pair's sum in a register across the run, in one fixed order; the lanes
// of a pair combine once at the end. sq[i] is G[i, i], the same sum in the
// same order. A second pass sums the blocks' partials in a fixed order
// (gram.cuh). Offsets are 64-bit: M*N reaches 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"

namespace {

constexpr int kTileN = 2048;            // N % kTileN == 0
constexpr int kChunk = 256;             // columns a block stages per step
constexpr int kRowStride = kChunk + 1;  // padded: rows fall on other banks

__global__ void gram_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ part, int M, int64_t N,
                                int pairs, int L) {
  extern __shared__ float slab[];  // [M][kRowStride]
  const int64_t tiles = N / kTileN;
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
  constexpr int kVecs = kChunk / 4;     // float4 loads per row of the slab
  for (int64_t c = t0 * kTileN; c < t1 * kTileN; c += kChunk) {
    for (int v = threadIdx.x; v < M * kVecs; v += blockDim.x) {
      const int m = v / kVecs, u = v % kVecs;
      const float4 f =
          *reinterpret_cast<const float4*>(x + (int64_t)m * N + c + 4 * u);
      float* dst = slab + m * kRowStride + 4 * u;
      dst[0] = f.x;
      dst[1] = f.y;
      dst[2] = f.z;
      dst[3] = f.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < gram::kMaxSlots; ++k) {
      const int slot = threadIdx.x + k * gram::kThreads;
      if (slot < slots) {
        const float* a = slab + pi[k] * kRowStride;
        const float* b = slab + pj[k] * kRowStride;
        float s = acc[k];
        for (int w = slot % L; w < kChunk; w += L) s = fmaf(a[w], b[w], s);
        acc[k] = s;
      }
    }
    __syncthreads();
  }
  float* out = part + (int64_t)blockIdx.x * M * M;
#pragma unroll
  for (int k = 0; k < gram::kMaxSlots; ++k) {
    if (k * gram::kThreads < slots) {  // the same for the whole block
      const int slot = threadIdx.x + k * gram::kThreads;
      const float v = L > 1 ? gram::lane_sum(acc[k], L) : acc[k];
      if (slot < slots && slot % L == 0) {
        out[pi[k] * M + pj[k]] = v;
        out[pj[k] * M + pi[k]] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// x: [M, N] float32 (N % 2048 == 0, 1 <= M <= 64); part: [blocks, M, M]
// float32 scratch -> G: [M, M], sq: [M] float32.
int repro_gram_and_norms(const void* x, void* part, void* G, void* sq, int M,
                         int64_t N, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = M * (M + 1) / 2;
  const size_t smem = (size_t)M * kRowStride * sizeof(float);
  cudaError_t err = gram::allow_smem(gram_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_f32_kernel<<<blocks, gram::kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<float*>(part), M, N, pairs,
      gram::lanes_for(pairs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram::launch_reduce(
      static_cast<const float*>(part), blocks, M, static_cast<float*>(G),
      static_cast<float*>(sq), s));
}

}  // extern "C"
