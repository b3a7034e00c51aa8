// Shared by the two MultiKRUM Gram kernels, gram_q8 (q8agg.cu) and
// gram_and_norms (multikrum.cu): the row-pair index, the lane butterfly and
// the model cap serve both; the split of the M(M+1)/2 row pairs over a
// block's threads, the shared-memory opt-in and the second pass that sums
// the per-block partials are gram_q8's alone (gram_and_norms sums them in
// its own launch, behind a ticket).
//
// Blocks run unordered, so a Gram matrix over N split across blocks needs a
// reduction across blocks. gram_q8 makes it a second, fixed-order pass over
// [B, M, M] partials, never a float atomicAdd: MultiKRUM scores decide which
// models a silo merges, and the card must give the same scores run after
// run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // one private copy per source file that includes this
namespace gram {

constexpr int kThreads = 256;
constexpr int kMaxM = 64;
constexpr int kMaxPairs = kMaxM * (kMaxM + 1) / 2;               // 2080
constexpr int kMaxSlots = (kMaxPairs + kThreads - 1) / kThreads;  // 9

// Threads per pair: the largest power of two L <= 32 with pairs * L <=
// kThreads. With L > 1 there are at most kThreads slots, so one each; with
// L = 1 a thread owns up to kMaxSlots pairs. A pair's L lanes are adjacent
// threads of one warp.
inline int lanes_for(int pairs) {
  int L = 1;
  while (L < 32 && pairs * L * 2 <= kThreads) L *= 2;
  return L;
}

// The pair (i, j >= i) of index p, row by row over the upper triangle.
__device__ __forceinline__ void pair_of(int p, int M, int& i, int& j) {
  i = 0;
  while (p >= M - i) {
    p -= M - i;
    ++i;
  }
  j = i + p;
}

// The sum of v over the L lanes of a pair: a fixed butterfly, every lane
// gets the same total.
template <typename T>
__device__ __forceinline__ T lane_sum(T v, int L) {
  for (int off = L >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass 2. part: [blocks, M, M], each block's sums mirrored below the
// diagonal. G[i, j] = sum over b in order 0..blocks-1, so G is exactly
// symmetric, and sq[i] = G[i, i] is the same sum.
__global__ void reduce_partials(const float* __restrict__ part, int blocks,
                                int M, float* __restrict__ G,
                                float* __restrict__ sq) {
  const int MM = M * M;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < MM;
       e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < blocks; ++b) acc += part[(int64_t)b * MM + e];
    G[e] = acc;
    const int i = e / M;
    if (e == i * M + i) sq[i] = acc;
  }
}

// Dynamic shared memory above the 48 KB default needs the kernel's consent.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline cudaError_t launch_reduce(const float* part, int blocks, int M,
                                 float* G, float* sq, cudaStream_t s) {
  const int MM = M * M;
  reduce_partials<<<(MM + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, blocks, M, G, sq);
  return cudaGetLastError();
}

}  // namespace gram
}  // namespace
