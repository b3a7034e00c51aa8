// Shared by the two MultiKRUM Gram kernels, gram_q8 (q8agg.cu) and
// gram_and_norms (multikrum.cu): the row-pair index, the lane butterfly,
// the model cap, and the end of both kernels, which sums the blocks'
// partials behind an integer ticket.
//
// Blocks run unordered, so a Gram matrix over N split across blocks needs a
// reduction across blocks. Both kernels make it in their own launch and in a
// fixed order, never with a float atomicAdd: MultiKRUM scores decide which
// models a silo merges, and the card must give the same scores run after
// run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // one private copy per source file that includes this
namespace gram {

constexpr int kMaxM = 64;

// The pair (i, j >= i) of index p, row by row over the upper triangle.
__device__ __forceinline__ void pair_of(int p, int M, int& i, int& j) {
  i = 0;
  while (p >= M - i) {
    p -= M - i;
    ++i;
  }
  j = i + p;
}

// Index of the pair (i, j >= i) in the row-by-row upper triangle.
__device__ __forceinline__ int pair_index(int i, int j, int M) {
  return i * M - i * (i - 1) / 2 + (j - i);
}

// The sum of v over the L lanes of a pair: a fixed butterfly, every lane
// gets the same total.
template <typename T>
__device__ __forceinline__ T lane_sum(T v, int L) {
  for (int off = L >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Called by every thread of every block once the block has written its
// partial, part[blockIdx.x * P + pair_index(i, j)] for all P = M(M+1)/2
// pairs. After the barrier one thread takes an integer ticket with an
// acquire-release atomic add, which releases the whole block's partial
// (release is cumulative over what the barrier ordered before it) and, in
// the last block, acquires everyone else's; a full fence (__threadfence)
// around it costs about 0.3 us more each. The last block sums every pair
// over the blocks, lane l of a warp taking blocks l, l+32, ... in order (8
// loads in flight at a time) and then a fixed butterfly; it writes G (both
// triangles from one sum) and sq (the same register as G[i, i]) to out =
// [G (M x M), sq (M)], and resets the ticket. So G is exactly symmetric, sq
// exactly its diagonal, and reruns repeat the bits. The scratch and the
// ticket belong to the caller (one stream uses them at a time).
__device__ void finish(const float* __restrict__ part, int M,
                       unsigned* __restrict__ ticket,
                       float* __restrict__ out) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(t) : "l"(ticket) : "memory");
    last = t == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  const int P = M * (M + 1) / 2;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int nb = gridDim.x;
  float* G = out;
  float* sq = out + M * M;
  for (int p = warp; p < P; p += blockDim.x / 32) {
    float v = 0.f;
    for (int b0 = wl; b0 < nb; b0 += 32 * 8) {
      float t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int blk = b0 + 32 * k;
        t[k] = blk < nb ? __ldcg(part + (int64_t)blk * P + p) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (b0 + 32 * k < nb) v += t[k];
    }
    v = lane_sum(v, 32);
    if (wl == 0) {
      int i = 0, j = 0;
      pair_of(p, M, i, j);
      G[i * M + j] = v;
      G[j * M + i] = v;
      if (i == j) sq[i] = v;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace gram
}  // namespace
