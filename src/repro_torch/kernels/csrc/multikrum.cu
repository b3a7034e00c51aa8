// MultiKRUM's Gram matrix and row norms: G = X X^T, sq[i] = G[i, i], f32.
//
// Replaces the Pallas kernel src/repro/kernels/multikrum.py:40
// (gram_and_norms, body _kernel :24), which streams N through a sequential
// grid and carries G in its output block. ops.pairwise_dists then forms
// max(sq + sq^T - 2 G, 0).
//
// Bound: memory. It reads M*N floats once, 4*M*N bytes, for 2*M^2*N flops
// (M <= 64). The CUDA cores' float32 rate outruns the memory rate up to
// about 20 flops a byte, so below M = 40 the function is far from the
// compute bound: at M = 8 it needs 2*36 flops per 32 bytes. No tensor
// cores: TF32 keeps about 10 mantissa bits, and the float32 tolerance
// (sqrt(N) ulps of |x_i||x_j|) would not hold.
//
// One launch, in four parts:
//
// - Columns. The operand is [M, N] with row stride ld >= N, any N >= 1.
//   N splits into units of C columns (512 up to M = 8, 256 to M = 32, 128
//   beyond), and each block takes a contiguous run of units: one unit a
//   block while that still fills the card (the paper CNN's N = 62,006 at
//   M = 3 gives 122 blocks), else a persistent grid of 1, 2 or 4 blocks an
//   SM by M.
// - The ring. A block keeps kStages [M, C] slabs in shared memory, filled by
//   cp.async with commit groups: while it sums unit t, units t+1..t+3 are in
//   flight. Each copy is the widest that the base pointer and ld allow, 16
//   bytes (cp.async.cg), else 8 or 4 (cp.async.ca); the paper CNN's rows of
//   62,006 floats are only 8-byte aligned. Columns past N are zero-filled by
//   the copy itself. Rows land unpadded: thread t reads column t, so the
//   reads are free of bank conflicts. No TMA: a bulk copy needs 16-byte
//   rows, which the main path's operand lacks, and the per-thread copies
//   already keep three units in flight a block, 72-96 KB an SM at M 3-8.
//   A unit of 512 columns halves the barriers a byte against 256; deeper
//   rings did not help (the ring is not what bounds it at N = 2^28).
// - Register tiling. Rows go in groups of R (1, 2, 4 or 8; M <= 8 is one
//   group); a thread owns one group pair and a set of columns, loads its
//   column's 2R values once (R on the diagonal) and accumulates the pair
//   products in R*R independent registers, in column order. Up to M = 8 that
//   is M loads and M(M+1)/2 FMAs a column, about 2/8 shared reads an FMA.
//   Beyond, group pairs share the block's threads (L lanes each).
// - The ticket. A block sums its lanes by a fixed butterfly and its chunks
//   in order through shared memory and writes its upper-triangle partial to
//   scratch; gram::finish (gram.cuh, shared with gram_q8) takes an integer
//   ticket, and the last block sums the partials in a fixed order and writes
//   G and sq. No float atomics: G is exactly symmetric, sq exactly its
//   diagonal, and reruns repeat the bits, so MultiKRUM picks cannot
//   flicker. The scratch and the ticket belong to the caller (one stream
//   uses them at a time); offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kSMs = 132;  // H100 SXM; elsewhere the grid only fits less well

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES to shared memory, reading src_bytes of them (the rest: zeros).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// R rows a group, VW floats a copy. L lanes share a group pair (a power of
// two, NGP * L <= kThreads); C = 2^csh columns a unit; units of C over N.
template <int R, int VW>
__global__ void __launch_bounds__(kThreads)
    gram_and_norms_kernel(const float* __restrict__ x, int64_t ld, int64_t N,
                          int M, int csh, int L, int64_t units,
                          float* __restrict__ part,
                          unsigned* __restrict__ ticket,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];  // kStages x [M][C]
  const int tid = threadIdx.x;
  const int NG = (M + R - 1) / R;
  const int NGP = NG * (NG + 1) / 2;
  const int64_t u0 = units * blockIdx.x / gridDim.x;
  const int64_t nu = units * (blockIdx.x + 1) / gridDim.x - u0;

  const int gp = tid / L, lane = tid % L;
  const bool active = gp < NGP;
  int gi = 0, gj = 0;
  if (active) gram::pair_of(gp, NG, gi, gj);
  const bool diag = gi == gj;

  const int C = 1 << csh;
  const int slab = M * C;
  const int vsh = csh - (VW == 4 ? 2 : VW / 2);  // log2 of the copies a row
  auto issue = [&](int64_t u, int stage) {
    float* dst = smem + stage * slab;
    const int64_t c0 = u << csh;
    const bool full = c0 + C <= N;  // all units but the last
    for (int v = tid; v < M << vsh; v += kThreads) {
      const int m = v >> vsh, cv = (v & ((1 << vsh) - 1)) * VW;
      const float* row = x + m * ld;
      if (full) {
        cp_async<VW * 4>(dst + m * C + cv, row + c0 + cv, VW * 4);
      } else {
        const int64_t left = N - (c0 + cv);
        const int bytes = left >= VW ? VW * 4 : (left > 0 ? (int)left * 4 : 0);
        cp_async<VW * 4>(dst + m * C + cv, bytes ? row + c0 + cv : row, bytes);
      }
    }
  };

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  // one commit group a unit, empty past the run, so the count stays fixed
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nu) issue(u0 + s, s);
    cp_async_commit();
  }
  for (int64_t t = 0; t < nu; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of unit t landed
    __syncthreads();               // everyone's; and unit t-1 is summed
    const int64_t nx = t + kStages - 1;
    if (nx < nu) issue(u0 + nx, (int)(nx % kStages));  // into t-1's slab
    cp_async_commit();
    if (active) {
      const float* s = smem + (t % kStages) * slab;
      for (int c = lane; c < C; c += L) {
        float a[R], b[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int ra = gi * R + r;
          a[r] = ra < M ? s[ra * C + c] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int rb = gj * R + r;
          b[r] = diag ? a[r] : (rb < M ? s[rb * C + c] : 0.f);
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (!diag || j >= i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the block reduction now

  // lanes of a chunk (W adjacent threads of one warp) by a fixed butterfly,
  // all entries a step at once; with one group pair (M <= 8) only its
  // M(M+1)/2 live entries
  const int W = L < 32 ? L : 32;
  const int wsh = __ffs(W) - 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off >= W) continue;  // the same for the block
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (NGP > 1 || (j >= i && j < M))
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
  }
  float* red = smem;  // [kThreads / W][R * R]
  if ((tid & (W - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (NGP > 1 || (j >= i && j < M))
          red[(tid >> wsh) * R * R + i * R + j] = acc[i][j];
  }
  __syncthreads();
  // a group pair's chunks in order -> this block's partial, upper triangle
  const int P = M * (M + 1) / 2;
  const int chunks = L >> wsh;
  for (int e = tid; e < NGP * R * R; e += kThreads) {
    const int g = e / (R * R), i = (e / R) % R, j = e % R;
    int a = 0, b = 0;
    gram::pair_of(g, NG, a, b);
    const int ri = a * R + i, rj = b * R + j;
    if (ri >= M || rj >= M || (a == b && j < i)) continue;
    const float* src = red + g * chunks * R * R + i * R + j;
    float v = 0.f;
#pragma unroll 8
    for (int q = 0; q < chunks; ++q) v += src[q * R * R];
    part[(int64_t)blockIdx.x * P + gram::pair_index(ri, rj, M)] = v;
  }
  gram::finish(part, M, ticket, out);
}

template <int R, int VW>
cudaError_t launch(const float* x, int64_t ld, int M, int64_t N, float* part,
                   int64_t part_floats, unsigned* ticket, float* out,
                   cudaStream_t s) {
  const int NG = (M + R - 1) / R;
  const int NGP = NG * (NG + 1) / 2;
  int L = kThreads;
  while (NGP * L > kThreads) L >>= 1;
  const int csh = M <= 8 ? 9 : (M <= 32 ? 8 : 7);  // C: 512, 256, 128
  const int C = 1 << csh;
  const int64_t units = (N + C - 1) / C;
  const int per_sm = M <= 4 ? 4 : (M <= 16 ? 2 : 1);
  const int64_t cap = (int64_t)kSMs * per_sm;
  const int blocks = (int)(units < cap ? units : cap);
  if ((int64_t)blocks * (M * (M + 1) / 2) > part_floats)
    return cudaErrorInvalidValue;
  const int W = L < 32 ? L : 32;
  size_t smem = (size_t)kStages * M * C * sizeof(float);
  const size_t red = (size_t)(kThreads / W) * R * R * sizeof(float);
  if (red > smem) smem = red;
  auto kernel = gram_and_norms_kernel<R, VW>;
  // the opt-in counts the static shared bytes too: ask a little early, once
  // a device and size
  static size_t opted[64] = {};
  int dev = 0;
  if (smem + 1024 > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess &&
      (dev >= 64 || opted[dev] < smem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = smem;
  }
  kernel<<<blocks, kThreads, smem, s>>>(x, ld, N, M, csh, L, units, part,
                                        ticket, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t dispatch(const float* x, int64_t ld, int M, int64_t N, float* part,
                     int64_t part_floats, unsigned* ticket, float* out,
                     cudaStream_t s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      (M > 1 ? (uintptr_t)(ld * sizeof(float)) : 0);
  if (a % 16 == 0)
    return launch<R, 4>(x, ld, M, N, part, part_floats, ticket, out, s);
  if (a % 8 == 0)
    return launch<R, 2>(x, ld, M, N, part, part_floats, ticket, out, s);
  return launch<R, 1>(x, ld, M, N, part, part_floats, ticket, out, s);
}

}  // namespace

extern "C" {

// x: [M, N] float32, row stride ld >= N, 4-byte aligned, 1 <= M <= 64;
// part: scratch of part_floats float32 (at least blocks * M(M+1)/2; 1024
// blocks always do); ticket: one uint32, 0 between launches; out: M*M + M
// float32 -> G [M, M] then sq [M].
int repro_gram_and_norms(const void* x, int64_t ld, int M, int64_t N,
                         void* part, int64_t part_floats, void* ticket,
                         void* out, void* stream) {
  if (M < 1 || M > gram::kMaxM || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 1)
    err = dispatch<1>(xf, ld, M, N, pf, part_floats, tk, of, s);
  else if (M <= 2)
    err = dispatch<2>(xf, ld, M, N, pf, part_floats, tk, of, s);
  else if (M <= 4)
    err = dispatch<4>(xf, ld, M, N, pf, part_floats, tk, of, s);
  else
    err = dispatch<8>(xf, ld, M, N, pf, part_floats, tk, of, s);
  return static_cast<int>(err);
}

}  // extern "C"
