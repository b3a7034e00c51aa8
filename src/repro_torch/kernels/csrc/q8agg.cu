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
// Bound: memory, 4 + 1 + 4 bytes per element plus 4 per tile. It takes the
// caller's operands unpadded: a base of n floats at any 4-byte alignment (a
// row of a dequantized [K, n] stack, a view at an offset), codes and scales
// in whole 1024-tiles, and writes n outputs. A thread takes vectors of 4
// (a 4-byte code load, one 16-byte or two 8-byte or four 4-byte base loads
// by the base's alignment, a float4 streaming store), spaced so that every
// warp-wide access is one contiguous span: four of them, all loaded before
// their FMAs, from 2^20 elements on, one below (the paper CNN's 62,006 then
// spread over every SM); the grid is sized from the SM count and occupancy
// (stream.cuh).
//
// gram_q8: G[i, j] = sum_tiles (s_i s_j) * sum_{n in tile} q_i q_j, and
// sq[i] = G[i, i]. Replaces src/repro/kernels/q8agg.py:122 (gram_q8, body
// _gram_kernel :99), MultiKRUM's distances straight off the int8 payloads.
// Per tile the product of two int8 rows is an exact int32 (127^2 * 1024 <
// 2^24, so its float conversion is exact too); it is scaled in f32 as the
// reference does, (s_i * s_j) * float(gq), and summed across tiles in f32.
// Bound: memory, M*N + 4*M*N/1024 bytes for 2*M^2*N integer operations
// (about M^2/2 dp4a per 4 codes, far below the card's int8 rate at M <= 64).
// One launch: each warp takes a contiguous run of tiles and holds a tile's
// codes of all rows of a group in registers (every code loaded once up to M
// = 8), the blocks' warps sum in order into a partial a block, and the last
// block to take the ticket sums the partials in a fixed order (gram.cuh).
// No shared-memory staging and no ring: a warp's whole tile is in flight at
// once (8 KB at M = 8), and the SMs hold enough warps to cover the memory
// latency. Any whole number of 1024-tiles and a row stride (the payload's
// own width), so ops hands the payloads over unpadded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"
#include "stream.cuh"

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

// Four base floats at p, from an address aligned to BA bytes (16, 8, 4).
template <int BA>
__device__ __forceinline__ float4 load_base4(const float* p) {
  if constexpr (BA == 16) {
    return stream::ld(reinterpret_cast<const float4*>(p));
  } else if constexpr (BA == 8) {
    const float2 a = stream::ld(reinterpret_cast<const float2*>(p));
    const float2 b = stream::ld(reinterpret_cast<const float2*>(p) + 1);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(stream::ld(p), stream::ld(p + 1), stream::ld(p + 2),
                       stream::ld(p + 3));
  }
}

// base [>= n] float32 at a BA-byte alignment (16, 8 or 4), codes [>= n]
// at a QA-byte one (4 or 1; whole 1024-tiles, so a chunk's codes are always
// there), scales [>= ceil(n / 1024)] -> out [n], 16-byte aligned. Warp w
// takes chunks w, w + warps, ... of S x 128 elements: all their loads, then
// their FMAs and stores. Only the last chunk masks base loads and stores.
template <int S, int BA, int QA>
__global__ void __launch_bounds__(stream::kMaxThreads)
add_q8_delta_kernel(const float* __restrict__ base,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int64_t n) {
  using stream::kSpan;
  using stream::kVec;
  constexpr int kChunk = S * kSpan;
  const int lane = threadIdx.x % 32;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t warps = (int64_t)gridDim.x * blockDim.x / 32;
  for (int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       c < chunks; c += warps) {
    unsigned w[S];
    float4 b[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int64_t e = c * kChunk + k * kSpan + kVec * lane;
      w[k] = stream::load_codes<QA>(q + e);
      if (e + kVec <= n) {
        b[k] = load_base4<BA>(base + e);
      } else {
        b[k] = make_float4(e < n ? stream::ld(base + e) : 0.f,
                           e + 1 < n ? stream::ld(base + e + 1) : 0.f,
                           e + 2 < n ? stream::ld(base + e + 2) : 0.f, 0.f);
      }
    }
    const float s = stream::ld(scales + c * kChunk / stream::kTile);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int64_t e = c * kChunk + k * kSpan + kVec * lane;
      const float v[kVec] = {fmaf(stream::code(w[k], 0), s, b[k].x),
                             fmaf(stream::code(w[k], 1), s, b[k].y),
                             fmaf(stream::code(w[k], 2), s, b[k].z),
                             fmaf(stream::code(w[k], 3), s, b[k].w)};
      if (e + kVec <= n) {
        stream::st(reinterpret_cast<float4*>(out + e),
                   make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (e + j < n) out[e + j] = v[j];
      }
    }
  }
}

template <int S, int BA, int QA>
cudaError_t launch_add_delta(const float* base, const int8_t* q,
                             const float* s, float* out, int64_t n,
                             cudaStream_t st) {
  constexpr auto kernel = &add_q8_delta_kernel<S, BA, QA>;
  constexpr int kChunk = S * stream::kSpan;
  dim3 grid;
  int threads;
  stream::grid_for(reinterpret_cast<const void*>(kernel),
                   (n + kChunk - 1) / kChunk * 32, 1, &grid, &threads);
  return stream::launch(kernel, grid, threads, st, base, q, s, out, n);
}

template <int S, int BA>
cudaError_t dispatch_add_delta_q(const float* base, const int8_t* q,
                                 const float* s, float* out, int64_t n,
                                 cudaStream_t st) {
  if (stream::code_align(q, 0) == 4)
    return launch_add_delta<S, BA, 4>(base, q, s, out, n, st);
  return launch_add_delta<S, BA, 1>(base, q, s, out, n, st);
}

template <int S>
cudaError_t dispatch_add_delta_b(const float* base, const int8_t* q,
                                 const float* s, float* out, int64_t n,
                                 cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0)
    return dispatch_add_delta_q<S, 16>(base, q, s, out, n, st);
  if (a % 8 == 0) return dispatch_add_delta_q<S, 8>(base, q, s, out, n, st);
  return dispatch_add_delta_q<S, 4>(base, q, s, out, n, st);
}

cudaError_t dispatch_add_delta(const float* base, const int8_t* q,
                               const float* s, float* out, int64_t n,
                               cudaStream_t st) {
  if (n >= stream::kAddWideMin)
    return dispatch_add_delta_b<stream::kWide>(base, q, s, out, n, st);
  return dispatch_add_delta_b<1>(base, q, s, out, n, st);
}

// gram_q8: one warp sums one 1024-tile at a time. Lane l holds the tile's
// codes 16 l .. 16 l + 15 and 512 + 16 l .. + 15 (two 16-byte loads a row,
// each warp-wide load one contiguous 512 bytes), loaded once for all R rows
// of a row group; the R(R+1)/2 pair products (R*R off the diagonal) are
// __dp4a sums in int32, summed over the warp with __reduce_add_sync
// (integer addition: exact in any order), then scaled once, (s_i s_j) *
// float(g), and added to f32 accumulators in tile order. Up to M = 8 there
// is one group pair, so every code is loaded once; beyond, groups of 4 rows
// are taken pair by pair and the codes are read once a group pair.
constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;

template <int R>
__global__ void __launch_bounds__(kGramThreads)
gram_q8_kernel(const int8_t* __restrict__ q, int64_t ld,
               const float* __restrict__ scales, int64_t sld, int M,
               int64_t tiles, float* __restrict__ part,
               unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float red[kGramWarps][R * R];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t gw = (int64_t)blockIdx.x * kGramWarps + warp;
  const int64_t nw = (int64_t)gridDim.x * kGramWarps;
  const int64_t t0 = tiles * gw / nw, t1 = tiles * (gw + 1) / nw;
  const int NG = (M + R - 1) / R, NGP = NG * (NG + 1) / 2;
  const int P = M * (M + 1) / 2;

  for (int gp = 0; gp < NGP; ++gp) {
    int gi = 0, gj = 0;
    gram::pair_of(gp, NG, gi, gj);
    const bool diag = R == 8 || gi == gj;  // R = 8: M <= 8, one group
    float acc[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

    for (int64_t t = t0; t < t1; ++t) {
      const int64_t col = t * kTile + 16 * lane;
      int4 a[R][2], b[R][2];
      float sa[R], sb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ra = gi * R + r, rb = gj * R + r;
        a[r][0] = a[r][1] = b[r][0] = b[r][1] = make_int4(0, 0, 0, 0);
        sa[r] = sb[r] = 0.f;
        if (ra < M) {
          const int8_t* p = q + ra * ld + col;
          a[r][0] = __ldcs(reinterpret_cast<const int4*>(p));
          a[r][1] = __ldcs(reinterpret_cast<const int4*>(p + 512));
          sa[r] = scales[ra * sld + t];
        }
        if (!diag && rb < M) {
          const int8_t* p = q + rb * ld + col;
          b[r][0] = __ldcs(reinterpret_cast<const int4*>(p));
          b[r][1] = __ldcs(reinterpret_cast<const int4*>(p + 512));
          sb[r] = scales[rb * sld + t];
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if ((diag && j < i) || gi * R + i >= M || gj * R + j >= M)
            continue;  // the same for the whole warp
          int g = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int4 x = a[i][h];
            const int4 z = diag ? a[j][h] : b[j][h];
            g = __dp4a(x.x, z.x, g);
            g = __dp4a(x.y, z.y, g);
            g = __dp4a(x.z, z.z, g);
            g = __dp4a(x.w, z.w, g);
          }
          g = __reduce_add_sync(0xffffffffu, g);
          acc[i][j] += (sa[i] * (diag ? sa[j] : sb[j])) * (float)g;
        }
      }
    }
    // the block's warps in order -> this block's partial of the group pair
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) red[warp][i * R + j] = acc[i][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * R; e += kGramThreads) {
      const int i = e / R, j = e % R, ri = gi * R + i, rj = gj * R + j;
      if (ri >= M || rj >= M || (diag && j < i)) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kGramWarps; ++w) v += red[w][e];
      part[(int64_t)blockIdx.x * P + gram::pair_index(ri, rj, M)] = v;
    }
    __syncthreads();  // red is free for the next group pair
  }
  gram::finish(part, M, ticket, out);
}

template <int R>
cudaError_t launch_gram(const int8_t* q, int64_t ld, const float* s,
                        int64_t sld, int M, int64_t tiles, float* part,
                        int64_t part_floats, unsigned* ticket, float* out,
                        cudaStream_t st) {
  auto kernel = gram_q8_kernel<R>;
  // one warp a tile while that fills the card, else a persistent grid
  int64_t blocks = (tiles + kGramWarps - 1) / kGramWarps;
  const int64_t cap = (int64_t)stream::sm_count() *
                      stream::blocks_per_sm((const void*)kernel, kGramThreads);
  if (blocks > cap) blocks = cap;
  const int64_t fit = part_floats / (M * (M + 1) / 2);
  if (blocks > fit) blocks = fit;
  if (blocks < 1) return cudaErrorInvalidValue;
  return stream::launch(kernel, dim3((unsigned)blocks), kGramThreads, st, q,
                        ld, s, sld, M, tiles, part, ticket, out);
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

// base: [>= n] float32 (4-byte aligned), q: [>= n] int8 in whole 1024-tiles,
// scales: [>= ceil(n / 1024)] float32 -> out: [n] float32, 16-byte aligned.
int repro_add_q8_delta(const void* base, const void* q, const void* scales,
                       void* out, int64_t n, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(base) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(base);
  const int8_t* c = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch_add_delta(b, c, s, o, n, st);
  return static_cast<int>(err);
}

// q: [M, N] int8 with row stride ld (N, ld and the base in whole 1024-tiles
// and 16-byte aligned, 1 <= M <= 64); scales: [M, N / 1024] float32, row
// stride sld; part: scratch of part_floats float32 (at least M(M+1)/2; the
// grid shrinks to fit); ticket: one uint32, 0 between launches; out: M*M + M
// float32 -> G [M, M] then sq [M].
int repro_gram_q8(const void* q, int64_t ld, const void* scales, int64_t sld,
                  int M, int64_t N, void* part, int64_t part_floats,
                  void* ticket, void* out, void* stream) {
  if (M < 1 || M > gram::kMaxM || N < kTile || N % kTile || ld % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* c = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scales);
  float* pf = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = N / kTile;
  cudaError_t err;
  if (M <= 1)
    err = launch_gram<1>(c, ld, s, sld, M, tiles, pf, part_floats, tk, o, st);
  else if (M <= 2)
    err = launch_gram<2>(c, ld, s, sld, M, tiles, pf, part_floats, tk, o, st);
  else if (M <= 4 || M > 8)
    err = launch_gram<4>(c, ld, s, sld, M, tiles, pf, part_floats, tk, o, st);
  else
    err = launch_gram<8>(c, ld, s, sld, M, tiles, pf, part_floats, tk, o, st);
  return static_cast<int>(err);
}

}  // extern "C"
