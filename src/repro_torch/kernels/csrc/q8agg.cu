// Kernels over int8 payloads (the int8 wire format: per-1024-tile scales).
//
// wsum_q8: out[n] = sum_m w[m] * s[m, n / 1024] * q[m, n].
// Replaces the Pallas kernel src/repro/kernels/q8agg.py:51 (wsum_q8, body
// _wsum_kernel :39), the cross-silo merge of int8 peer models. The f32
// [M, N] matrix of dequantized models is never built.
// Bound: memory. For the n columns it writes it reads M*n int8 codes (in
// whole 1024-tiles: the ceil(n / 1024) tiles those columns lie in), M
// scales a tile, and writes n floats. It takes the caller's [M, Np]
// payloads as they are (a stack or a view of one, with a row stride, at
// any byte alignment) and writes [n], n <= Np, with no padding or slice
// around it. A warp takes a chunk of 512 columns, which lies in one tile:
// each lane loads 4 words of 4 codes a model (spaced 128 apart, every
// warp-wide load one contiguous 128 bytes), all of a group's code loads
// in flight before its first FMA (one template each for M = 1..3; above 3
// groups of 3 models in turn, carrying the same accumulators: at N = 2^28
// groups of 3 ran faster than of 4 or 8 at every M from 4 to 17, with
// fewer registers, more warps an SM and fewer rows a warp reads at
// once), folds
// w[m] * s[m, tile] in registers (the same float32 product, rounded once,
// that the reference forms), and writes its 16 outputs as four float4
// streaming stores, only the last chunk masked. No shared memory and no
// barrier; the grid is sized from the SM count and occupancy (stream.cuh).
// Each output is acc = fmaf(w_m s_m, q_m, acc) for m = 0..M-1 from 0: the
// reference's kernel (its dot over m, compiled) gives these bits.
// Offsets are 64-bit: M*N reaches 2^31.
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

constexpr int kTile = stream::kTile;
constexpr int kGroup = 3;   // wsum_q8: models whose codes a warp holds at once

// q [M, >= n] codes (row stride ldq, rows of whole 1024-tiles, QA-byte
// aligned: 4 or 1), scales [M, >= ceil(n / 1024)] (row stride lds), w [M]
// -> out [n], 16-byte aligned. Warp w takes chunks w, w + warps, ... of
// 512 columns. G models at a time: G = M (kGroups false, M <= kGroup) or
// groups of kGroup (kGroups, M > kGroup), each group's loads before its
// FMAs.
template <int G, bool kGroups, int QA>
__global__ void __launch_bounds__(stream::kMaxThreads)
wsum_q8_kernel(const int8_t* __restrict__ q, int64_t ldq,
               const float* __restrict__ scales, int64_t lds,
               const float* __restrict__ w, int M,
               float* __restrict__ out, int64_t n) {
  using namespace stream;
  constexpr int S = kWide;
  constexpr int kChunk = S * kSpan;
  const int models = kGroups ? M : G;
  const int lane = threadIdx.x % 32;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t warps = (int64_t)gridDim.x * blockDim.x / 32;
  for (int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       c < chunks; c += warps) {
    const int64_t c0 = c * kChunk;
    const int64_t tile = c0 / kTile;
    float acc[S][kVec];
#pragma unroll
    for (int k = 0; k < S; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[k][j] = 0.f;
    for (int m0 = 0; m0 < models; m0 += G) {
      unsigned cw[G][S];
      float f[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (kGroups && m0 + i >= models) continue;   // the same for the warp
        const int64_t m = m0 + i;
        const int8_t* qm = q + m * ldq + c0 + kVec * lane;
#pragma unroll
        for (int k = 0; k < S; ++k) cw[i][k] = load_codes<QA>(qm + k * kSpan);
        f[i] = ld(w + m) * ld(scales + m * lds + tile);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (kGroups && m0 + i >= models) continue;
#pragma unroll
        for (int k = 0; k < S; ++k)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            acc[k][j] = fmaf(f[i], code(cw[i][k], j), acc[k][j]);
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int64_t e = c0 + k * kSpan + kVec * lane;
      if (e + kVec <= n) {
        st(reinterpret_cast<float4*>(out + e),
           make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (e + j < n) out[e + j] = acc[k][j];
      }
    }
  }
}

template <int G, bool kGroups, int QA>
cudaError_t launch_wsum(const int8_t* q, int64_t ldq, const float* s,
                        int64_t lds, const float* w, int M, float* out,
                        int64_t n, cudaStream_t st) {
  constexpr auto kernel = &wsum_q8_kernel<G, kGroups, QA>;
  constexpr int kChunk = stream::kWide * stream::kSpan;
  dim3 grid;
  int threads;
  stream::grid_for(reinterpret_cast<const void*>(kernel),
                   (n + kChunk - 1) / kChunk * 32, 1, &grid, &threads);
  return stream::launch(kernel, grid, threads, st, q, ldq, s, lds, w, M, out,
                        n);
}

template <int QA>
cudaError_t dispatch_wsum(const int8_t* q, int64_t ldq, const float* s,
                          int64_t lds, const float* w, int M, float* out,
                          int64_t n, cudaStream_t st) {
  static_assert(kGroup == 3, "one template a model count up to kGroup");
  switch (M) {
    case 1: return launch_wsum<1, false, QA>(q, ldq, s, lds, w, M, out, n, st);
    case 2: return launch_wsum<2, false, QA>(q, ldq, s, lds, w, M, out, n, st);
    case 3: return launch_wsum<3, false, QA>(q, ldq, s, lds, w, M, out, n, st);
    default:
      return launch_wsum<kGroup, true, QA>(q, ldq, s, lds, w, M, out, n,
                                           st);
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
        b[k] = stream::ld4<BA>(base + e);
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
  switch (stream::float_align(base)) {
    case 16: return dispatch_add_delta_q<S, 16>(base, q, s, out, n, st);
    case 8: return dispatch_add_delta_q<S, 8>(base, q, s, out, n, st);
    default: return dispatch_add_delta_q<S, 4>(base, q, s, out, n, st);
  }
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

// q: [M, >= n] int8, row stride ldq (rows of whole 1024-tiles: the codes
// up to column ceil(n / 1024) * 1024 are read); scales: [M, >= ceil(n /
// 1024)] float32, row stride lds; w: [M] float32 -> out: [n] float32,
// 16-byte aligned.
int repro_wsum_q8(const void* q, int64_t ldq, const void* scales,
                  int64_t lds, const void* w, int M, void* out, int64_t n,
                  void* stream) {
  if (M < 1 || n < 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* c = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(scales);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      stream::code_align(q, M > 1 ? ldq : 0) == 4
          ? dispatch_wsum<4>(c, ldq, s, lds, wf, M, o, n, st)
          : dispatch_wsum<1>(c, ldq, s, lds, wf, M, o, n, st);
  return static_cast<int>(err);
}

// repro_wsum_q8's arguments in order, each as an int64 (pointers
// included): one pointer to pass instead of nine typed values.
int repro_wsum_q8_packed(const int64_t* a) {
  return repro_wsum_q8(
      reinterpret_cast<const void*>(a[0]), a[1],
      reinterpret_cast<const void*>(a[2]), a[3],
      reinterpret_cast<const void*>(a[4]), (int)a[5],
      reinterpret_cast<void*>(a[6]), a[7], reinterpret_cast<void*>(a[8]));
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
