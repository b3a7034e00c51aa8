// Backward of the WKV6 recurrence of RWKV-6 (the forward is wkv6.cu):
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S: [hs key, hs value])
//   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
//
// Replaces no Pallas kernel: the reference differentiates its jnp forms
// (wkv_chunked on the TPU, src/repro/models/rwkv6.py:80-143) and its Pallas
// wkv6 has no VJP. Added so that RWKV-6 trains on the card; the plain
// version is ref.wkv6_backward_naive, and ref.wkv6_backward_chunks writes
// this kernel's arithmetic out in PyTorch.
//
// Bound: float32 operations, about 10 hs^2 a token and head against 20
// bytes an element at f32, 12 at bf16. Chunked, most of the work is
// products on the tensor cores (TF32 x 3, float32 accuracy).
//
// Chunks of C = 32 tokens. Inside chunk [b, e] with incoming state S_in
// and outgoing gradient G_out every per-token state and gradient is a
// low-rank update of those two, so none is formed. With products of w
// (channelwise, every factor in [0, 1]; no log, exp or division, so w = 0,
// 1 and 1e-30 are ordinary values) P_t = prod w[< t], Q_t = prod w[> t],
// D(a, c) = prod w[a < . < c], and M = dY V^T (M[t, s] = dy_t . v_s):
//
//   dr_t = P_t (S_in dy_t) + F_t[t] + u k_t M[t, t]
//   dk_t = Q_t (G_out v_t) + H_t[t] + u r_t M[t, t]
//   dv   = A^T dY + KQ G_out          (A, KQ = k Q as the forward forms them)
//   dw_t = P_t Q_t rowsum(G_out * S_in) + Q_t Z_t + P_t Z'_t + T4_t
//   du  += r_t k_t M[t, t]
//
// where, channel by channel, F_{t+1}[x] = w_t F_t[x] + k_t M[x, t] and
// H_{t-1}[x] = w_t H_t[x] + r_t M[t, x] (F_t[x] = sum_{s<t} D(s,t) k_s
// M[x,s], H_t[x] = sum_{t'>t} D(t,t') r_t' M[t',x]), Z_{t+1} = w_t Z_t +
// k_t (G_out v_t), Z'_{t-1} = w_t Z'_t + r_t (S_in dy_t), and T4_t =
// sum_{s<t<t'} D(s,t) D(t,t') r_t' k_s M[t',s]. A pair across the chunk's
// two sub-chunks of 16 factors at their boundary, so F, H and T4 split:
// the pairs across come from two more products on the tensor cores (Fx =
// M10 KS0, Hx = M10^T RP1, ref.wkv6_backward_chunks), the pairs inside a
// sub-chunk from the scans, T4 a Horner sum over the shorter side.
//
// Three kernels a call, in one stream:
// - pass: the chunk-boundary states, serial over chunks. The S role steps
//   S <- diag(W) S + KQ^T V forward from `state` and writes each chunk's
//   S_in; the G role steps G <- diag(W) G + RQ^T dY (RQ = r P) back from
//   the final state's gradient (or 0) and writes each chunk's G_out, its
//   last G is dstate0. Value columns never mix in either: a block takes
//   one role and one (batch, head), a warp 16 value columns with every key
//   of them in mma accumulators; two threads a channel form the decay
//   products, half a chunk each; the next chunk comes in by cp.async
//   while this one is stepped. At the training shape it moves about 67 MB
//   (the states it writes are half of that), near the memory's rate.
// - chunk: a block for each (batch, head, chunk), 4 hs threads, two blocks
//   an SM (112 KB of shared memory at hs 64). (1) r, k, v, w, dy in, as
//   float32; (2) the decay products KQ, RP1, KS0; (3) A (its diagonal
//   sub-chunks as the forward forms them, diag_rows; its block across them
//   on the tensor cores) and M; (4a) S_in and G_out in by cp.async, Fx and
//   Hx; (4b) dv and rowsum(G_out * S_in); (4c) Y = S_in dY^T and X = G_out
//   V^T; (5) four threads a channel, each walking one sub-chunk (F or H),
//   then dw's terms; (6) dw. Products on the tensor cores in TF32 at
//   float32 accuracy (mma_x: three products a tile, fewer where an operand
//   is bf16 and so exact in TF32). The pass lets this kernel start before
//   it ends (programmatic dependent launch): phases 1-3 read no state and
//   overlap the pass's last steps; 4a waits for it.
// - du: the partials summed over batch and chunk in a fixed order, no
//   atomics, so a rerun gives the same bits.
// A tail chunk is masked per token (r = k = v = dy = 0, w = 1 change
// nothing), so any T >= 1. Scratch: S_in and G_out of every chunk, [B, H,
// ceil(T / 32), hs, hs] f32 each; no per-token state anywhere.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wkv6.cuh"

namespace {

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Str {  // element strides of [B, T, H, hs]; the last axis is 1
  int64_t b, t, h;
};

// four elements (16 bytes of f32, 8 of bf16) from global to shared memory,
// asynchronously; the group is committed and waited for by the caller
template <typename T>
__device__ __forceinline__ void cp4(T* smem, const T* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
template <typename T>
__device__ __forceinline__ void zero4(T* p) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
}

// Programmatic dependent launch: the pass lets the chunk kernel start
// (launch_dependents), and the chunk kernel waits where it first needs the
// pass's states (wait); both no-ops without the launch attribute.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// An m16n8k8 A fragment of the row-major M[row][col] = X[row * ld + col],
// rows r0 .., columns k0 ..; split.
__device__ __forceinline__ void frag_a_rows(const float* X, int ld, int r0,
                                            int k0, int lane, uint32_t* hi,
                                            uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (r0 + g) * ld + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// An m16n8k8 B fragment of M[k][n] = X[n * ld + k] (X holds M transposed),
// k0 .., n0 ..; split.
__device__ __forceinline__ void frag_b_cols(const float* X, int ld, int k0,
                                            int n0, int lane, uint32_t* hi,
                                            uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = X + (n0 + g) * ld + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// d[j] (NT m16n8 tiles side by side, one A fragment) += sum over k < 8
// KSTEPS of A[m][k] B[k][n]; fa(k0) and fb(k0, j) load the fragments
// (AX, BX: the A or B operand exact in TF32, see mma_x)
template <int KSTEPS, int NT, bool AX = false, bool BX = false, typename FA,
          typename FB>
__device__ __forceinline__ void strip(float (&d)[NT][4], FA fa, FB fb) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int kt = 0; kt < KSTEPS; ++kt) {
    fa(8 * kt, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      fb(8 * kt, j, bh, bl);
      mma_x<AX, BX>(d[j], ah, al, bh, bl);
    }
  }
}

// the accumulators d of a strip at (m0, n0): d[j][q] at row m0 + g + 8 (q
// / 2), column n0 + 8 j + 2 t + q % 2; f(row, col, d[j][2h], d[j][2h + 1])
template <int NT, typename F>
__device__ __forceinline__ void strip_out(const float (&d)[NT][4], int m0,
                                          int n0, int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    f(m0 + g, n0 + 8 * j + 2 * t, d[j][0], d[j][1]);
    f(m0 + g + 8, n0 + 8 * j + 2 * t, d[j][2], d[j][3]);
  }
}

// ---------------------------------------------------------------- pass --

// One block a (batch, head) and role, a warp a group of 16 value columns
// (hs / 16 warps), every key of them in mma accumulators.
template <int HS, typename T>
struct Pass {
  static constexpr int kWarps = HS / 16;
  static constexpr int kThreads = 32 * kWarps;  // 2 hs
  static constexpr int kLdX = HS + 8;  // rows of X1 ([t][i]: KQ or RQ) and
                                       // X2 ([t][j]: v or dy)
  // bytes: the raw chunk twice (a: k or r, w, b: v or dy), then floats
  static constexpr int kA = kC * HS * sizeof(T), kW = kC * HS * 4;
  static constexpr int kRaw = 2 * kA + kW;  // a chunk: a, b, w
  static constexpr int X1 = 2 * kRaw, X2 = X1 + kC * kLdX * 4,
                       WC = X2 + kC * kLdX * 4, kBytes = WC + HS * 4;
};

template <int HS, typename T>
__global__ void __launch_bounds__(Pass<HS, T>::kThreads)
    wkv6_bwd_pass_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ w,
                         const T* __restrict__ dy,
                         const float* __restrict__ s0,
                         const float* __restrict__ dsT,
                         float* __restrict__ ckpt, float* __restrict__ gout,
                         float* __restrict__ ds0, int H, int n_tok, int nck,
                         int role0, Str rs, Str ws, Str ds) {
  using L = Pass<HS, T>;
  constexpr int kMT = HS / 16, kNT = 2;
  constexpr bool kExact = sizeof(T) == 2;  // bf16 b: exact in TF32
  extern __shared__ __align__(16) unsigned char smb[];
  float* const X1 = reinterpret_cast<float*>(smb + L::X1);
  float* const X2 = reinterpret_cast<float*>(smb + L::X2);
  float* const WC = reinterpret_cast<float*>(smb + L::WC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, tig = lane & 3;
  const bool fwd = blockIdx.y + role0 == 0;  // the S role, else the G role
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int col0 = warp * 16;
  const T* const a = fwd ? k : r;  // scaled by Q (KQ) or P (RQ)
  const T* const bsrc = fwd ? v : dy;
  const Str bs = fwd ? rs : ds;
  float* const out = fwd ? ckpt : gout;
  const float* const init = fwd ? s0 : dsT;
  // chunks whose data is stepped: the S role stops at the last chunk's
  // incoming state
  const int steps = fwd ? nck - 1 : nck;

  // the raw chunk c into buffer q; past the end: a = b = 0, w = 1
  auto stage = [&](int c, int q) {
    unsigned char* const base = smb + q * L::kRaw;
    T* const A = reinterpret_cast<T*>(base);
    T* const Bv = reinterpret_cast<T*>(base + L::kA);
    float* const Wr = reinterpret_cast<float*>(base + 2 * L::kA);
    const int t0 = c * kC;
    for (int e = tid; e < kC * HS / 4; e += L::kThreads) {
      const int t = e / (HS / 4), i = (e % (HS / 4)) * 4;
      if (t0 + t < n_tok) {
        const int64_t tt = t0 + t;
        cp4(A + t * HS + i, a + b * rs.b + tt * rs.t + h * rs.h + i);
        cp4(Bv + t * HS + i, bsrc + b * bs.b + tt * bs.t + h * bs.h + i);
        cp4(Wr + t * HS + i, w + b * ws.b + tt * ws.t + h * ws.h + i);
      } else {
        zero4(A + t * HS + i);
        zero4(Bv + t * HS + i);
        *reinterpret_cast<float4*>(Wr + t * HS + i) =
            make_float4(1.f, 1.f, 1.f, 1.f);
      }
    }
    cp_commit();
  };

  let_next_start();  // the chunk kernel waits for this one's states
  // the first chunk is in flight while the state comes in
  if (steps > 0) stage(fwd ? 0 : nck - 1, 0);
  // S[mt][nt][q]: key 16 mt + g8 + 8 (q / 2), column col0 + 8 nt + 2 tig
  // + q % 2
  float S[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt + g8 + 8 * hh, j = col0 + 8 * nt + 2 * tig;
        float2 x = make_float2(0.f, 0.f);
        if (init != nullptr)
          x = *reinterpret_cast<const float2*>(init + (int64_t)bh * HS * HS +
                                               i * HS + j);
        S[mt][nt][2 * hh] = x.x;
        S[mt][nt][2 * hh + 1] = x.y;
      }
  const auto store = [&](float* o) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              o + (16 * mt + g8 + 8 * hh) * HS + col0 + 8 * nt + 2 * tig) =
              make_float2(S[mt][nt][2 * hh], S[mt][nt][2 * hh + 1]);
  };

  for (int it = 0;; ++it) {
    const int c = fwd ? it : nck - 1 - it;
    // the state as chunk c sees it: S_in (S role) or G_out (G role)
    if (it < nck) store(out + ((int64_t)bh * nck + c) * HS * HS);
    if (it == steps) break;
    cp_wait_all();
    __syncthreads();  // chunk c is in; X1, X2, WC and the other buffer free
    if (it + 1 < steps) stage(fwd ? c + 1 : c - 1, (it + 1) & 1);
    const unsigned char* const base = smb + (it & 1) * L::kRaw;
    const T* const A = reinterpret_cast<const T*>(base);
    const T* const Bv = reinterpret_cast<const T*>(base + L::kA);
    const float* const Wr =
        reinterpret_cast<const float*>(base + 2 * L::kA);
    {  // two threads a channel, a half of the chunk each, its products of
       // w from the end (KQ, S role) or the start (RQ, G role); the half
       // away from that boundary starts from the other half's product, an
       // independent chain. Every read first, then the writes.
      const int i = tid % HS, half = tid / HS;
      const bool far = fwd ? half == 0 : half == 1;
      const int t0 = half * kSub, o0 = (1 - half) * kSub;
      float wv[kSub], wo[kSub], av[kSub];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        wv[q] = Wr[(t0 + q) * HS + i];
        wo[q] = far ? Wr[(o0 + q) * HS + i] : 1.f;
        av[q] = ld1(A + (t0 + q) * HS + i);
      }
      float p = 1.f;
#pragma unroll
      for (int q = 0; q < kSub; ++q) p *= wo[q];
      float x1[kSub];
      if (fwd) {
#pragma unroll
        for (int q = kSub - 1; q >= 0; --q) {
          x1[q] = av[q] * p;
          p *= wv[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          x1[q] = av[q] * p;
          p *= wv[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kSub; ++q) X1[(t0 + q) * L::kLdX + i] = x1[q];
      if (far) WC[i] = p;  // the whole chunk's product
      using RawT = typename Raw<T>::type;
      for (int e = tid; e < kC * HS / 4; e += L::kThreads) {
        const int t = e / (HS / 4), j = (e % (HS / 4)) * 4;
        *reinterpret_cast<float4*>(X2 + t * L::kLdX + j) =
            to_f4(*reinterpret_cast<const RawT*>(Bv + t * HS + j));
      }
    }
    __syncthreads();
    // S <- diag(W) S + X1^T X2 over the chunk's 32 tokens
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float f0 = WC[16 * mt + g8], f1 = WC[16 * mt + g8 + 8];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        S[mt][nt][0] *= f0;
        S[mt][nt][1] *= f0;
        S[mt][nt][2] *= f1;
        S[mt][nt][3] *= f1;
      }
    }
    uint32_t ah[4], al[4], bh_[kNT][2], bl_[kNT][2];
#pragma unroll
    for (int kt = 0; kt < kC / 8; ++kt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        frag_b(X2, L::kLdX, 8 * kt, col0 + 8 * nt, lane, bh_[nt], bl_[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        frag_a(X1, L::kLdX, 16 * mt, 8 * kt, lane, ah, al);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_x<false, kExact>(S[mt][nt], ah, al, bh_[nt], bl_[nt]);
      }
    }
  }
  if (!fwd && ds0 != nullptr) store(ds0 + (int64_t)bh * HS * HS);
}

// --------------------------------------------------------------- chunk --

// Shared memory of the chunk kernel, in floats. Rows of a chunk ([t][i])
// and of S_in, G_out ([i][j]) are kLd floats: a row-major fragment load
// puts its 32 lanes on 32 distinct banks. Regions and what they hold in
// turn: KX KQ, RP1 and KS0, then Y and X; SG S_in and G_out, then T4, DWA
// and DWB; AT A^T, then M^T.
template <int HS>
struct Chunk {
  static constexpr int kThreads = 4 * HS;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLd = HS + 4;
  static constexpr int kLdM = kC + 4;  // rows of M ([t][s]) and M^T
  static constexpr int kRows = kC * kLd;
  static constexpr int kSG = (2 * HS > 3 * kC ? 2 * HS : 3 * kC) * kLd;
  static constexpr int R = 0, K = R + kRows, W = K + kRows, V = W + kRows,
                       DY = V + kRows, KX = DY + kRows, SG = KX + 2 * kRows,
                       FH = SG + kSG, M = FH + kRows, AT = M + kC * kLdM,
                       U = AT + kC * kLdA, R1 = U + HS, kFloats = R1 + HS;
};

template <int HS, typename T>
__global__ void __launch_bounds__(4 * HS, HS == 64 ? 2 : 1)
    wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ u,
                          const T* __restrict__ dy,
                          const float* __restrict__ s_in,
                          const float* __restrict__ g_out,
                          T* __restrict__ dr, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ dw,
                          float* __restrict__ du_part, int H, int n_tok,
                          int nck, Str rs, Str ws, Str ds) {
  using L = Chunk<HS>;
  constexpr int kLd = L::kLd, kLdM = L::kLdM, kThreads = L::kThreads;
  constexpr int kWarps = L::kWarps, kNT = HS / 8;
  constexpr bool kX = sizeof(T) == 2;  // r, k, v, dy exact in TF32 (bf16)
  extern __shared__ __align__(16) float sm[];
  float* const R = sm + L::R;
  float* const K = sm + L::K;
  float* const Wt = sm + L::W;
  float* const V = sm + L::V;
  float* const DY = sm + L::DY;
  float* const KQ = sm + L::KX;
  float* const RP1 = KQ + L::kRows;
  float* const KS0 = RP1 + kSub * kLd;
  float* const Y = sm + L::KX;       // once KQ, RP1, KS0 are done with
  float* const X = Y + L::kRows;
  float* const SIN = sm + L::SG;
  float* const GOUT = SIN + HS * kLd;
  float* const T4 = sm + L::SG;      // once S_in, G_out are done with
  float* const DWA = T4 + L::kRows;
  float* const DWB = DWA + L::kRows;
  float* const FX = sm + L::FH;      // Fx = M10 KS0, Hx = M10^T RP1
  float* const HX = FX + kSub * kLd;
  float* const M = sm + L::M;
  float* const AT = sm + L::AT;
  float* const MT = AT;              // once A is done with
  float* const U = sm + L::U;
  float* const R1 = sm + L::R1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x % nck, bh = blockIdx.x / nck;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kC, nt = min(kC, n_tok - t0);
  const int64_t so = ((int64_t)bh * nck + c) * HS * HS;
  const auto out = [&](int t, int i) {
    return (((int64_t)b * n_tok + t0 + t) * H + h) * HS + i;
  };

  // 1. stage as f32: w, and r, k, v, dy (f32: copied as they are; bf16:
  // converted on the way through registers); past the end r = k = v = dy
  // = 0, w = 1. S_in and G_out come once the pass has written them (4a)
  using RawT = typename Raw<T>::type;
  for (int e = tid; e < kC * HS / 4; e += kThreads) {
    const int t = e / (HS / 4), i = (e % (HS / 4)) * 4;
    if (t < nt)
      cp4(Wt + t * kLd + i,
          w + b * ws.b + (int64_t)(t0 + t) * ws.t + h * ws.h + i);
    else
      *reinterpret_cast<float4*>(Wt + t * kLd + i) =
          make_float4(1.f, 1.f, 1.f, 1.f);
  }
  if constexpr (sizeof(T) == 4) {  // f32 r, k, v, dy: copied as they are
    for (int e = tid; e < kC * HS / 4; e += kThreads) {
      const int t = e / (HS / 4), i = (e % (HS / 4)) * 4;
      const int64_t tt = t0 + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Str s = q == 3 ? ds : rs;
        const T* const src = q == 0 ? r : q == 1 ? k : q == 2 ? v : dy;
        float* const dst = q == 0 ? R : q == 1 ? K : q == 2 ? V : DY;
        if (t < nt) cp4(dst + t * kLd + i, src + b * s.b + tt * s.t +
                                               h * s.h + i);
        else zero4(dst + t * kLd + i);
      }
    }
  }
  cp_commit();
  for (int e = tid; e < HS; e += kThreads) U[e] = u[h * HS + e];
  for (int e = tid; e < kC * kLdA; e += kThreads) AT[e] = 0.f;
  if constexpr (sizeof(T) != 4) {  // bf16: through registers, as f32
    constexpr int kIt = kC * HS / 4 / kThreads;
    RawT x[kIt][4];
#pragma unroll
    for (int n = 0; n < kIt; ++n) {
      const int e = tid + n * kThreads;
      const int t = e / (HS / 4), i = (e % (HS / 4)) * 4;
      const int64_t tt = t0 + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Str s = q == 3 ? ds : rs;
        const T* const src = q == 0 ? r : q == 1 ? k : q == 2 ? v : dy;
        x[n][q] = t < nt ? *reinterpret_cast<const RawT*>(
                               src + b * s.b + tt * s.t + h * s.h + i)
                         : RawT{};
      }
    }
#pragma unroll
    for (int n = 0; n < kIt; ++n) {
      const int e = tid + n * kThreads;
      const int t = e / (HS / 4), i = (e % (HS / 4)) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* const dst = q == 0 ? R : q == 1 ? K : q == 2 ? V : DY;
        *reinterpret_cast<float4*>(dst + t * kLd + i) = to_f4(x[n][q]);
      }
    }
  }
  cp_wait_all();
  __syncthreads();

  // 2. products of w, a thread a channel and role: KQ, RP1 (the second
  // sub-chunk's r from its start) and KS0 (the first's k to its end)
  const int role = tid / HS, i = tid % HS;
  if (role > 0) {  // every read first, then the chain, then the writes
    const int n = role == 1 ? kC : kSub;          // KQ: the whole chunk
    const int t0 = role == 2 ? kSub : 0;          // RP1: the second half
    const float* const X = role == 2 ? R : K;
    float* const D = role == 1 ? KQ : role == 2 ? RP1 : KS0;
    float x[kC], wv[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q)
      if (q < n) {
        x[q] = X[(t0 + q) * kLd + i];
        wv[q] = Wt[(t0 + q) * kLd + i];
      }
    float p = 1.f;
    if (role == 2) {  // from the start of its half
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        x[q] *= p;
        p *= wv[q];
      }
    } else {  // to the end of the chunk (KQ) or of the first half (KS0)
#pragma unroll
      for (int q = kC - 1; q >= 0; --q)
        if (q < n) {
          x[q] *= p;
          p *= wv[q];
        }
    }
#pragma unroll
    for (int q = 0; q < kC; ++q)
      if (q < n) D[q * kLd + i] = x[q];
  }
  __syncthreads();

  // 3. A (its diagonal sub-chunks, its block across them, the bonus) and
  // M = dY V^T
  for (int p = warp; p < 8; p += kWarps)
    diag_rows<HS, kLd>(R, K, Wt, AT, p, lane);
  for (int job = warp; job < 5; job += kWarps) {
    float d[2][4] = {};
    if (job == 4) {  // A[16 + t][s] = RP1[t] . KS0[s], s < 16
      strip<HS / 8, 2>(
          d, [&](int k0, uint32_t* hi, uint32_t* lo) {
            frag_a_rows(RP1, kLd, 0, k0, lane, hi, lo);
          },
          [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
            frag_b_cols(KS0, kLd, k0, 8 * j, lane, hi, lo);
          });
      strip_out(d, 0, 0, lane, [&](int t, int s, float x0, float x1) {
        AT[s * kLdA + kSub + t] = x0;
        AT[(s + 1) * kLdA + kSub + t] = x1;
      });
    } else {  // M[t][s] = dy_t . v_s, rows m0 .., columns n0 ..
      const int m0 = 16 * (job / 2), n0 = 16 * (job % 2);
      strip<HS / 8, 2, kX, kX>(
          d, [&](int k0, uint32_t* hi, uint32_t* lo) {
            frag_a_rows(DY, kLd, m0, k0, lane, hi, lo);
          },
          [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
            frag_b_cols(V, kLd, k0, n0 + 8 * j, lane, hi, lo);
          });
      strip_out(d, m0, n0, lane, [&](int t, int s, float x0, float x1) {
        *reinterpret_cast<float2*>(M + t * kLdM + s) = make_float2(x0, x1);
      });
    }
  }
  {  // the bonus A[t][t] = sum_i r_t[i] u[i] k_t[i]: 32 rows of HS / 8
     // slices of 8 channels, summed by a fixed butterfly
    constexpr int kSlices = HS / 8;
    const int t = tid / kSlices, c8 = (tid % kSlices) * 8;
    float bonus = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      bonus = fmaf(R[t * kLd + c8 + a] * U[c8 + a], K[t * kLd + c8 + a],
                   bonus);
    bonus = lane_sum(bonus, kSlices);
    if (tid % kSlices == 0) AT[t * kLdA + t] = bonus;
  }
  __syncthreads();

  // 4a. S_in and G_out, once the pass that writes them is done (its last
  // stores and this kernel's first phases overlap); meanwhile the two
  // products across the sub-chunks: Fx = M10 KS0, Hx = M10^T RP1 (M10:
  // M's rows 16 .., columns .. 15)
  wait_for_previous();
  for (int e = tid; e < HS * HS / 4; e += kThreads) {
    const int i = e / (HS / 4), j = (e % (HS / 4)) * 4;
    if (s_in != nullptr) cp4(SIN + i * kLd + j, s_in + so + i * HS + j);
    else zero4(SIN + i * kLd + j);
    if (g_out != nullptr) cp4(GOUT + i * kLd + j, g_out + so + i * HS + j);
    else zero4(GOUT + i * kLd + j);
  }
  cp_commit();
  for (int job = warp; job < 2 * (kNT / 2); job += kWarps) {
    float d[2][4] = {};
    const bool fx = job % 2 == 0;
    const int n0 = 16 * (job / 2);
    strip<kSub / 8, 2>(
        d, [&](int k0, uint32_t* hi, uint32_t* lo) {
          if (fx) frag_a_rows(M + kSub * kLdM, kLdM, 0, k0, lane, hi, lo);
          else frag_a(M + kSub * kLdM, kLdM, 0, k0, lane, hi, lo);
        },
        [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
          frag_b(fx ? KS0 : RP1, kLd, k0, n0 + 8 * j, lane, hi, lo);
        });
    float* const D = fx ? FX : HX;
    strip_out(d, 0, n0, lane, [&](int t, int j, float x0, float x1) {
      *reinterpret_cast<float2*>(D + t * kLd + j) = make_float2(x0, x1);
    });
  }
  cp_wait_all();
  __syncthreads();

  // 4b. dv = A^T dY + KQ G_out, written out; rowsum(G_out * S_in), four
  // partial sums in a fixed order (a shorter chain)
  if (tid < HS) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int jj = 0; jj < HS; ++jj) {
      const int j = (jj + i) & (HS - 1);  // lanes on distinct banks
      a[jj % 4] = fmaf(GOUT[i * kLd + j], SIN[i * kLd + j], a[jj % 4]);
    }
    R1[i] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  for (int job = warp; job < 2 * (kNT / 2); job += kWarps) {
    float d[2][4] = {};
    const int m0 = 16 * (job % 2), n0 = 16 * (job / 2);
    strip<kC / 8, 2, false, kX>(
        d, [&](int k0, uint32_t* hi, uint32_t* lo) {
          frag_a_rows(AT, kLdA, m0, k0, lane, hi, lo);
        },
        [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
          frag_b(DY, kLd, k0, n0 + 8 * j, lane, hi, lo);
        });
    strip<HS / 8, 2>(
        d, [&](int k0, uint32_t* hi, uint32_t* lo) {
          frag_a_rows(KQ, kLd, m0, k0, lane, hi, lo);
        },
        [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
          frag_b(GOUT, kLd, k0, n0 + 8 * j, lane, hi, lo);
        });
    if (dv != nullptr)
      strip_out(d, m0, n0, lane, [&](int s, int j, float x0, float x1) {
        if (s < nt) store2(dv + out(s, j), x0, x1);
      });
  }
  __syncthreads();

  // 4c. Y = dY S_in^T, X = V G_out^T (Y[t][i] = S_in dy_t, X[t][i] =
  // G_out v_t), in place of KQ, RP1 and KS0; M^T in place of A^T
  for (int job = warp; job < 2 * (kNT / 2); job += kWarps) {
    const int m0 = 16 * (job % 2), n0 = 16 * (job / 2);
    float dyy[2][4] = {}, dxx[2][4] = {};
    strip<HS / 8, 2, kX>(
        dyy, [&](int k0, uint32_t* hi, uint32_t* lo) {
          frag_a_rows(DY, kLd, m0, k0, lane, hi, lo);
        },
        [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
          frag_b_cols(SIN, kLd, k0, n0 + 8 * j, lane, hi, lo);
        });
    strip<HS / 8, 2, kX>(
        dxx, [&](int k0, uint32_t* hi, uint32_t* lo) {
          frag_a_rows(V, kLd, m0, k0, lane, hi, lo);
        },
        [&](int k0, int j, uint32_t* hi, uint32_t* lo) {
          frag_b_cols(GOUT, kLd, k0, n0 + 8 * j, lane, hi, lo);
        });
    strip_out(dyy, m0, n0, lane, [&](int t, int j, float x0, float x1) {
      *reinterpret_cast<float2*>(Y + t * kLd + j) = make_float2(x0, x1);
    });
    strip_out(dxx, m0, n0, lane, [&](int t, int j, float x0, float x1) {
      *reinterpret_cast<float2*>(X + t * kLd + j) = make_float2(x0, x1);
    });
  }
  for (int e = tid; e < kC * kC; e += kThreads)
    MT[(e % kC) * kLdM + e / kC] = M[(e / kC) * kLdM + e % kC];
  __syncthreads();

  // 5. the scans, a thread a channel and role; the two sub-chunks side by
  // side (independent chains), their pairs across from Fx and Hx. Each
  // step's operands are read before any result is written, and results
  // bound for shared memory wait in registers until the scan ends: no
  // store stands between a read and the step it feeds.
  const float ui = U[i];
  // row t of a [kC][kLdM] matrix, columns 16 a .. 16 a + 15
  const auto row16 = [&](const float* Mx, int t, int a, float (&m)[kSub]) {
#pragma unroll
    for (int q = 0; q < kSub / 4; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(Mx + t * kLdM + a * kSub + 4 * q);
      m[4 * q] = x.x;
      m[4 * q + 1] = x.y;
      m[4 * q + 2] = x.z;
      m[4 * q + 3] = x.w;
    }
  };
  constexpr int kHalf = kSub / 2;
  // The walks inside a sub-chunk: F forward (dr, and T4 of its tokens 8
  // .. 15, over t' > t) or H backward from its end (dk, and T4 of its
  // tokens 0 .. 7, over s < t); one body, the direction and the sub-chunk
  // constants of each copy. Roles 0 and 1 walk the second sub-chunk,
  // roles 2 and 3 the first and then take dw's terms. The walk is a loop,
  // its register arrays indexed by constants under a mask on l: a block
  // runs this code once, so a short body read again and again beats an
  // unrolled one read once.
  const auto scan = [&](auto forward, auto sub) {
    constexpr bool fw = decltype(forward)::value;
    constexpr int a = decltype(sub)::value, base = a * kSub;
    // the sub-chunk whose walk carries the term across the two: rpf Fx
    // into dr's second, ksf Hx into dk's first
    constexpr bool across = fw ? a == 1 : a == 0;
    float F[kSub], hr[kHalf], hw[kHalf];
    // Horner's operands: r, w of tokens 8 .. 15 (F) or k, w of 0 .. 7 (H)
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int t = base + (fw ? kHalf : 0) + q;
      hr[q] = (fw ? R : K)[t * kLd + i];
      hw[q] = Wt[t * kLd + i];
    }
    // P_t (F) or Q_t (H) at the walk's start: the other sub-chunk's
    // product where it lies between
    float PQ = 1.f, bf = 1.f;
    if (fw ? a == 1 : a == 0) {
#pragma unroll
      for (int q = 0; q < kSub; ++q)
        PQ *= Wt[((fw ? 0 : kSub) + q) * kLd + i];
    }
#pragma unroll
    for (int q = 0; q < kSub; ++q) F[q] = 0.f;
    const float* const Mx = fw ? MT : M;  // M[base + x][t] or M[t][base + x]
    const float* const G = fw ? Y : X;
    const float* const Z = fw ? K : R;
    const float* const XF = fw ? FX : HX;
    T* const dst = fw ? dr : dk;
    // one step at l; LOWER: l < 8. The ranges of x each step can touch
    // are constants of the half: the extraction of F[l] over x in the
    // half, the update over x > l (F) or x < l (H), Horner's sum over the
    // shorter side (F: x > l >= 8; H: x < l < 8)
    const auto at = [&](int l, auto lower) {
      constexpr bool lo = decltype(lower)::value;
      constexpr int e0 = lo ? 0 : kHalf;
      constexpr int u0 = fw ? (lo ? 1 : kHalf + 1) : 0;
      constexpr int u1 = fw ? kSub : (lo ? kHalf - 1 : kSub - 1);
      const int t = base + l;
      const float zt = Z[t * kLd + i], wt = Wt[t * kLd + i];
      const float gt = G[t * kLd + i], mtt = M[t * kLdM + t];
      const float xt = across ? XF[l * kLd + i] : 0.f;
      float m[kSub];
      row16(Mx, t, a, m);
      float fl = 0.f;  // F[l]
#pragma unroll
      for (int x = e0; x < e0 + kHalf; ++x) fl = x == l ? F[x] : fl;
      float d = fmaf(PQ, gt, fl);
      if (across) d = fmaf(bf, xt, d);
      d += ui * zt * mtt;
      if (dst != nullptr && t < nt) st1(dst + out(t, i), d);
      if constexpr (fw ? !lo : lo) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kHalf; ++q) {
          const int x = fw ? kSub - 1 - q : q;
          const int h = fw ? kHalf - 1 - q : q;
          if (fw ? x > l : x < l) acc = fmaf(hw[h], acc, hr[h] * F[x]);
        }
        T4[t * kLd + i] = acc;
      }
#pragma unroll
      for (int x = u0; x < u1; ++x)
        if (fw ? x > l : x < l) F[x] = fmaf(wt, F[x], zt * m[x]);
      PQ *= wt;
      if (across) bf *= wt;
    };
    using Lo = std::true_type;
    using Hi = std::false_type;
    if constexpr (fw) {
#pragma unroll 1
      for (int l = 0; l < kHalf; ++l) at(l, Lo{});
#pragma unroll 1
      for (int l = kHalf; l < kSub; ++l) at(l, Hi{});
    } else {
#pragma unroll 1
      for (int l = kSub - 1; l >= kHalf; --l) at(l, Hi{});
#pragma unroll 1
      for (int l = kHalf - 1; l >= 0; --l) at(l, Lo{});
    }
  };
  using F_ = std::true_type;
  using H_ = std::false_type;
  using Sub0 = std::integral_constant<int, 0>;
  using Sub1 = std::integral_constant<int, 1>;
  if (role == 0) {
    scan(F_{}, Sub1{});
  } else if (role == 1) {
    scan(H_{}, Sub1{});
  } else if (role == 2) {  // dw: P Q rowsum + Q Z, and ksf Zh (first half)
    scan(F_{}, Sub0{});
    float q[kC], ksf[kSub], wv[kC], kv[kC], xv[kC], hx[kSub];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      wv[t] = Wt[t * kLd + i];
      kv[t] = K[t * kLd + i];
      xv[t] = X[t * kLd + i];
    }
#pragma unroll
    for (int t = 0; t < kSub; ++t) hx[t] = HX[t * kLd + i];
    q[kC - 1] = 1.f;
#pragma unroll
    for (int t = kC - 1; t > 0; --t) q[t - 1] = q[t] * wv[t];
    ksf[kSub - 1] = 1.f;
#pragma unroll
    for (int t = kSub - 1; t > 0; --t) ksf[t - 1] = ksf[t] * wv[t];
    float P = 1.f, z = 0.f, zh = 0.f;
    const float r1 = R1[i];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      float d = fmaf(P * q[t], r1, q[t] * z);
      if (t < kSub) {
        d = fmaf(ksf[t], zh, d);
        zh = fmaf(wv[t], zh, kv[t] * hx[t]);
      }
      q[t] = d;  // DWA[t], in q's place
      z = fmaf(wv[t], z, kv[t] * xv[t]);
      P *= wv[t];
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) DWA[t * kLd + i] = q[t];
  } else {  // dw: P Z', and rpf Zf (second half); du's partial
    scan(H_{}, Sub0{});
    float p[kC], rpf[kSub], wv[kC], rv[kC], yv[kC], fx[kSub];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      wv[t] = Wt[t * kLd + i];
      rv[t] = R[t * kLd + i];
      yv[t] = Y[t * kLd + i];
    }
#pragma unroll
    for (int t = 0; t < kSub; ++t) fx[t] = FX[t * kLd + i];
    if (du_part != nullptr) {
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t)
        a = fmaf(rv[t] * K[t * kLd + i], M[t * kLdM + t], a);
      du_part[(((int64_t)b * nck + c) * H + h) * HS + i] = a;
    }
    p[0] = 1.f;
#pragma unroll
    for (int t = 1; t < kC; ++t) p[t] = p[t - 1] * wv[t - 1];
    rpf[0] = 1.f;
#pragma unroll
    for (int l = 1; l < kSub; ++l) rpf[l] = rpf[l - 1] * wv[kSub + l - 1];
    float z = 0.f, zf = 0.f;
#pragma unroll
    for (int t = kC - 1; t >= 0; --t) {
      float d = p[t] * z;
      if (t >= kSub) {
        d = fmaf(rpf[t - kSub], zf, d);
        zf = fmaf(wv[t], zf, rv[t] * fx[t - kSub]);
      }
      p[t] = d;  // DWB[t], in p's place
      z = fmaf(wv[t], z, rv[t] * yv[t]);
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) DWB[t * kLd + i] = p[t];
  }
  if (dw == nullptr) return;
  __syncthreads();
  // 6. dw = (DWA + DWB) + T4
  for (int e = tid; e < kC * HS / 4; e += kThreads) {
    const int t = e / (HS / 4), j = (e % (HS / 4)) * 4;
    if (t >= nt) continue;
    const float4 a = *reinterpret_cast<const float4*>(DWA + t * kLd + j);
    const float4 bb = *reinterpret_cast<const float4*>(DWB + t * kLd + j);
    const float4 e4 = *reinterpret_cast<const float4*>(T4 + t * kLd + j);
    *reinterpret_cast<float4*>(dw + out(t, j)) =
        make_float4((a.x + bb.x) + e4.x, (a.y + bb.y) + e4.y,
                    (a.z + bb.z) + e4.z, (a.w + bb.w) + e4.w);
  }
}

// du[h, i] = sum over (b, c) of du_part[b, c, h, i], in order
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int n, int H, int hs) {
  const int h = blockIdx.x, i = threadIdx.x;
  float a = 0.f;
  for (int q = 0; q < n; ++q) a += du_part[((int64_t)q * H + h) * hs + i];
  du[h * hs + i] = a;
}

// whether the chunk kernel starts before the pass ends (programmatic
// dependent launch); off, each kernel's profiled time is its own
bool g_pdl = true;

// dynamic shared memory above 48 KB only after the opt-in, once a device
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool (&opted)[64]) {
  int dev = 0;
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && opted[dev])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // the most shared memory an SM can give, so that blocks share SMs
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) opted[dev] = true;
  return err;
}

template <int HS, typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0,
                   const void* dy, const void* dsT, void* dr, void* dk,
                   void* dv, void* dw, void* du, void* du_part, void* ds0,
                   void* ckpt, void* gout, int B, int H, int n_tok, Str rs,
                   Str ws, Str ds, cudaStream_t s) {
  static bool opted_pass[64] = {}, opted_chunk[64] = {};
  const bool want_s = dr || dw, want_g = dk || dv || dw || ds0;
  const int nck = (n_tok + kC - 1) / kC;
  cudaError_t err;
  if (want_s || want_g) {
    using L = Pass<HS, T>;
    auto kernel = wkv6_bwd_pass_kernel<HS, T>;
    if ((err = opt_in(kernel, L::kBytes, opted_pass)) != cudaSuccess)
      return err;
    const dim3 grid(B * H, want_s + want_g);
    kernel<<<grid, L::kThreads, L::kBytes, s>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<const float*>(s0),
        static_cast<const float*>(dsT), static_cast<float*>(ckpt),
        static_cast<float*>(gout), static_cast<float*>(ds0), H, n_tok, nck,
        want_s ? 0 : 1, rs, ws, ds);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (dr || dk || dv || dw || du) {
    using L = Chunk<HS>;
    constexpr int kBytes = L::kFloats * sizeof(float);
    auto kernel = wkv6_bwd_chunk_kernel<HS, T>;
    if ((err = opt_in(kernel, kBytes, opted_chunk)) != cudaSuccess)
      return err;
    // behind the pass, the chunk kernel starts before the pass ends (its
    // first phases read no state); behind anything else it waits as usual
    cudaLaunchAttribute early[1];
    early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * H * nck);
    cfg.blockDim = dim3(L::kThreads);
    cfg.dynamicSmemBytes = kBytes;
    cfg.stream = s;
    cfg.attrs = early;
    cfg.numAttrs = (want_s || want_g) && g_pdl ? 1 : 0;
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const T*>(dy),
        want_s ? static_cast<const float*>(ckpt) : nullptr,
        want_g ? static_cast<const float*>(gout) : nullptr,
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(dw), du ? static_cast<float*>(du_part) : nullptr,
        H, n_tok, nck, rs, ws, ds);
    if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess ||
        !du)
      return err;
    wkv6_du_kernel<<<H, HS, 0, s>>>(static_cast<const float*>(du_part),
                                    static_cast<float*>(du), B * nck, H, HS);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// The pass and chunk kernels' dynamic shared memory and the blocks an SM
// can hold with it (the occupancy calculator: registers, threads, shared
// memory), for the trace: {pass bytes, pass blocks, chunk bytes, chunk
// blocks}.
template <int HS, typename T>
cudaError_t occupancy(int* out) {
  auto pass = wkv6_bwd_pass_kernel<HS, T>;
  auto chunk = wkv6_bwd_chunk_kernel<HS, T>;
  const int pb = Pass<HS, T>::kBytes, cb = Chunk<HS>::kFloats * 4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           pass, cudaFuncAttributeMaxDynamicSharedMemorySize, pb)) ||
      (err = cudaFuncSetAttribute(
           chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, cb)) ||
      (err = cudaFuncSetAttribute(
           pass, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) ||
      (err = cudaFuncSetAttribute(
           chunk, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           out + 1, pass, Pass<HS, T>::kThreads, pb)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           out + 3, chunk, Chunk<HS>::kThreads, cb)))
    return err;
  out[0] = pb;
  out[2] = cb;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// r, k, v, dy: [B, T, H, hs] float32 (bf16 != 0: bfloat16), element
// strides (rb, rt, rh) for r, k and v, (db, dt, dh) for dy, the last axis
// contiguous; w: [B, T, H, hs] f32, strides (wb, wt, wh); every stride and
// base address a multiple of 4 elements. u: [H, hs] f32; s0: [B, H, hs,
// hs] f32; dsT: the final state's gradient, the same, or null (none).
// Outputs, each null where its gradient is not wanted: dr, dk, dv [B, T,
// H, hs] contiguous in r's type; dw the same in f32; du [H, hs] f32
// (du_part: [B, ceil(T / 32), H, hs] f32 scratch when du is wanted); ds0
// [B, H, hs, hs] f32. Scratch, 16-byte aligned, [B, H, ceil(T / 32), hs,
// hs] f32: ckpt (each chunk's incoming state) when dr or dw is wanted,
// gout (each chunk's outgoing gradient) when dk, dv, dw or ds0 is. hs is
// 16 or 64, T >= 1. Returns cudaErrorInvalidValue otherwise, else
// cudaGetLastError() after the launches.
int repro_wkv6_backward(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* dsT, void* dr, void* dk,
                        void* dv, void* dw, void* du, void* du_part,
                        void* ds0, void* ckpt, void* gout, int B, int H,
                        int n_tok, int hs, int bf16, int64_t rb, int64_t rt,
                        int64_t rh, int64_t wb, int64_t wt, int64_t wh,
                        int64_t db, int64_t dt, int64_t dh, void* stream) {
  const bool want_s = dr || dw, want_g = dk || dv || dw || ds0;
  const uintptr_t vec = bf16 ? 8 : 16;
  const uintptr_t in = reinterpret_cast<uintptr_t>(r) |
                       reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v) |
                       reinterpret_cast<uintptr_t>(dy);
  const uintptr_t scratch = reinterpret_cast<uintptr_t>(ckpt) |
                            reinterpret_cast<uintptr_t>(gout);
  if ((hs != 16 && hs != 64) || n_tok < 1 || B < 1 || H < 1 ||
      (du && !du_part) || (want_s && !ckpt) || (want_g && !gout) ||
      in % vec || reinterpret_cast<uintptr_t>(w) % 16 || scratch % 16 ||
      (rb | rt | rh | wb | wt | wh | db | dt | dh) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Str rs{rb, rt, rh}, ws{wb, wt, wh}, ds{db, dt, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_WKV6_BWD(HS, T)                                                 \
  launch<HS, T>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du, du_part, ds0, \
                ckpt, gout, B, H, n_tok, rs, ws, ds, s)
  if (hs == 64)
    err = bf16 ? REPRO_WKV6_BWD(64, __nv_bfloat16) : REPRO_WKV6_BWD(64, float);
  else
    err = bf16 ? REPRO_WKV6_BWD(16, __nv_bfloat16) : REPRO_WKV6_BWD(16, float);
#undef REPRO_WKV6_BWD
  return static_cast<int>(err);
}

// out: {pass bytes, pass blocks an SM, chunk bytes, chunk blocks an SM} at
// head size hs (16 or 64) and r's type (bf16 != 0: bfloat16).
int repro_wkv6_backward_occupancy(int hs, int bf16, int* out) {
  if (hs != 16 && hs != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (hs == 64)
    err = bf16 ? occupancy<64, __nv_bfloat16>(out) : occupancy<64, float>(out);
  else
    err = bf16 ? occupancy<16, __nv_bfloat16>(out) : occupancy<16, float>(out);
  return static_cast<int>(err);
}

// Whether the chunk kernel starts before the pass ends (programmatic
// dependent launch; on != 0, the default) for this process's later calls;
// returns the setting before.
int repro_wkv6_backward_pdl(int on) {
  const int was = g_pdl;
  g_pdl = on != 0;
  return was;
}

// repro_wkv6_backward's arguments in order, each as an int64 (pointers
// included): one pointer to pass instead of 32 typed values.
int repro_wkv6_backward_packed(const int64_t* a) {
  const auto p = [a](int i) { return reinterpret_cast<void*>(a[i]); };
  return repro_wkv6_backward(
      p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10),
      p(11), p(12), p(13), p(14), p(15), p(16), (int)a[17], (int)a[18],
      (int)a[19], (int)a[20], (int)a[21], a[22], a[23], a[24], a[25], a[26],
      a[27], a[28], a[29], a[30], p(31));
}

}  // extern "C"
