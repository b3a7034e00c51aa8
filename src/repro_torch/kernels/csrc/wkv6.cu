// WKV6 recurrence of RWKV-6 ("Finch") over a segment, exact:
//
//   y_t = (S + diag(u) k_t v_t^T)^T r_t
//   S  <- diag(w_t) S + k_t v_t^T            (S: [hs key, hs value] f32)
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6.py:68 (wkv6, body
// _kernel :25). That kernel evaluates 32-token chunks through cumulative
// log-decays and clips them at -25 before the inverse exponential
// (rwkv6.py:45), which departs from the recurrence wherever a chunk of one
// channel decays past e^-25. This one is chunked too, but forms every decay
// as a product of w, so it computes the recurrence itself (to float32
// rounding; ref.wkv6_subchunks writes the same arithmetic out in PyTorch).
//
// Bound: float32 operations at hs = 64. The least work a token and head is
// 5*hs^2 + 5*hs (y = S^T r, the bonus, the state step) on 12*hs bytes; the
// chunked form does about 2*hs^2 + C*hs multiply-adds a token, C = 32.
//
// Design. One block per (batch, head), 4*hs threads (hs / 8 warps). Tokens
// go in chunks of C = 32, each two sub-chunks of 16. Per chunk, with the
// incoming state S:
//
// - rq_t = r_t * prod(w from the chunk start to t-1) and kq_s = k_s *
//   prod(w from s+1 to the chunk end), each a product of w taken outwards
//   from a sub-chunk boundary (the factor of the other, whole sub-chunk
//   applied last), and W = prod over the chunk: a thread a channel, side
//   and sub-chunk, 16 products in token order. No log, exp or division:
//   every factor is in [0, 1], w = 0 and w = 1 are ordinary values, and a
//   product underflows only where the true decay is below float32's range.
// - A[t, s], the weight of v_s in y_t: for t in sub-chunk 1 and s in 0,
//   rp_t . ks_s (the products from their own sub-chunk's boundary); inside
//   a sub-chunk, sum_i r_t[i] k_s[i] prod(w[s+1..t-1])[i] by a running
//   product from r_t backwards (a warp a pair of rows, its lanes the
//   channels, the sums out by a fixed butterfly); on the diagonal the
//   bonus sum_i r_t[i] u[i] k_t[i].
// - The state step, y = rq S + A v and S <- diag(W) S + kq^T v, on the
//   tensor cores: mma.sync m16n8k8 TF32 in three products a tile (a = hi
//   + lo; a_lo b_hi + a_hi b_lo + a_hi b_hi keeps float32 accuracy, where
//   one TF32 product, about 10 mantissa bits, would not hold 1e-5). A group
//   of warps owns 16 value columns (8 at hs = 16), so the state never
//   crosses groups; each warp of a group holds its keys of S in the
//   accumulators and sums y over them (and over its tokens of A v), the
//   warps' shares added through shared memory. Only this step is serial
//   across chunks: 2 steps at T = 64, 32 at T = 1000.
//
// Chunk c's state step runs beside chunk c + 1's preparation, which does
// not depend on the state; the chunk after that is loaded into registers
// meanwhile, read through the [B, T, H, hs] strides (no transposed copy).
// The tail chunk is masked per token (r = k = v = 0, w = 1 change
// nothing), so any T >= 1. Sums run in a fixed order without atomics: a
// rerun gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv6.cuh"

namespace {

// Shared memory, in floats. What the state step of a chunk reads (V, RQT,
// KQ, AT, WC) is kept twice: chunk c's copy while chunk c + 1's is made.
// The row strides put a fragment load's 32 lanes on 32 distinct banks.
template <int HS>
struct Smem {
  static constexpr int kLd = HS + 4;       // rows of RP1, KS0
  static constexpr int kLdT = kC + 8;      // rows of RQT (RQT[i][t])
  static constexpr int kLdV = HS + 8;      // rows of V and KQ ([t][i])
  static constexpr int kLdS = 24;          // rows of S0p, Yp (16 or 8 used)
  static constexpr int kGroups = HS == 64 ? 4 : 2;  // column groups
  static constexpr int kHalves = HS == 64 ? 2 : 1;  // warps a group
  static constexpr int kV = kC * kLdV, kRQT = HS * kLdT, kAT = kC * kLdA,
                       kWC = HS;  // one copy of each (KQ is as V)
  static constexpr int R = 0, K = R + kC * HS, W = K + kC * HS,
                       V = W + kC * HS, RP1 = V + 2 * kV,
                       KS0 = RP1 + kSub * kLd, RQT = KS0 + kSub * kLd,
                       KQ = RQT + 2 * kRQT, AT = KQ + 2 * kV,
                       WC = AT + 2 * kAT, U = WC + 2 * kWC, S0 = U + HS,
                       YP = S0 + kGroups * HS * kLdS,
                       kFloats = YP + kGroups * kHalves * kC * kLdS;
};

template <int HS, typename T>
__global__ void __launch_bounds__(4 * HS, 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s1,
    int H, int n_tok, int64_t sb, int64_t st, int64_t sh, int64_t wb,
    int64_t wt, int64_t wh) {
  using L = Smem<HS>;
  using RawT = typename Raw<T>::type;
  constexpr int kThreads = 4 * HS;
  extern __shared__ __align__(16) float sm[];
  float* const R = sm + L::R;
  float* const K = sm + L::K;
  float* const Wt = sm + L::W;
  float* const RP1 = sm + L::RP1;
  float* const KS0 = sm + L::KS0;
  float* const U = sm + L::U;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // a group of kHalves warps owns kCW value columns; warp half h of a
  // group holds keys h * kRows .. of S (and takes tokens h * kTpw .. of A v)
  constexpr int kHalves = L::kHalves;
  constexpr int kCW = HS / L::kGroups;     // 16 or 8 columns a group
  constexpr int kNT = kCW / 8;             // n-tiles
  constexpr int kRows = HS / kHalves;      // keys a warp: 32 or 16
  constexpr int kMT = kRows / 16;          // m-tiles of S
  constexpr int kTpw = kC / kHalves;       // tokens of A v a warp
  const int grp = warp % L::kGroups, half = warp / L::kGroups;
  const int col0 = grp * kCW, key0 = half * kRows;
  const int g8 = lane >> 2, tig = lane & 3;
  float* const S0p = sm + L::S0 + grp * HS * L::kLdS;  // the group's S
  float* const Yp = sm + L::YP + grp * kHalves * kC * L::kLdS;

  // this warp's keys of S in registers, as m16n8 accumulators: S[mt][nt][q]
  // = S[key0 + 16 mt + g8 + 8 (q / 2)][col0 + 8 nt + 2 tig + q % 2]
  float S[kMT][kNT][4];
  {
    const float* p = s0 + (int64_t)bh * HS * HS;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = key0 + 16 * mt + g8 + 8 * hh, j = 8 * nt + 2 * tig;
          const float2 x =
              *reinterpret_cast<const float2*>(p + i * HS + col0 + j);
          S[mt][nt][2 * hh] = x.x;
          S[mt][nt][2 * hh + 1] = x.y;
          *reinterpret_cast<float2*>(S0p + i * L::kLdS + j) = x;
        }
  }
  for (int e = tid; e < HS; e += kThreads) U[e] = u[h * HS + e];
  for (int e = tid; e < 2 * L::kAT; e += kThreads) sm[L::AT + e] = 0.f;

  // the chunk's inputs: two 4-element vectors a thread and array
  const int64_t in_off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t w_off = (int64_t)b * wb + (int64_t)h * wh;
  RawT rr[2], kr[2], vr[2];
  float4 wr[2];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + q * kThreads;
      const int t = e / (HS / 4), c = (e % (HS / 4)) * 4;
      if (c0 + t < n_tok) {
        const int64_t o = in_off + (int64_t)(c0 + t) * st + c;
        rr[q] = *reinterpret_cast<const RawT*>(r + o);
        kr[q] = *reinterpret_cast<const RawT*>(k + o);
        vr[q] = *reinterpret_cast<const RawT*>(v + o);
        wr[q] = *reinterpret_cast<const float4*>(
            w + w_off + (int64_t)(c0 + t) * wt + c);
      } else {  // past the end: contributes nothing, decays nothing
        rr[q] = kr[q] = vr[q] = RawT{};
        wr[q] = make_float4(1.f, 1.f, 1.f, 1.f);
      }
    }
  };
  auto store_raw = [&](float* V) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = (tid + q * kThreads) * 4;
      *reinterpret_cast<float4*>(R + e) = to_f4(rr[q]);
      *reinterpret_cast<float4*>(K + e) = to_f4(kr[q]);
      *reinterpret_cast<float4*>(V + e / HS * L::kLdV + e % HS) =
          to_f4(vr[q]);
      *reinterpret_cast<float4*>(Wt + e) = wr[q];
    }
  };

  // a chunk's products of w and the diagonal sub-chunks of A
  auto prep_a = [&](float* RQT, float* KQ, float* AT, float* WC) {
    {
      // products of w outwards from the sub-chunk boundaries, a thread a
      // channel, side and sub-chunk, in token order: r_t from the chunk
      // start (RQT; sub-chunk 1's rp_t, from its own start, also RP1 for
      // A), k_s to the chunk end (KQ; sub-chunk 0's ks_s, to its own end,
      // also KS0). The factor of the other, whole sub-chunk is the same
      // product in the same order as its own thread's. Every load comes
      // first: the chains wait on none.
      const int role = tid / HS, i = tid % HS;
      const int t0 = (role == 0 || role == 3) ? 0 : kSub;
      const float* X = role < 2 ? R : K;
      float x[kSub], wv[kSub], wo[kSub];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        x[q] = X[(t0 + q) * HS + i];
        wv[q] = Wt[(t0 + q) * HS + i];
        wo[q] = role == 1 || role == 3 ? Wt[(kSub - t0 + q) * HS + i] : 1.f;
      }
      float P = 1.f, other = 1.f;
#pragma unroll
      for (int q = 0; q < kSub; ++q) other *= wo[q];
      if (role < 2) {
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          x[q] *= P;
          P *= wv[q];
        }
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (role == 1) RP1[q * L::kLd + i] = x[q];
          RQT[i * L::kLdT + t0 + q] = x[q] * other;
        }
        if (role == 1) WC[i] = other * P;
      } else {
#pragma unroll
        for (int q = kSub - 1; q >= 0; --q) {
          x[q] *= P;
          P *= wv[q];
        }
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          if (role == 3) KS0[q * L::kLd + i] = x[q];
          KQ[(t0 + q) * L::kLdV + i] = x[q] * other;
        }
      }
    }
    // inside each sub-chunk: A[t, s] = sum_i r_t[i] k_s[i] prod(w[s+1 ..
    // t-1])[i], r_t carried backwards; warp w takes rows w and 15 - w of
    // both sub-chunks (15 pairs each)
    for (int p = warp; p < 8; p += kThreads / 32)
      diag_rows<HS>(R, K, Wt, AT, p, lane);
  };

  // sub-chunk 1 against sub-chunk 0, A[t, s] = rp_t . ks_s, a thread an
  // entry; and the bonus A[t, t] = sum_i r_t[i] u[i] k_t[i], 32 rows of
  // HS / 8 slices of 8 channels, summed by a fixed butterfly
  auto prep_b = [&](float* AT) {
    for (int e = tid; e < kSub * kSub; e += kThreads) {
      const int t = e % kSub, sr = e / kSub;
      const float* a = RP1 + t * L::kLd;
      const float* bb = KS0 + sr * L::kLd;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HS; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + i);
        const float4 z = *reinterpret_cast<const float4*>(bb + i);
        d[0] = fmaf(x.x, z.x, d[0]);
        d[1] = fmaf(x.y, z.y, d[1]);
        d[2] = fmaf(x.z, z.z, d[2]);
        d[3] = fmaf(x.w, z.w, d[3]);
      }
      AT[sr * kLdA + kSub + t] = (d[0] + d[1]) + (d[2] + d[3]);
    }
    constexpr int kSlices = HS / 8;  // 32 rows x kSlices = 4 * HS threads
    const int t = tid / kSlices, c = (tid % kSlices) * 8;
    float bonus = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      bonus = fmaf(R[t * HS + c + a] * U[c + a], K[t * HS + c + a], bonus);
    bonus = lane_sum(bonus, kSlices);
    if (tid % kSlices == 0) AT[t * kLdA + t] = bonus;
  };

  // the state step on the tensor cores (m16n8k8, three TF32 products a
  // tile): y = rq S + A v for the group's columns over this warp's keys
  // (and tokens of A v), into Yp; then S <- diag(W) S + kq^T v in the
  // accumulators, and S0p from them
  auto step = [&](const float* RQT, const float* KQ, const float* AT,
                  const float* WC, const float* V) {
    uint32_t vh[kC / 8][kNT][2], vl[kC / 8][kNT][2];  // v: B fragments
#pragma unroll
    for (int q = 0; q < kC / 8; ++q)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        frag_b(V, L::kLdV, 8 * q, col0 + 8 * nt, lane, vh[q][nt], vl[q][nt]);
    {
      float acc[2][kNT][4] = {};
      uint32_t ah[4], al[4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int kt = 0; kt < kRows / 8; ++kt) {
        const int k0 = key0 + 8 * kt;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          frag_b(S0p, L::kLdS, k0, 8 * nt, lane, bh[nt], bl[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          frag_a(RQT, L::kLdT, 16 * mt, k0, lane, ah, al);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma3(acc[mt][nt], ah, al, bh[nt], bl[nt]);
        }
      }
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) {
        if (q / (kTpw / 8) != half) continue;  // static indices into vh, vl
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          frag_a(AT, kLdA, 16 * mt, 8 * q, lane, ah, al);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma3(acc[mt][nt], ah, al, vh[q][nt], vl[q][nt]);
        }
      }
      float* const yp = Yp + half * kC * L::kLdS;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(
                yp + (16 * mt + g8 + 8 * hh) * L::kLdS + 8 * nt + 2 * tig) =
                make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float f0 = WC[key0 + 16 * mt + g8];
      const float f1 = WC[key0 + 16 * mt + g8 + 8];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        S[mt][nt][0] *= f0;
        S[mt][nt][1] *= f0;
        S[mt][nt][2] *= f1;
        S[mt][nt][3] *= f1;
      }
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) {
        frag_a(KQ, L::kLdV, key0 + 16 * mt, 8 * q, lane, ah, al);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma3(S[mt][nt], ah, al, vh[q][nt], vl[q][nt]);
      }
    }
    __syncwarp();  // every lane of the warp is done reading its S0p rows
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              S0p + (key0 + 16 * mt + g8 + 8 * hh) * L::kLdS + 8 * nt +
              2 * tig) = make_float2(S[mt][nt][2 * hh], S[mt][nt][2 * hh + 1]);
  };

  const int64_t y_st = (int64_t)H * HS;
  T* const yb = y + (int64_t)b * n_tok * y_st + (int64_t)h * HS;
  // warp half h writes tokens h * kTpw .. of y, its group's columns: a
  // lane 8 columns of one token, the halves' sums added in order
  auto write_y = [&](int c0) {
    constexpr int kLpt = 32 / kTpw;  // lanes a token
    const int t = half * kTpw + lane / kLpt, c = (lane % kLpt) * 8;
    if (c0 + t < n_tok) {
      T* const dst = yb + (int64_t)(c0 + t) * y_st + col0 + c;
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        float2 a = *reinterpret_cast<const float2*>(Yp + t * L::kLdS + c + q);
#pragma unroll
        for (int hh = 1; hh < kHalves; ++hh) {
          const float2 z = *reinterpret_cast<const float2*>(
              Yp + (hh * kC + t) * L::kLdS + c + q);
          a.x += z.x;
          a.y += z.y;
        }
        store2(dst + q, a.x, a.y);
      }
    }
  };

  // chunk c's state step runs beside chunk c + 1's preparation, which does
  // not depend on the state: copy (c & 1) of V, RQT, KQ, AT, WC is chunk c's
  auto V_ = [&](int c) { return sm + L::V + (c & 1) * L::kV; };
  auto RQT_ = [&](int c) { return sm + L::RQT + (c & 1) * L::kRQT; };
  auto KQ_ = [&](int c) { return sm + L::KQ + (c & 1) * L::kV; };
  auto AT_ = [&](int c) { return sm + L::AT + (c & 1) * L::kAT; };
  auto WC_ = [&](int c) { return sm + L::WC + (c & 1) * L::kWC; };
  fetch(0);
  __syncthreads();  // U, AT's zeros
  store_raw(V_(0));
  if (kC < n_tok) fetch(kC);
  __syncthreads();
  prep_a(RQT_(0), KQ_(0), AT_(0), WC_(0));
  __syncthreads();
  prep_b(AT_(0));
  for (int c = 0, c0 = 0; c0 < n_tok; ++c, c0 += kC) {
    const bool next = c0 + kC < n_tok;
    __syncthreads();  // chunk c is prepared; R, K, Wt, Yp are free
    if (next) {
      store_raw(V_(c + 1));
      if (c0 + 2 * kC < n_tok) fetch(c0 + 2 * kC);  // in flight a chunk
    }
    __syncthreads();
    if (next) prep_a(RQT_(c + 1), KQ_(c + 1), AT_(c + 1), WC_(c + 1));
    step(RQT_(c), KQ_(c), AT_(c), WC_(c), V_(c));
    __syncthreads();  // both halves of y are in Yp; RP1, KS0 are written
    if (next) prep_b(AT_(c + 1));
    write_y(c0);
  }

  float* const p = s1 + (int64_t)bh * HS * HS;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            p + (key0 + 16 * mt + g8 + 8 * hh) * HS + col0 + 8 * nt +
            2 * tig) = make_float2(S[mt][nt][2 * hh], S[mt][nt][2 * hh + 1]);
}

template <int HS, typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s1, int B, int H, int n_tok, int64_t sb, int64_t st,
                   int64_t sh, int64_t wb, int64_t wt, int64_t wh,
                   cudaStream_t s) {
  constexpr size_t kBytes = Smem<HS>::kFloats * sizeof(float);
  auto kernel = wkv6_kernel<HS, T>;
  static bool opted[64] = {};  // a device at a time, once
  int dev = 0;
  if (kBytes > 48 * 1024 && cudaGetDevice(&dev) == cudaSuccess &&
      (dev >= 64 || !opted[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = true;
  }
  kernel<<<B * H, 4 * HS, kBytes, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s1), H, n_tok, sb, st, sh, wb,
      wt, wh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v: [B, T, H, hs] float32 (bf16 != 0: bfloat16), element strides
// (sb, st, sh) and a contiguous last axis; w: [B, T, H, hs] float32 with
// strides (wb, wt, wh); u: [H, hs] f32; s0: [B, H, hs, hs] f32; y: [B, T, H,
// hs] contiguous in r's type; s1: [B, H, hs, hs] f32. hs is 16 or 64; every
// stride and base address a multiple of 4 elements, T >= 1. Returns
// cudaErrorInvalidValue otherwise, else cudaGetLastError().
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s1, int B, int H,
               int n_tok, int hs, int bf16, int64_t sb, int64_t st,
               int64_t sh, int64_t wb, int64_t wt, int64_t wh, void* stream) {
  const uintptr_t vec = bf16 ? 8 : 16;
  const uintptr_t a = reinterpret_cast<uintptr_t>(r) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v);
  if ((hs != 16 && hs != 64) || n_tok < 1 || a % vec ||
      reinterpret_cast<uintptr_t>(w) % 16 || (sb | st | sh | wb | wt | wh) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_WKV6(HS, T) \
  launch<HS, T>(r, k, v, w, u, s0, y, s1, B, H, n_tok, sb, st, sh, wb, wt, \
                wh, s)
  if (hs == 64)
    err = bf16 ? REPRO_WKV6(64, __nv_bfloat16) : REPRO_WKV6(64, float);
  else
    err = bf16 ? REPRO_WKV6(16, __nv_bfloat16) : REPRO_WKV6(16, float);
#undef REPRO_WKV6
  return static_cast<int>(err);
}

}  // extern "C"
