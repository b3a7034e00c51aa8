// Fused int8 weighted sum: out[n] = sum_m w[m] * s[m, n / 1024] * q[m, n].
//
// Replaces the Pallas kernel src/repro/kernels/q8agg.py:51 (wsum_q8, body
// _wsum_kernel :39), the cross-silo merge of int8 peer models. The f32
// [M, N] matrix of dequantized models is never built.
//
// Bound: memory. It reads M*N int8 codes, M*N/1024 scales and writes N
// floats: M*N + 4*M*N/1024 + 4*N bytes. One block owns one 1024-wide
// quantization tile: it folds ws[m] = w[m] * s[m, tile] into shared memory
// once (the same f32 product the reference forms), then each of 256 threads
// streams 4 codes per model as one char4 and accumulates 4 outputs in
// registers. Offsets are 64-bit: M*N reaches 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
