// Fused activation term-reveal + matmul on Hopper, f32 mode:
//   out = tr_quantize(x, sf, bits, 1, budget) @ w * w_sf
//
// Replaces the Pallas kernel tq_tpu/kernels/term_matmul.py::term_matmul
// (bodies _body / _body_pipe, activation tile _tr_tile(apply_sf=True)) in
// its f32 mode with float32 weights.
//
// Bound on the card: at the MLP's shapes (M = 128, K <= 784, N <= 512) the
// product is 2*M*K*N float32 operations on CUDA cores (the f32 mode
// promises full float32, so no TF32 tensor cores) against a few MB of
// traffic: operations bound on paper, and at these sizes the latency of a
// block's serial walk over K costs more than the arithmetic.  Design: a
// plain tiled shared-memory SGEMM, 64x64 output tiles, a K step of 16, 256
// threads each holding a 4x4 block of accumulators.  Each activation tile
// is term-revealed while it is loaded into shared memory (the same
// sign * kept * sf the element-wise kernel writes), so the quantized
// activations never reach device memory.  FFMA accumulation in float32.
// A small M*N gives few output tiles, so K is split over blockIdx.z: each
// split writes its partial tile to a workspace and a second kernel sums the
// splits in a fixed order and applies the epilogue * w_sf (deterministic;
// with one split the tile kernel writes the output itself).  The ragged M,
// N and K edges are masked here.  wgmma, TMA and the bf16/int8 modes are
// later work.

#include "tr_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 block of outputs
constexpr int kPad = 4;        // keeps the transposed A tile 16-byte aligned

__global__ void __launch_bounds__(kThreads)
term_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ sf_ptr, float* __restrict__ out,
                       int M, int N, int K, int bits, int budget, float scale,
                       int k_per_split) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];  // quantized x, k-major
  __shared__ __align__(16) float Bs[kBK][kBN];

  const float sf = *sf_ptr;
  const float maxq = static_cast<float>((1u << bits) - 1u);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  out += static_cast<int64_t>(blockIdx.z) * M * N;  // this split's tile

  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // A tile: 64 rows x 16 k; neighbouring threads read neighbouring k.
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = e % kBK;
      const int gm = row0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < k_end) {
        const float xv = x[static_cast<int64_t>(gm) * K + gk];
        v = tq::dequantize(xv, tq::keep_terms(tq::quantize(xv, sf, maxq),
                                              budget, false), sf);
      }
      As[k][m] = v;
    }
    // B tile: 16 k x 64 columns; neighbouring threads read neighbouring n.
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < k_end && gn < N) ? w[static_cast<int64_t>(gk) * N + gn]
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = row0 + ty * 4 + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = col0 + tx * 4 + c;
      if (gn < N) out[static_cast<int64_t>(gm) * N + gn] = acc[r][c] * scale;
    }
  }
}

// out[i] = w_sf * (sum over the splits of ws[split][i]), splits in order.
__global__ void split_k_sum_kernel(const float* __restrict__ ws,
                                   float* __restrict__ out, int64_t mn,
                                   int splits, float w_sf) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  out[i] = s * w_sf;
}

}  // namespace

// ws: (splits, M, N) float32 scratch, unused (may be null) when splits == 1.
extern "C" int tq_term_matmul_f32(const float* x, const float* w,
                                  const float* sf, float* out, float* ws,
                                  int M, int N, int K, int bits, int budget,
                                  float w_sf, int splits, int k_per_split,
                                  cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  if (splits == 1) {
    term_matmul_f32_kernel<<<grid, kThreads, 0, stream>>>(
        x, w, sf, out, M, N, K, bits, budget, w_sf, k_per_split);
  } else {
    term_matmul_f32_kernel<<<grid, kThreads, 0, stream>>>(
        x, w, sf, ws, M, N, K, bits, budget, 1.f, k_per_split);
    const int64_t mn = static_cast<int64_t>(M) * N;
    split_k_sum_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                         stream>>>(ws, out, mn, splits, w_sf);
  }
  return static_cast<int>(cudaGetLastError());
}
