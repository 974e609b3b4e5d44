// Fused activation term-reveal + matmul on Hopper, every mode of the TPU
// kernel:
//   out = acc(xa @ wa) * epilogue
//
// Replaces the Pallas kernel tq_tpu/kernels/term_matmul.py::term_matmul
// (bodies _body / _body_pipe; activation tile _tr_tile; weight tile
// _load_w, _decode_packed and _widen_w; MAC _mac_into).  The activation
// tile xa is
//   * f32 mode:  tr_quantize(x, sf, bits, 1, budget), sign * kept * sf;
//   * bf16 mode: the signed integer sign * kept, rounded to bfloat16;
//   * int8 mode: sign * kept as an integer (bits <= 7);
//   * raw input (quantize_x = 0): x itself (bf16 mode: rounded to bf16).
// The weight tile wa is float32, bf16-stored, int8, int16 or the 9-bit
// pack (magnitude lo + 128, sign bit k & 7 of sign row k / 8), widened as
// it is loaded into shared memory (bf16 mode then rounds it to bfloat16),
// so decoded weights never reach device memory.  The MAC is a float32 FMA
// in the f32 and bf16 modes (a product of two bfloat16 values is exact in
// float32) and an int32 multiply-add in the int8 mode (exact).  The
// epilogue is w_sf in the f32 mode and sf * w_sf in the bf16 and int8
// modes (sf = 1 for raw input), as the TPU kernel's sf_arr.
//
// Bound on the card: at the serving shapes (M = 1 token, K = 650,
// N = 2600 or 33278) the product streams the weights once and does 2 * K
// operations per weight: bytes bound (the 9-bit pack at 1.125 bytes per
// weight, int8 at 1, int16 at 2, float32 at 4).  At the eval shapes
// (M = 128..350) the f32 mode is operations bound on CUDA cores.
// Design: a plain tiled shared-memory GEMM on CUDA cores, 64x64 output
// tiles, a K step of 16, 256 threads each holding a 4x4 block of
// accumulators; the ragged M, N and K edges are masked here (packed
// weights have K8 >= K rows; the rows past K meet no activation, as the
// TPU kernel's zero-padded x).  A small M*N gives few output tiles, so K
// is split over blockIdx.z: each split writes its partial tile to a
// workspace (int32 in the int8 mode, so the sum stays exact) and a second
// kernel sums the splits in a fixed order and applies the epilogue
// (deterministic; with one split the tile kernel writes the output
// itself).  At M = 1 a 64-row tile leaves 63 rows idle and each weight
// byte is read by a 16-wide K step: right, not fast.  Tensor cores
// (mma.sync / wgmma for the bf16 and int8 modes), TMA and a small-M
// weight-streaming layout are later work.

#include <cuda_bf16.h>

#include <type_traits>

#include "tr_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 block of outputs
constexpr int kPad = 4;        // keeps the transposed A tile 16-byte aligned

// Multiply-accumulate policy (the TPU kernel's `mxu`); the wrapper's codes.
enum Mode : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };
// Weight storage; the wrapper's codes.
enum WFmt : int { kWF32 = 0, kWBF16 = 1, kWInt8 = 2, kWInt16 = 3,
                  kWPacked8 = 4 };

// Shared-memory tile element and accumulator of each mode.
template <int MODE>
using Tile = std::conditional_t<MODE == kInt8, int32_t, float>;
template <typename T>
using Vec4 = std::conditional_t<std::is_same_v<T, float>, float4, int4>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Weight (k, n) as stored: its value for float weights, q for integer and
// packed weights (w_sf is in the epilogue).  Exact in float32.
template <int F>
__device__ __forceinline__ float weight_value(const void* w,
                                              const int8_t* signs, int k,
                                              int n, int N) {
  const int64_t i = static_cast<int64_t>(k) * N + n;
  if constexpr (F == kWF32) {
    return static_cast<const float*>(w)[i];
  } else if constexpr (F == kWBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else if constexpr (F == kWInt8) {
    return static_cast<float>(static_cast<const int8_t*>(w)[i]);
  } else if constexpr (F == kWInt16) {
    return static_cast<float>(static_cast<const int16_t*>(w)[i]);
  } else {  // 9-bit pack
    const float mag =
        static_cast<float>(static_cast<const int8_t*>(w)[i]) + 128.f;
    const int plane = signs[static_cast<int64_t>(k >> 3) * N + n];
    return ((plane >> (k & 7)) & 1) ? -mag : mag;
  }
}

template <int MODE, int F>
__device__ __forceinline__ Tile<MODE> weight_tile(const void* w,
                                                  const int8_t* signs, int k,
                                                  int n, int N) {
  const float v = weight_value<F>(w, signs, k, n, N);
  if constexpr (MODE == kF32) return v;
  else if constexpr (MODE == kBF16) return round_bf16(v);
  else return static_cast<int32_t>(v);  // int8 weights: exact
}

template <int MODE, bool QX>
__device__ __forceinline__ Tile<MODE> act_tile(float xv, float sf, float maxq,
                                               int budget) {
  if constexpr (!QX) {
    static_assert(MODE != kInt8, "int8 mode needs quantized activations");
    if constexpr (MODE == kBF16) return round_bf16(xv);
    else return xv;
  } else {
    const int32_t v =
        tq::keep_terms(tq::quantize(xv, sf, maxq), budget, false);
    if constexpr (MODE == kF32) {
      return tq::dequantize(xv, v, sf);
    } else if constexpr (MODE == kBF16) {
      const float s = static_cast<float>(v);
      return round_bf16(xv < 0.f ? -s : s);
    } else {
      return xv < 0.f ? -v : v;
    }
  }
}

// w_sf in the f32 mode, sf * w_sf otherwise (sf = 1 for raw input).
template <int MODE, bool QX>
__device__ __forceinline__ float epilogue_scale(const float* sf_ptr,
                                                const float* wsf_ptr) {
  const float wsf = wsf_ptr != nullptr ? *wsf_ptr : 1.f;
  if constexpr (MODE == kF32) return wsf;
  else return __fmul_rn(QX ? *sf_ptr : 1.f, wsf);
}

// ws == nullptr: write acc * epilogue to out; else this split's partial
// sums to ws[blockIdx.z].
template <int MODE, int F, bool QX>
__global__ void __launch_bounds__(kThreads)
term_matmul_kernel(const float* __restrict__ x, const void* __restrict__ w,
                   const int8_t* __restrict__ signs,
                   const float* __restrict__ sf_ptr,
                   const float* __restrict__ wsf_ptr, float* __restrict__ out,
                   Tile<MODE>* __restrict__ ws, int M, int N, int K, int bits,
                   int budget, int k_per_split) {
  using T = Tile<MODE>;
  __shared__ __align__(16) T As[kBK][kBM + kPad];  // activations, k-major
  __shared__ __align__(16) T Bs[kBK][kBN];

  const float sf = QX ? *sf_ptr : 1.f;
  const float maxq = QX ? static_cast<float>((1u << bits) - 1u) : 0.f;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  T acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // A tile: 64 rows x 16 k; neighbouring threads read neighbouring k.
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = e % kBK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < k_end)
                     ? act_tile<MODE, QX>(x[static_cast<int64_t>(gm) * K + gk],
                                          sf, maxq, budget)
                     : T(0);
    }
    // B tile: 16 k x 64 columns; neighbouring threads read neighbouring n.
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < k_end && gn < N)
                     ? weight_tile<MODE, F>(w, signs, gk, gn, N)
                     : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const Vec4<T> a = *reinterpret_cast<const Vec4<T>*>(&As[k][ty * 4]);
      const Vec4<T> b = *reinterpret_cast<const Vec4<T>*>(&Bs[k][tx * 4]);
      const T av[4] = {a.x, a.y, a.z, a.w};
      const T bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (MODE == kInt8) acc[r][c] += av[r] * bv[c];
          else acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
    }
    __syncthreads();
  }

  const float scale =
      ws == nullptr ? epilogue_scale<MODE, QX>(sf_ptr, wsf_ptr) : 1.f;
  if (ws != nullptr) ws += static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = row0 + ty * 4 + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = col0 + tx * 4 + c;
      if (gn >= N) continue;
      const int64_t i = static_cast<int64_t>(gm) * N + gn;
      if (ws != nullptr) ws[i] = acc[r][c];
      else out[i] = __fmul_rn(static_cast<float>(acc[r][c]), scale);
    }
  }
}

// out[i] = epilogue * (sum over the splits of ws[split][i]), splits in
// order (an int32 sum in the int8 mode: exact).
template <int MODE, bool QX>
__global__ void split_k_sum_kernel(const Tile<MODE>* __restrict__ ws,
                                   float* __restrict__ out, int64_t mn,
                                   int splits,
                                   const float* __restrict__ sf_ptr,
                                   const float* __restrict__ wsf_ptr) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= mn) return;
  Tile<MODE> s = 0;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  out[i] = __fmul_rn(static_cast<float>(s),
                     epilogue_scale<MODE, QX>(sf_ptr, wsf_ptr));
}

struct Args {
  const float* x;
  const void* w;
  const int8_t* signs;
  const float* sf;
  const float* w_sf;
  float* out;
  void* ws;
  int M, N, K, bits, budget, splits, k_per_split;
};

template <int MODE, int F, bool QX>
void launch(const Args& a, cudaStream_t stream) {
  using T = Tile<MODE>;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, a.splits);
  T* ws = a.splits > 1 ? static_cast<T*>(a.ws) : nullptr;
  term_matmul_kernel<MODE, F, QX><<<grid, kThreads, 0, stream>>>(
      a.x, a.w, a.signs, a.sf, a.w_sf, a.out, ws, a.M, a.N, a.K, a.bits,
      a.budget, a.k_per_split);
  if (ws != nullptr) {
    const int64_t mn = static_cast<int64_t>(a.M) * a.N;
    split_k_sum_kernel<MODE, QX>
        <<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
            ws, a.out, mn, a.splits, a.sf, a.w_sf);
  }
}

template <int MODE, bool QX>
bool launch_format(int wfmt, const Args& a, cudaStream_t stream) {
  switch (wfmt) {
    case kWF32: launch<MODE, kWF32, QX>(a, stream); return true;
    case kWBF16: launch<MODE, kWBF16, QX>(a, stream); return true;
    case kWInt8: launch<MODE, kWInt8, QX>(a, stream); return true;
    case kWInt16: launch<MODE, kWInt16, QX>(a, stream); return true;
    case kWPacked8: launch<MODE, kWPacked8, QX>(a, stream); return true;
    default: return false;
  }
}

}  // namespace

// mode: 0 f32, 1 bf16, 2 int8.  wfmt: 0 float32, 1 bfloat16, 2 int8,
// 3 int16, 4 9-bit pack (w = lo, signs = the sign plane; else signs may be
// null).  sf: the activation scale (read only when quantize_x); w_sf: the
// weight scale or null for 1.  ws: (splits, M, N) float32 (int32 in the
// int8 mode) scratch, unused (may be null) when splits == 1.  Only the
// combinations term_matmul admits launch: the int8 mode takes int8
// weights and quantized activations; anything else returns
// cudaErrorInvalidValue.
extern "C" int tq_term_matmul(const float* x, const void* w,
                              const int8_t* signs, const float* sf,
                              const float* w_sf, float* out, void* ws, int M,
                              int N, int K, int bits, int budget, int mode,
                              int wfmt, int quantize_x, int splits,
                              int k_per_split, cudaStream_t stream) {
  const Args a{x, w, signs, sf, w_sf, out, ws, M, N, K, bits, budget, splits,
               k_per_split};
  bool ok = false;
  if (mode == kF32) {
    ok = quantize_x ? launch_format<kF32, true>(wfmt, a, stream)
                    : launch_format<kF32, false>(wfmt, a, stream);
  } else if (mode == kBF16) {
    ok = quantize_x ? launch_format<kBF16, true>(wfmt, a, stream)
                    : launch_format<kBF16, false>(wfmt, a, stream);
  } else if (mode == kInt8 && wfmt == kWInt8 && quantize_x) {
    launch<kInt8, kWInt8, true>(a, stream);
    ok = true;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
