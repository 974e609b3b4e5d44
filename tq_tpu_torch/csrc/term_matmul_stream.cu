// term_matmul at small M, every mode of the TPU kernel, in one
// weight-streaming kernel:
//   out = acc(xa @ wa) * epilogue
//
// Replaces the Pallas kernel tq_tpu/kernels/term_matmul.py::term_matmul
// (bodies _body / _body_pipe; activation tile _tr_tile; weight tile
// _load_w, _decode_packed and _widen_w; MAC _mac_into) for M <=
// STREAM_MAX_M.  The activation tile xa is
//   * f32 mode:  tr_quantize(x, sf, bits, 1, budget), sign * kept * sf;
//   * bf16 mode: the signed integer sign * kept, rounded to bfloat16;
//   * int8 mode: sign * kept as an integer (bits <= 7), +128 saturated
//     to 127 as the TPU kernel's int8 cast saturates it;
//   * raw input (quantize_x = 0): x itself (bf16 mode: rounded to bf16).
// The weight wa is float32, bf16-stored, int8, int16 or the 9-bit pack
// (magnitude lo + 128, sign bit k & 7 of sign row k / 8): w as stored,
// or q of integer and packed weights (w_sf is in the epilogue), exact in
// float32, widened in registers as it is loaded (the bf16 mode then
// rounds it to bfloat16), so decoded weights never reach device memory.
// The MAC is a float32 FMA in the f32 and bf16 modes (a product of two
// bfloat16 values is exact in float32) and an int32 multiply-add in the
// int8 mode (exact).  The epilogue is w_sf in the f32 mode and sf * w_sf
// in the bf16 and int8 modes (sf = 1 for raw input), as the TPU kernel's
// sf_arr.
//
// One of four term_matmul kernels, one a file.  The wrapper (plan() in
// kernels/term_matmul.py) takes this one for M <= STREAM_MAX_M; above it
// the tensor cores take the f32 mode (csrc/term_matmul_mma.cu) and the
// bf16 and int8 modes (csrc/term_matmul_mma_lp.cu).  The MoE layer's
// experts run this kernel's arithmetic, all of them in one launch
// (csrc/term_matmul_grouped.cu).
//
// Bound on the card: at the serving shapes (M = 1 token, K = 650,
// N = 2600 or 33278) the product streams the weights once and does 2 * M
// operations per weight: bytes bound (the 9-bit pack at 1.125 bytes per
// weight, int8 at 1, int16 at 2, float32 at 4).
//
// Design: every weight byte is read once, with 16-byte loads that skip L1,
// and a thread owns a run of 16 bytes of consecutive columns (16 int8 or
// 9-bit-pack columns, 8 int16 or bf16, 4 float32).  A block is 4 warps
// over one strip of columns; they split its K range in groups of 8 rows
// (one sign-plane byte serves a pack's 8 rows), each warp keeping its next
// group in flight in registers while it multiplies the current one, and
// the block sums their partials through shared memory in warp order.  Rows
// of N = 33278 elements start at any even byte offset, and a 16-byte load
// must be aligned, so each lane loads its aligned 16-byte chunk, takes its
// right neighbour's with a warp shuffle and shifts the pair by the row's
// offset (the same for every lane of the warp); lane 31 only loads, so a
// strip is 31 lanes wide.  Bytes are widened without int-to-float
// conversions: a byte or half word is placed under the exponent of 2^23
// (__byte_perm) and 2^23 subtracted; the pack's sign is XOR-ed into bit
// 31.  The activation rows (1 row a block for M = 1, else 8, rows past M
// masked to zero; larger M takes several row groups) are term-revealed
// once per block into shared memory.  Where the strips are too few to fill
// the card, K is split over the blocks of a thread-block cluster (up to
// 8): each block stores the partial sums of each slice of the strip into
// the shared memory of the block that owns the slice (distributed shared
// memory), and after one cluster barrier every block sums its slice over
// the blocks in rank order and applies the epilogue.  One launch, no
// workspace, no atomics and no state kept between calls, so the sums are
// deterministic and the launch can be captured in a CUDA graph.  Measured
// on an H100 at the decoder shape, it streams at about half the HBM rate
// (PERF.md): the realignment and widening (about 4.6 instructions a
// weight, most on the integer pipe) and a per-block chain of about 3 us
// (activations, barriers, cluster sum) hold it there.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "cluster_sum.cuh"
#include "tr_common.cuh"

namespace {

// Multiply-accumulate policy (the TPU kernel's `mxu`); the wrapper's codes.
enum Mode : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };
// Weight storage; the wrapper's codes.
enum WFmt : int { kWF32 = 0, kWBF16 = 1, kWInt8 = 2, kWInt16 = 3,
                  kWPacked8 = 4 };

// Activation and accumulator type of each mode.
template <int MODE>
using Tile = std::conditional_t<MODE == kInt8, int32_t, float>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An activation as the product takes it (xa above).
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
    } else {  // +128 (one term of q >= 96) saturates, as an int8 cast
      return xv < 0.f ? -v : min(v, 127);
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

// ------------------------------------------------ weight-streaming kernel

constexpr int kSThreads = 128;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSLanes = 31;   // lanes that own columns; lane 31 only loads
constexpr int kSGroup = 8;    // weight rows a warp takes per step
constexpr int kSChunk = 512;  // activation rows staged in shared memory

template <int F>
constexpr int kElemBytes =
    F == kWF32 ? 4 : (F == kWBF16 || F == kWInt16) ? 2 : 1;
template <int F>
constexpr int kCols = 16 / kElemBytes<F>;  // columns a lane owns

// 16 bytes at p (16-byte aligned), read once: not kept in L1.
__device__ __forceinline__ uint4 ld_stream(const char* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Bytes r .. r + 15 of the 32 bytes a, b (a first, little-endian).
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int r) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const uint32_t s = (r & 3) * 8;
  const int q = r >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(
      __funnelshift_r(v[0], v[1], s), __funnelshift_r(v[1], v[2], s),
      __funnelshift_r(v[2], v[3], s), __funnelshift_r(v[3], v[4], s));
}

// This lane's 16 bytes of a row that starts r bytes past a 16-byte
// boundary (r is the same on every lane), from its aligned chunk `own`
// and the next lane's.  Every lane of the warp calls it.
__device__ __forceinline__ uint4 lane_bytes(uint4 own, int r) {
  uint4 next;  // no branch on r: the shuffles stay convergent
  next.x = __shfl_down_sync(0xffffffffu, own.x, 1);
  next.y = __shfl_down_sync(0xffffffffu, own.y, 1);
  next.z = __shfl_down_sync(0xffffffffu, own.z, 1);
  next.w = __shfl_down_sync(0xffffffffu, own.w, 1);
  return realign(own, next, r);
}

// Byte b of u under the exponent of 2^23: the float 2^23 + byte.
__device__ __forceinline__ float magic_byte(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b));
}

// a and b rounded to bfloat16 as round_bf16 does, in one conversion.
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  a = __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(p.x))
                      << 16);
  b = __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(p.y))
                      << 16);
}

// One weight row's 16 bytes under a lane (kCols<F> columns) as the
// product takes them: w, or q of integer and packed weights; rounded
// to bfloat16 in the bf16 mode (int8 and 9-bit magnitudes are exact in
// bfloat16); int32 in the int8 mode.  sgn: the pack's sign bytes of the
// same columns; i: the row within its group of 8.
template <int MODE, int F>
__device__ __forceinline__ void widen(uint4 v, uint4 sgn, int i,
                                      Tile<MODE> (&out)[kCols<F>]) {
  const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
  const uint32_t sd[4] = {sgn.x, sgn.y, sgn.z, sgn.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (F == kWF32) {
      out[j] = __uint_as_float(wd[j]);
    } else if constexpr (F == kWBF16) {
      out[2 * j] = __uint_as_float(wd[j] << 16);
      out[2 * j + 1] = __uint_as_float(wd[j] & 0xffff0000u);
    } else if constexpr (F == kWInt16) {
      const uint32_t u = wd[j] ^ 0x80008000u;  // q + 32768 in each half
      out[2 * j] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7410)) - 8421376.f;
      out[2 * j + 1] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7432)) - 8421376.f;
    } else if constexpr (F == kWInt8 && MODE == kInt8) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * j + b] = static_cast<int32_t>(wd[j] << (24 - 8 * b)) >> 24;
    } else if constexpr (F == kWInt8) {
      const uint32_t u = wd[j] ^ 0x80808080u;  // q + 128 in each byte
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * j + b] = magic_byte(u, b) - 8388736.f;
    } else {  // 9-bit pack: lo + 128 = |q|; sign bit i of the sign byte
      const uint32_t u = wd[j] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float mag = magic_byte(u, b) - 8388608.f;
        const uint32_t neg = (sd[j] << (31 - 8 * b - i)) & 0x80000000u;
        out[4 * j + b] = __uint_as_float(__float_as_uint(mag) ^ neg);
      }
    }
  }
  if constexpr (MODE == kBF16 && (F == kWF32 || F == kWInt16)) {
#pragma unroll
    for (int c = 0; c < kCols<F>; c += 2) round_bf16_pair(out[c], out[c + 1]);
  }
}

// The 16-byte boundary at or before p.
__device__ __forceinline__ const char* align16(const char* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                       ~static_cast<uintptr_t>(15));
}

// This lane's aligned 16-byte chunks of 8 weight rows, `row` being the
// lane's first byte in the first of them; zeros for rows past the first
// `rows` and for chunks past a row's end.  `full` (the same on every lane):
// all 8 rows exist and no lane's chunk passes a row's end.  For the pack,
// also the chunk of the sign row whose lane byte is `srow`.
template <int F>
__device__ __forceinline__ void load_group(const char* row, int64_t row_bytes,
                                           bool full, int64_t col_byte,
                                           int rows, const char* srow,
                                           uint4 (&raw)[kSGroup],
                                           uint4& sgn) {
  if (full) {
#pragma unroll
    for (int i = 0; i < kSGroup; ++i)
      raw[i] = ld_stream(align16(row + i * row_bytes));
    if constexpr (F == kWPacked8) sgn = ld_stream(align16(srow));
    return;
  }
#pragma unroll
  for (int i = 0; i < kSGroup; ++i) {
    const char* r = row + i * row_bytes;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(r) & 15);
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    if (i < rows && col_byte - off < row_bytes) raw[i] = ld_stream(r - off);
  }
  if constexpr (F == kWPacked8) {
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(srow) & 15);
    sgn = make_uint4(0u, 0u, 0u, 0u);
    if (rows > 0 && col_byte - off < row_bytes) sgn = ld_stream(srow - off);
  }
}

// Block (strip, rank) of a cluster of `splits` (<= 8) along x, row group
// blockIdx.y: rows row0 .. row0 + MT - 1 of x, the strip's kSLanes *
// kCols<F> columns, K rows [rank * k_per_split, + k_per_split).  Each
// warp keeps its next group of 8 rows in flight while it multiplies the
// current one; a chunk's first group is in flight while the block
// term-reveals the chunk's activations.
template <int MODE, int F, int MT>
__global__ void __launch_bounds__(kSThreads, MT == 1 ? 4 : 2)
term_matmul_stream_kernel(const float* __restrict__ x,
                          const char* __restrict__ w,
                          const char* __restrict__ signs,
                          const float* __restrict__ sf_ptr,
                          const float* __restrict__ wsf_ptr,
                          float* __restrict__ out, int M, int N, int K,
                          int bits, int budget, int qx, int splits,
                          int k_per_split) {
  using T = Tile<MODE>;
  constexpr int C = kCols<F>;
  constexpr int SC = kSLanes * C;  // a strip's columns
  constexpr int kStage = kSChunk * MT > kSWarps * 32 * C
                             ? kSChunk * MT : kSWarps * 32 * C;
  // The activations of a K chunk ([k][m]); then the warps' partials.
  __shared__ __align__(16) T stage[kStage];
  // This block's slice of the strip's partial sums, one row per block of
  // the cluster (splits * L <= MT * SC + 7 entries).
  __shared__ __align__(16) T part[MT * SC + 8];

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  // Arrive now, wait before the first write to another block's shared
  // memory: every block of the cluster has started by then.
  tq::cluster_arrive();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % splits, strip = blockIdx.x / splits;
  const int row0 = blockIdx.y * MT;
  const int kb = rank * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int64_t row_bytes = static_cast<int64_t>(N) * kElemBytes<F>;
  const int64_t col_byte =
      (static_cast<int64_t>(strip) * SC + lane * C) * kElemBytes<F>;
  const float sf = qx ? *sf_ptr : 1.f;
  const float maxq = qx ? static_cast<float>((1u << bits) - 1u) : 0.f;
  const float scale = qx ? epilogue_scale<MODE, true>(sf_ptr, wsf_ptr)
                         : epilogue_scale<MODE, false>(sf_ptr, wsf_ptr);
  // The lane's first byte of row 0 and of sign row 0.  Row k starts
  // (w_lo + k * row_lo) & 15 bytes past a 16-byte boundary, sign row j
  // (s_lo + j * row_lo) & 15 (mod-16 arithmetic: wrap-around is harmless).
  const char* lane_w = w + col_byte;
  const char* lane_s = signs + col_byte;
  const unsigned w_lo =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(w));
  const unsigned s_lo =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(signs));
  const unsigned row_lo = static_cast<unsigned>(row_bytes);
  // No lane's chunk passes a row's end (every strip but the last).
  const bool inside =
      (static_cast<int64_t>(strip) * SC + 32 * C) * kElemBytes<F> <=
      row_bytes;
  auto load = [&](int kg, int c1, uint4 (&raw)[kSGroup], uint4& sgn) {
    load_group<F>(lane_w + static_cast<int64_t>(kg) * row_bytes, row_bytes,
                  inside && c1 - kg >= kSGroup, col_byte, c1 - kg,
                  lane_s + static_cast<int64_t>(kg / kSGroup) * N, raw, sgn);
  };
  T acc[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = T(0);
  // Multiply-accumulate the group of rows from kg (g rows into the chunk).
  auto mac = [&](int kg, int g, const uint4 (&raw)[kSGroup], uint4 sgn) {
    if constexpr (F == kWPacked8)
      sgn = lane_bytes(sgn, (s_lo + static_cast<unsigned>(kg / kSGroup) *
                                        row_lo) & 15);
    const T* xs = stage + g * MT;
    const unsigned off0 = w_lo + static_cast<unsigned>(kg) * row_lo;
#pragma unroll
    for (int i = 0; i < kSGroup; ++i) {
      T wv[C];
      widen<MODE, F>(lane_bytes(raw[i], (off0 + i * row_lo) & 15), sgn, i,
                     wv);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const T a = xs[i * MT + m];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (MODE == kInt8) acc[m][c] += a * wv[c];
          else acc[m][c] = fmaf(a, wv[c], acc[m][c]);
        }
      }
    }
  };

  for (int c0 = kb; c0 < ke; c0 += kSChunk) {
    const int c1 = min(ke, c0 + kSChunk);
    const int rows = (c1 - c0 + kSGroup - 1) / kSGroup * kSGroup;
    constexpr int kStep = kSWarps * kSGroup;  // rows between a warp's groups
    int g = warp * kSGroup;
    uint4 a[kSGroup], b[kSGroup], sa, sb;  // this group and the next
    load(c0 + g, c1, a, sa);
    // Rows past c1 (the pack's padding) meet a zero activation.
    for (int k = threadIdx.x; k < rows; k += kSThreads) {
      const int gk = c0 + k;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        T v = T(0);
        if (gk < c1 && row0 + m < M) {
          const float xv = x[static_cast<int64_t>(row0 + m) * K + gk];
          if constexpr (MODE == kInt8) v = act_tile<kInt8, true>(xv, sf, maxq,
                                                                  budget);
          else v = qx ? act_tile<MODE, true>(xv, sf, maxq, budget)
                      : act_tile<MODE, false>(xv, sf, maxq, budget);
        }
        stage[k * MT + m] = v;
      }
    }
    __syncthreads();
    for (; g < rows; g += 2 * kStep) {  // zeros are loaded past the chunk
      load(c0 + g + kStep, c1, b, sb);
      mac(c0 + g, g, a, sa);
      if (g + kStep >= rows) break;
      load(c0 + g + 2 * kStep, c1, a, sa);
      mac(c0 + g + kStep, g + kStep, b, sb);
    }
    __syncthreads();
  }

  // The block's sums, warp by warp in order, one row of x at a time, each
  // sent to the block of the cluster that owns its slice of the strip
  // (rank r owns entries [r * L, (r + 1) * L) of the MT x SC partials).
  const int L = tq::slice_len(MT * SC, splits);
  tq::cluster_wait();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < C; ++c) stage[threadIdx.x * C + c] = acc[m][c];
    __syncthreads();
    for (int col = threadIdx.x; col < SC; col += kSThreads) {
      T s = stage[col];
      for (int v = 1; v < kSWarps; ++v) s += stage[v * 32 * C + col];
      tq::cluster_send(cluster, part, m * SC + col, L, rank, s);
    }
    __syncthreads();
  }
  // After one cluster barrier every block sums its slice over the blocks
  // in rank order from its own shared memory, times the epilogue.
  cluster.sync();
  for (int i = threadIdx.x; i < L; i += kSThreads) {
    const int e = rank * L + i;
    const int m = e / SC, col = e % SC;
    const int gm = row0 + m;
    const int64_t gn = static_cast<int64_t>(strip) * SC + col;
    if (e >= MT * SC || gm >= M || gn >= N) continue;
    const T s = tq::cluster_reduce(part, i, L, splits);
    out[static_cast<int64_t>(gm) * N + gn] =
        __fmul_rn(static_cast<float>(s), scale);
  }
}

// ------------------------------------------------------------ launching

struct Args {
  const float* x;
  const void* w;
  const int8_t* signs;
  const float* sf;
  const float* w_sf;
  float* out;
  int M, N, K, bits, budget, quantize_x, splits, k_per_split, row_tile;
};

template <int MODE, int F, int MT>
void launch_stream(const Args& a, cudaStream_t stream) {
  constexpr int64_t SC = kSLanes * kCols<F>;
  const unsigned strips = static_cast<unsigned>((a.N + SC - 1) / SC);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * a.splits, (a.M + MT - 1) / MT, 1);
  cfg.blockDim = dim3(kSThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A refused launch is reported by cudaGetLastError in
  // tq_term_matmul_stream.
  cudaLaunchKernelEx(&cfg, term_matmul_stream_kernel<MODE, F, MT>, a.x,
                     static_cast<const char*>(a.w),
                     reinterpret_cast<const char*>(a.signs), a.sf, a.w_sf,
                     a.out, a.M, a.N, a.K, a.bits, a.budget, a.quantize_x,
                     a.splits, a.k_per_split);
}

// Launch the kernel for (MODE, F); false if it does not take the
// arguments (nothing is launched).
template <int MODE, int F>
bool launch_kernel(const Args& a, cudaStream_t stream) {
  if (a.splits < 1 || a.splits > 8 || a.k_per_split % kSGroup) return false;
  switch (a.row_tile) {
    case 1: launch_stream<MODE, F, 1>(a, stream); return true;
    case 8: launch_stream<MODE, F, 8>(a, stream); return true;
    default: return false;
  }
}

template <int MODE>
bool launch_format(int wfmt, const Args& a, cudaStream_t stream) {
  switch (wfmt) {
    case kWF32: return launch_kernel<MODE, kWF32>(a, stream);
    case kWBF16: return launch_kernel<MODE, kWBF16>(a, stream);
    case kWInt8: return launch_kernel<MODE, kWInt8>(a, stream);
    case kWInt16: return launch_kernel<MODE, kWInt16>(a, stream);
    case kWPacked8: return launch_kernel<MODE, kWPacked8>(a, stream);
    default: return false;
  }
}

}  // namespace

// mode: 0 f32, 1 bf16, 2 int8.  wfmt: 0 float32, 1 bfloat16, 2 int8,
// 3 int16, 4 9-bit pack (w = lo, signs = the sign plane; else signs may be
// null).  sf: the activation scale (read only when quantize_x); w_sf: the
// weight scale or null for 1.  K split over a cluster of `splits` <= 8
// blocks of k_per_split rows (a multiple of 8); row_tile (1 or 8) rows of
// x a block.  Only the combinations term_matmul admits launch: the int8
// mode takes int8 weights and quantized activations; anything else
// returns cudaErrorInvalidValue.
extern "C" int tq_term_matmul_stream(const float* x, const void* w,
                                     const int8_t* signs, const float* sf,
                                     const float* w_sf, float* out, int M,
                                     int N, int K, int bits, int budget,
                                     int mode, int wfmt, int quantize_x,
                                     int splits, int k_per_split,
                                     int row_tile, cudaStream_t stream) {
  const Args a{x, w, signs, sf, w_sf, out, M, N, K, bits, budget,
               quantize_x, splits, k_per_split, row_tile};
  bool ok = false;
  if (mode == kF32) {
    ok = launch_format<kF32>(wfmt, a, stream);
  } else if (mode == kBF16) {
    ok = launch_format<kBF16>(wfmt, a, stream);
  } else if (mode == kInt8 && wfmt == kWInt8 && quantize_x) {
    ok = launch_kernel<kInt8, kWInt8>(a, stream);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
