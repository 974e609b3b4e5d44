// term_matmul's bf16 and int8 modes at M > STREAM_MAX_M, on the tensor
// cores:
//   out = acc(xa @ wa) * (sf * w_sf)        (sf = 1 for raw input)
//
// * bf16 mode: xa is the signed integer sign * kept (kept: the `budget`
//   largest HESE terms of q = min(floor(|x| / sf + 0.5), 2^bits - 1))
//   rounded to bfloat16, or x rounded to bfloat16 for raw input
//   (quantize_x = 0); wa is the weight as stored (float32, bf16-stored,
//   int8 or int16 q, the 9-bit pack's q) rounded to bfloat16.  mma.sync m16n8k16 bf16 accumulates in float32
//   (a product of two bfloat16 values is exact in float32).
// * int8 mode (int8 weights, bits <= 7): xa = sign * kept as int8, +128
//   (one kept term of q >= 96) saturated to 127 as the TPU kernel's cast
//   to int8 saturates it; mma.sync m16n8k32 s8 into int32: exact.
//
// Replaces, for these two modes at M > 8, the Pallas kernel
// tq_tpu/kernels/term_matmul.py::term_matmul (bodies _body / _body_pipe
// :264-348; _tr_tile(apply_sf=False) :202-216; _widen_w / _load_w
// :219-250; _mac_into :253-261; pallas_call :528).
//
// Bound on the card.  At the eval shapes ((128, 784, 512), (350, 650,
// 2600)) and bench.py's (8192, 2048, 512) the bytes bound it: x is read
// as float32 (4 bytes a value) and the bf16 products run at 989 TFLOP/s,
// the int8 ones at 1,979 TOP/s, so operations come to a half (bf16) or a
// third (int8) of the byte time.  Each block term-reveals its 64 rows of
// x for its 128 columns, so a value of x is revealed once per 128
// columns of N (N / 128 times in all); at bench.py's shape that reveal,
// about 40 instructions a value on the load warps, and not the MMAs,
// sets the time (PERF.md).
//
// Design: csrc/term_matmul_mma.cu's (the f32 mode), with 2- and 1-byte
// operands.
// * One launch, no workspace.  A 64 x 128 output tile takes a cluster of
//   up to 8 blocks along x, each a slice of K; the partial tiles meet in
//   distributed shared memory and each block sums its slice over the
//   blocks in rank order (cluster_sum.cuh): float32 in the bf16 mode,
//   int32 in the int8 mode (exact whatever the order).  The wrapper
//   sizes the cluster through the occupancy API
//   (tq_term_matmul_mma_lp_clusters).
// * Warps 8-15 load and convert, warps 0-7 multiply.  A step covers 64
//   bytes of K of each operand (32 bf16 or 64 int8 values: two mma
//   chunks of 32 bytes).  In step s the load warps issue the loads of
//   step s + 2 into one register set and convert and store step s + 1,
//   loaded a step before, into the other of two shared-memory slots,
//   while the MMA warps multiply step s; one barrier ends the step.  No
//   conversion runs on the MMA warps.
// * One fragment layout for both modes.  Both operands are stored as
//   rows of K bytes: x as [m][k], w transposed to [n][k] (bf16 pairs of
//   rows k, k + 1, or int8 quads of rows k .. k + 3, a word per column,
//   transposed with byte permutes).  m16n8k16 bf16 and m16n8k32 s8 then
//   take the same registers, 32 bytes of K (a0: row g, bytes 4t .. 4t +
//   3; b0: column g, the same bytes; ...), loaded with ldmatrix.  Rows
//   are 80 bytes apart (64 + 16): an ldmatrix matrix's 8 rows fall in 8
//   distinct 16-byte bank groups, so the fragment loads are
//   conflict-free.
// * The reveal once per value per block, on the load warps, a unit's 8
//   or 16 values at once (tq::quantize_n: the division by sf as
//   tq::quantize_rcp in its proven range, __fdiv_rn outside it), the kept
//   value looked up in a table of every q's (bits <= 8, built once per
//   block with tq::keep_terms: top terms by bfind), or computed
//   (tq::keep_terms_n) above 8 bits.
// K past the end, rows past M and columns past N load zeros (the pack's
// rows past K, which decode to magnitude 128, are set to 0).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_sum.cuh"
#include "mma_common.cuh"
#include "tr_common.cuh"

namespace {

// The wrapper's code of the mode; the weight formats' are mma_common.cuh's.
enum Mode : int { kBF16 = 1, kInt8 = 2 };
using tq::kWBF16;
using tq::kWBytes;
using tq::kWF32;
using tq::kWInt16;
using tq::kWInt8;
using tq::kWPacked8;
using tq::ldsm_x4;
using tq::load4;
using tq::load_elems;
using tq::w_elem;

constexpr int kBM = 64;             // output tile rows
constexpr int kBN = 128;            // output tile columns
constexpr int kStepBytes = 64;      // K bytes of each operand a step
constexpr int kChunkBytes = 32;     // K bytes of one mma
constexpr int kRow = kStepBytes + 16;  // bytes between shared-memory rows
constexpr int kConsumers = 256;     // 8 MMA warps, 32 x 32 outputs each
constexpr int kProducers = 256;     // 8 warps: loads, reveal, conversion
constexpr int kThreads = kConsumers + kProducers;
constexpr int kATile = kBM * kRow;  // x [m][k bytes]
constexpr int kBTile = kBN * kRow;  // w [n][k bytes]
constexpr int kSlot = kATile + kBTile;
constexpr int kTileQuads = kBM * kBN / 4;
constexpr int kMaxSplits = 8;
// Shared memory: two slots, in which the partial tile (4 bytes an entry)
// is staged after the loop; then the cluster sum's buffer of splits * L
// <= kTileQuads + 7 quads; then the table of kept values (kLutBits).
constexpr int kStage =
    2 * kSlot > 16 * kTileQuads ? 2 * kSlot : 16 * kTileQuads;
constexpr int kLut = kStage + 16 * (kTileQuads + kMaxSplits);
constexpr int kSmemBytes = kLut + 4 * 256;
static_assert(kBM * (kStepBytes / 16) == kProducers,
              "one 16-byte unit of x a producer");
static_assert(kBN / 4 * (kStepBytes / 4) == 2 * kProducers,
              "two weight cells a producer");

template <int MODE>
constexpr int kElem = MODE == kBF16 ? 2 : 1;  // bytes of an operand
template <int MODE>
constexpr int kBK = kStepBytes / kElem<MODE>;  // K a step
template <int MODE>
constexpr int kChunkK = kChunkBytes / kElem<MODE>;  // K of one mma
// K rows of a weight cell (a word per column), and quads of x in a unit.
template <int MODE>
constexpr int kR = kBK<MODE> / 16;
template <int MODE>
using Acc = std::conditional_t<MODE == kInt8, int32_t, float>;

__device__ __forceinline__ void step_barrier() {
  tq::step_barrier<kThreads>();
}

// lo and hi rounded to bfloat16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(p.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(p.y)) << 16);
}

// Bits up to which the kept value of every q is looked up in a table of
// 2^bits entries that each block computes once (tq::keep_terms), so
// that the reveal of a value is
// its quantization and one shared-memory load; above it (the bf16 mode
// takes bits up to MAX_BITS) the load warps compute it (keep_terms_n).
constexpr int kLutBits = 8;

// A producer's 16 bytes of x's step row: its 4 kR x values (as their
// float bits) revealed (QX) and packed, bf16 pairs or int8 quads, as
// term_matmul_stream.cu's act_tile gives them.  All the values at once, so that
// their chains overlap: tq::quantize_n, then the kept value from `lut`
// (or tq::keep_terms_n where lut is null), then the sign of x.
template <int MODE, bool QX>
__device__ __forceinline__ uint4 x_unit(const uint32_t (&raw)[kR<MODE>][4],
                                        float sf, float r, float maxq,
                                        int budget, bool rcp_ok,
                                        const int32_t* lut) {
  constexpr int N = 4 * kR<MODE>;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __uint_as_float(raw[i / 4][i % 4]);
  int32_t s[N] = {};
  if constexpr (QX) {
    uint32_t q[N];
    tq::quantize_n(v, sf, r, maxq, rcp_ok, q);
    if (lut != nullptr) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = lut[q[i]];
    } else {
      tq::keep_terms_n<N, false>(q, budget, s);
    }
    // int8: +128 saturates to 127, -128 stays.
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = v[i] < 0.f ? -s[i] : MODE == kInt8 ? min(s[i], 127) : s[i];
  }
  uint32_t o[4];
  if constexpr (MODE == kBF16) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      if constexpr (QX)
        o[i / 2] = bf16_pair(static_cast<float>(s[i]),
                             static_cast<float>(s[i + 1]));
      else
        o[i / 2] = bf16_pair(v[i], v[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      o[i / 4] = (static_cast<uint32_t>(s[i]) & 0xffu) |
                 ((static_cast<uint32_t>(s[i + 1]) & 0xffu) << 8) |
                 ((static_cast<uint32_t>(s[i + 2]) & 0xffu) << 16) |
                 (static_cast<uint32_t>(s[i + 3]) << 24);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A weight cell, kR K rows from k (k + rr < ke exist) by four columns, as
// the four words of its columns: bf16 pairs (rows k, k + 1) or int8 quads
// (rows k .. k + 3, transposed with byte permutes).
template <int MODE, int F>
__device__ __forceinline__ void w_cell(
    const uint32_t (&raw)[kR<MODE>][kWBytes<F>], uint32_t sgn, int k, int ke,
    uint32_t (&o)[4]) {
  if constexpr (MODE == kBF16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = w_elem<F>(raw[0], sgn, j, k);
      float b = w_elem<F>(raw[1], sgn, j, k + 1);
      if constexpr (F == kWPacked8) {  // zeros past K, not magnitude 128
        if (k >= ke) a = 0.f;
        if (k + 1 >= ke) b = 0.f;
      }
      o[j] = bf16_pair(a, b);
    }
  } else {
    const uint32_t t0 = __byte_perm(raw[0][0], raw[1][0], 0x5140);
    const uint32_t t1 = __byte_perm(raw[2][0], raw[3][0], 0x5140);
    const uint32_t u0 = __byte_perm(raw[0][0], raw[1][0], 0x7362);
    const uint32_t u1 = __byte_perm(raw[2][0], raw[3][0], 0x7362);
    o[0] = __byte_perm(t0, t1, 0x5410);
    o[1] = __byte_perm(t0, t1, 0x7632);
    o[2] = __byte_perm(u0, u1, 0x5410);
    o[3] = __byte_perm(u0, u1, 0x7632);
  }
}

// c += a * b on one tile: m16n8k16 bf16 into float32, or m16n8k32 s8 into
// int32.
template <int MODE>
__device__ __forceinline__ void mma(Acc<MODE> (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (MODE == kBF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Block (tile column, rank) of a cluster of `splits` along x, tile row
// blockIdx.y: output rows row0 .. row0 + 63, columns col0 .. col0 + 127,
// K rows [rank * k_per_split, + k_per_split), in steps of kBK rows.
// vec_x, vec_w, vec_s: elements a load of x, of w (the pack's lo) and of
// the pack's signs may take (4, 2 or 1).
template <int MODE, int F, bool QX>
__global__ void __launch_bounds__(kThreads, 1)
term_matmul_mma_lp_kernel(const float* __restrict__ x,
                          const char* __restrict__ w,
                          const char* __restrict__ signs,
                          const float* __restrict__ sf_ptr,
                          const float* __restrict__ wsf_ptr,
                          float* __restrict__ out, int M, int N, int K,
                          int bits, int budget, int splits, int k_per_split,
                          int vec_x, int vec_w, int vec_s) {
  constexpr int BK = kBK<MODE>, R = kR<MODE>, E = kWBytes<F>;
  using T = Acc<MODE>;
  using Q = std::conditional_t<MODE == kInt8, int4, float4>;
  extern __shared__ __align__(16) unsigned char smem[];
  Q* const part = reinterpret_cast<Q*>(smem + kStage);

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  tq::cluster_arrive();  // wait before the first write to another block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % splits;
  const int row0 = blockIdx.y * kBM, col0 = (blockIdx.x / splits) * kBN;
  const int kb = rank * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  T acc[2][4][4] = {};
  if (warp >= kConsumers / 32) {
    // ------------------------------------- loads, reveal and conversion
    const int p = threadIdx.x - kConsumers;
    // x: row am of the tile, bytes 16 * aq .. + 15 of the step's row
    // (K values ak .. ak + 4R - 1 of the step).
    const int am = p / 4, aq = p % 4, ak = aq * (BK / 4);
    const bool live = am < M - row0;
    // w: K word kw of the step (rows R * kw ..) in column quads cq0 and
    // cq0 + 16; a warp covers 16 words of 8 columns, so its stores of a
    // column's words fall in distinct banks.
    const int kw = lane & 15;
    const int cq0 = (p >> 5) * 2 + (lane >> 4);
    const int cols = min(kBN, N - col0);
    const float sf = QX ? *sf_ptr : 1.f;
    const float maxq = QX ? static_cast<float>((1u << bits) - 1u) : 0.f;
    const float r = QX ? __frcp_rn(sf) : 1.f;
    const bool rcp_ok = tq::rcp_scale_ok(sf);
    // The kept value of every q, computed once by the load warps (a named
    // barrier over them alone) before their first store reads it.
    int32_t* const lut = QX && bits <= kLutBits ? reinterpret_cast<int32_t*>(
                                               smem + kLut)
                                         : nullptr;
    if (lut != nullptr) {
      for (int q = p; q < (1 << bits); q += kProducers)
        lut[q] = tq::keep_terms(static_cast<uint32_t>(q), budget, false);
      asm volatile("bar.sync 2, %0;" ::"n"(kProducers) : "memory");
    }
    // Two register sets of one step's loads, so that a step's loads are
    // issued a whole step before they are stored.
    struct Regs {
      uint32_t x[R][4];
      uint32_t w[2][R][E];
      uint32_t s[2];
    };
    Regs g0 = {}, g1 = {};
    auto load = [&](int s, Regs& g) {
      const int k0 = kb + s * BK;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = k0 + ak + 4 * i;
        load4<4>(reinterpret_cast<const char*>(
                     x + static_cast<int64_t>(row0 + am) * K + k),
                 live ? ke - k : 0, vec_x, g.x[i]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cq = cq0 + 16 * c;
        const int n = col0 + 4 * cq, left = cols - 4 * cq;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const int k = k0 + R * kw + rr;
          load4<E>(w + (static_cast<int64_t>(k) * N + n) * E,
                   k < ke ? left : 0, vec_w, g.w[c][rr]);
        }
        if constexpr (F == kWPacked8) {
          const int k = k0 + R * kw;  // rows k, k + 1: one sign row
          uint32_t t[1];
          load4<1>(signs + static_cast<int64_t>(k >> 3) * N + n,
                   k < ke ? left : 0, vec_s, t);
          g.s[c] = t[0];
        }
      }
    };
    // Step s into its slot: x revealed and packed, w converted and
    // transposed.
    auto store = [&](int s, const Regs& g) {
      unsigned char* const a = smem + (s & 1) * kSlot;
      const int k0 = kb + s * BK;
      *reinterpret_cast<uint4*>(a + am * kRow + aq * 16) =
          live ? x_unit<MODE, QX>(g.x, sf, r, maxq, budget, rcp_ok, lut)
               : make_uint4(0u, 0u, 0u, 0u);
      unsigned char* const b = a + kATile;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cq = cq0 + 16 * c;
        uint32_t o[4];
        w_cell<MODE, F>(g.w[c], g.s[c], k0 + R * kw, ke, o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(b + (4 * cq + j) * kRow + 4 * kw) =
              o[j];
      }
    };
    if (steps > 0) load(0, g0);
    if (steps > 1) load(1, g1);
    if (steps > 0) store(0, g0);
    step_barrier();
    // Step s: set 0 holds step s (stored) for even s, set 1 step s + 1.
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {
      if (s + 2 < steps) load(s + 2, g0);
      if (s + 1 < steps) store(s + 1, g1);  // the slot of step s - 1
      step_barrier();
      if (s + 1 >= steps) break;
      if (s + 3 < steps) load(s + 3, g1);
      if (s + 2 < steps) store(s + 2, g0);
      step_barrier();
    }
  } else {
    // ------------------------------------------------------ the MMAs
    const int g = lane >> 2, t = lane & 3;  // the fragments' row, column
    const int wm = warp >> 2, wn = warp & 3;  // rows 32 wm.., cols 32 wn..
    // This lane's ldmatrix rows: A matrices (rows +8, bytes +16) =
    // (a1, a2); B matrices (bytes +16, columns +8) = (b1, next tile's b0).
    const int a_off =
        (wm * 32 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRow +
        16 * (lane >> 4);
    const int b_off = kATile +
                      (wn * 32 + (lane & 7) + 8 * (lane >> 4)) * kRow +
                      16 * ((lane >> 3) & 1);
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    step_barrier();
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const uint32_t sb = base + (s & 1) * kSlot;
      const int rows = ke - (kb + s * BK);  // K left (the last step: fewer;
                                            // the rest are zeros)
#pragma unroll
      for (int c = 0; c < kStepBytes / kChunkBytes; ++c) {
        if (c * kChunkK<MODE> >= rows) break;
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(sb + a_off + mt * 16 * kRow + c * kChunkBytes, af[mt]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4(sb + b_off + np * 16 * kRow + c * kChunkBytes, bf[np]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma<MODE>(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)],
                      bf[nt >> 1][2 * (nt & 1) + 1]);
      }
      step_barrier();
    }
    // The partial tile into the slots (free after the last barrier).
    T* const stage = reinterpret_cast<T*>(smem);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* const e = stage + (wm * 32 + mt * 16 + g + 8 * h) * kBN +
                       wn * 32 + nt * 8 + 2 * t;
          e[0] = acc[mt][nt][2 * h];
          e[1] = acc[mt][nt][2 * h + 1];
        }
  }
  __syncthreads();

  // Each quad of the partial tile goes to the block of the cluster that
  // owns it; after one cluster barrier each block sums its slice over the
  // blocks in rank order, times sf * w_sf.
  const int L = tq::slice_len(kTileQuads, splits);
  tq::cluster_wait();
  for (int i = threadIdx.x; i < kTileQuads; i += kThreads)
    tq::cluster_send(cluster, part, i, L, rank,
                     reinterpret_cast<const Q*>(smem)[i]);
  cluster.sync();
  const float wsf = wsf_ptr != nullptr ? *wsf_ptr : 1.f;
  const float scale = QX ? __fmul_rn(*sf_ptr, wsf) : wsf;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int e = 4 * (rank * L + i);
    const int gm = row0 + e / kBN, gn = col0 + e % kBN;
    if (e >= 4 * kTileQuads || gm >= M) continue;
    const Q v = tq::cluster_reduce(part, i, L, splits);
    const T s[4] = {v.x, v.y, v.z, v.w};
    float* const o = out + static_cast<int64_t>(gm) * N + gn;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < N) o[j] = __fmul_rn(static_cast<float>(s[j]), scale);
  }
}

using Args = tq::MmaArgs;

template <int MODE, int F, bool QX>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = term_matmul_mma_lp_kernel<MODE, F, QX>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg = tq::cluster_config(
      dim3(static_cast<unsigned>((a.N + kBN - 1) / kBN * a.splits),
           static_cast<unsigned>((a.M + kBM - 1) / kBM), 1),
      kThreads, kSmemBytes, a.splits, stream, la);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, a.x, static_cast<const char*>(a.w),
      reinterpret_cast<const char*>(a.signs), a.sf, a.w_sf, a.out, a.M, a.N,
      a.K, a.bits, a.budget, a.splits, a.k_per_split,
      load_elems(a.x, a.K, 4), load_elems(a.w, a.N, kWBytes<F>),
      a.signs != nullptr ? load_elems(a.signs, a.N, 1) : 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_bf16(const Args& a, int quantize_x, cudaStream_t stream) {
  return quantize_x ? launch<kBF16, F, true>(a, stream)
                    : launch<kBF16, F, false>(a, stream);
}

}  // namespace

// How many clusters of `splits` blocks of the kernel in mode `mode` the
// card runs at once (cudaOccupancyMaxActiveClusters), or a negative CUDA
// error.
extern "C" int tq_term_matmul_mma_lp_clusters(int mode, int splits) {
  return mode == kInt8
             ? tq::cluster_occupancy(
                   term_matmul_mma_lp_kernel<kInt8, kWInt8, true>, kThreads,
                   kSmemBytes, splits)
             : tq::cluster_occupancy(
                   term_matmul_mma_lp_kernel<kBF16, kWF32, true>, kThreads,
                   kSmemBytes, splits);
}

// mode: 1 bf16, 2 int8.  wfmt: 0 float32, 1 bfloat16, 2 int8, 3 int16,
// 4 the 9-bit pack (w = lo (K8, N), signs = the sign plane (K8 / 8, N);
// else signs may be null).  x (M, K) float32 and w (K, N) row-major;
// sf: the activation scale (read only when quantize_x); w_sf: the weight
// scale or null for 1; out (M, N).  Output tiles of 64 rows by 128
// columns; K split over a cluster of `splits` <= 8 blocks of k_per_split
// rows (a multiple of 16 in the bf16 mode, 32 in the int8 mode, covering
// K).  The int8 mode takes int8 weights and quantized activations only.
// Anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int tq_term_matmul_mma_lp(const float* x, const void* w,
                                     const int8_t* signs, const float* sf,
                                     const float* w_sf, float* out, int M,
                                     int N, int K, int bits, int budget,
                                     int mode, int wfmt, int quantize_x,
                                     int splits, int k_per_split,
                                     cudaStream_t stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const int chunk = mode == kInt8 ? kChunkK<kInt8> : kChunkK<kBF16>;
  if (splits < 1 || splits > kMaxSplits || k_per_split < chunk ||
      k_per_split % chunk ||
      static_cast<int64_t>(splits) * k_per_split < K ||
      (wfmt == kWPacked8 && signs == nullptr))
    return kInvalid;
  const Args a{x, w, signs, sf, w_sf, out, M, N, K, bits, budget, splits,
               k_per_split};
  if (mode == kInt8)
    return wfmt == kWInt8 && quantize_x ? launch<kInt8, kWInt8, true>(a, stream)
                                        : kInvalid;
  if (mode != kBF16) return kInvalid;
  switch (wfmt) {
    case kWF32: return launch_bf16<kWF32>(a, quantize_x, stream);
    case kWBF16: return launch_bf16<kWBF16>(a, quantize_x, stream);
    case kWInt8: return launch_bf16<kWInt8>(a, quantize_x, stream);
    case kWInt16: return launch_bf16<kWInt16>(a, quantize_x, stream);
    case kWPacked8: return launch_bf16<kWPacked8>(a, quantize_x, stream);
    default: return kInvalid;
  }
}
