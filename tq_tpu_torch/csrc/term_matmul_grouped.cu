// Grouped TR expert product on Hopper: every expert of a mixture-of-experts
// layer in one launch,
//   out[g, p, :] = (x[p, :] @ q_g[e(p)]) * w_sf_g[e(p)]
// for every (row, slot) pair p routed to expert e(p), the pairs grouped by
// expert (layers/moe.py sorts them), and each product g of a launch (gate
// and up share one) reading its own experts' weights.
//
// Replaces no TPU kernel: the JAX package runs one term_matmul per expert.
// The port did too (layers/moe.py, one streaming or mma launch an expert
// a product), and a decode step of a 64-expert layer at batch 64 (~6
// pairs an expert) then paid ~180 launches a layer and one host sync to
// cut the slices: host-paced, its small launches each on a fifth of the
// card (PERF.md).
//
// The arithmetic is the streaming kernel's (csrc/term_matmul_stream.cu)
// on the raw-input f32 variant of the 9-bit pack (f32_raw_packed8): x
// itself feeds the product, the weight is the pack's biased magnitude
// (lo + 128) with its sign bit XOR-ed into bit 31, float32 FMAs in K
// order within a warp's groups of 8 rows, the warps' partials summed in
// warp order, the K splits in rank order, then times w_sf.  No TF32, no
// lower precision.
//
// Bound on the card: bytes, every held expert's packed weights read once
// (1.125 bytes a weight; an expert with more than 8 pairs reads them once
// a row tile, from L2 when the tiles run together), about 10 operations a
// byte against the CUDA cores' 20.
//
// Design (kernels/term_matmul_grouped.py plans the launch):
// * A block is 4 warps over (a strip of 128 columns, a row tile of up to
//   8 pairs of one expert, a K split rank, a product).  Its lanes own 4
//   columns each, 4 aligned bytes a row, so no realignment: N = 1,408 is
//   11 strips, 2,048 is 16.
// * The row tiles are numbered expert by expert, ceil(load / 8) each for
//   a held expert and none for another, from the device's inclusive prefix
//   sums of the loads (`ends`): warp 0 of each block scans them (at most
//   256 experts) and finds its tile's expert, first pair and row count.
//   The host never reads the loads: it sizes the grid by the most tiles
//   the pairs can make, and blocks past the real total exit at once.
// * The tile's rows are a template parameter (1 .. 8), so a tile of 5
//   pairs does 5 FMAs a weight, not 8.
// * Each expert's weights are read through a device table of its planes'
//   addresses (lo, signs) and a stacked w_sf: nothing is copied or
//   stacked.  Each warp keeps its next 5 groups of 8 rows in flight,
//   copied asynchronously (cp.async, 16 bytes a copy: rows of a multiple
//   of 16 bytes, checked with the table) into its own ring of shared
//   memory: 4-byte loads into registers, one group ahead, kept too few
//   bytes in flight and ran at 0.75 TB/s (PERF.md).  x's rows are staged
//   in shared memory in chunks of 512 K rows.
// * K is split over a thread-block cluster (cluster_sum.cuh) only where
//   the blocks would leave the card short (a handful of pairs): the
//   partials meet in distributed shared memory, in rank order, no
//   atomics, no workspace, so the result is deterministic and the launch
//   can be captured in a CUDA graph.

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;             // columns a lane owns (4 bytes)
constexpr int kStrip = 32 * kCols;   // a block's columns (bytes of a row)
constexpr int kTile = 8;             // most pairs a row tile
constexpr int kGroup = 8;            // weight rows a warp step (a sign byte)
constexpr int kChunk = 512;          // K rows of x staged at once
constexpr int kRing = 6;             // a warp's groups in shared memory
constexpr int kSlot = (kGroup + 1) * 32;  // a group's words: rows, signs
constexpr int kMaxExperts = 256;
constexpr int kScan = kMaxExperts / 32;

// An asynchronous copy of 16 bytes to shared memory, through L2 only.
__device__ __forceinline__ void copy_async(uint32_t* smem, const int8_t* g) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's latest copy groups are pending.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// Row i (of its group of 8) of 4 packed columns as the streaming kernel's
// widen gives them: |q| = lo + 128 under the exponent of 2^23, 2^23
// subtracted, the sign bit i of each column's sign byte put in bit 31.
__device__ __forceinline__ void widen(uint32_t v, uint32_t sgn, int i,
                                      float (&w)[kCols]) {
  const uint32_t u = v ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < kCols; ++b) {
    const float mag =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) -
        8388608.f;
    const uint32_t neg = (sgn << (31 - 8 * b - i)) & 0x80000000u;
    w[b] = __uint_as_float(__float_as_uint(mag) ^ neg);
  }
}

struct Tile {
  int expert;    // -1: past the last tile
  int rows;      // pairs of the tile, 1 .. kTile
  int64_t row0;  // its first pair
};

// Warp 0: the expert, first pair and rows of row tile `tile`, the tiles
// numbered expert by expert, ceil(load / kTile) each for held experts.
// ends: the inclusive prefix sums of the E loads.
__device__ __forceinline__ void find_tile(const int64_t* __restrict__ ends,
                                          const uint8_t* __restrict__ held,
                                          int E, int tile, Tile* found) {
  const int lane = threadIdx.x & 31;
  long long end[kScan];
  int keep[kScan];
#pragma unroll
  for (int c = 0; c < kScan; ++c) {  // every load issued before any is used
    const int e = c * 32 + lane;
    end[c] = e < E ? ends[e] : 0;
    keep[c] = e < E && (held == nullptr || held[e] != 0);
  }
  if (lane == 0) found->expert = -1;
  __syncwarp();
  long long before = 0;  // the end of the previous chunk's last expert
  int tiles_before = 0;
#pragma unroll
  for (int c = 0; c < kScan; ++c) {
    if (c * 32 >= E) break;
    const long long prev = __shfl_up_sync(0xffffffffu, end[c], 1);
    const long long start = lane == 0 ? before : prev;
    const bool real = c * 32 + lane < E;
    const int n = real ? static_cast<int>(end[c] - start) : 0;
    const int t = keep[c] ? (n + kTile - 1) / kTile : 0;
    int incl = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int first = tiles_before + incl - t;
    if (tile >= first && tile < first + t) {
      const int j = tile - first;
      found->expert = c * 32 + lane;
      found->rows = min(kTile, n - j * kTile);
      found->row0 = start + static_cast<int64_t>(j) * kTile;
    }
    tiles_before += __shfl_sync(0xffffffffu, incl, 31);
    before = __shfl_sync(0xffffffffu, end[c], 31);
  }
}

struct Args {
  const float* x;
  const int64_t* ends;
  const uint8_t* held;
  const int64_t* ptrs;  // (G, E, 2): each expert's lo and signs addresses
  const float* w_sf;    // (G, E)
  float* out;           // (G, P, N)
  // Pair p reads x's row gather[p] / top_k (gather null: row p).
  const int64_t* gather;
  // Pair p writes out's row scatter[p] (null: row p), times
  // scale[scatter[p]] (null: 1).
  const int64_t* scatter;
  const float* scale;
  int P, E, N, K, splits, k_per_split, top_k;
};

// A tile's pairs: the x row each reads, the out row each writes and its
// scale (threads 0 .. rows - 1 fill them once the tile is known).
struct Rows {
  int64_t src[kTile];
  int64_t dst[kTile];
  float scale[kTile];
};

// The block's work once its tile is known: R pairs from t.row0 of expert
// t.expert, the strip's columns, K rows [rank * k_per_split, + k_per_split).
// Each warp takes the groups of 8 rows warp, warp + 4, ... of the range and
// keeps the next kRing - 1 of them in flight, copied asynchronously into
// its own ring of shared memory; x's R rows are staged a chunk of K at a
// time for the block.
template <int R>
__device__ __forceinline__ void tile_product(const Args& a, const Tile& t,
                                             const Rows& io, float* stage,
                                             float* part, uint32_t* ring) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.z;
  const int rank = blockIdx.x % a.splits, strip = blockIdx.x / a.splits;
  const int kb = rank * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int64_t N = a.N;
  const int64_t* entry = a.ptrs + (static_cast<int64_t>(g) * a.E + t.expert)
                                      * 2;
  const int8_t* strip_w = reinterpret_cast<const int8_t*>(entry[0]) +
                          static_cast<int64_t>(strip) * kStrip;
  const int8_t* strip_s = reinterpret_cast<const int8_t*>(entry[1]) +
                          static_cast<int64_t>(strip) * kStrip;
  const float scale = a.w_sf[static_cast<int64_t>(g) * a.E + t.expert];
  // The strip's bytes of a row that exist (N % 16 == 0).
  const int64_t rest = N - static_cast<int64_t>(strip) * kStrip;
  const int width = rest < kStrip ? static_cast<int>(rest) : kStrip;
  uint32_t* my_ring = ring + warp * kRing * kSlot;
  // This warp's groups: rows kb + 8 (warp + 4 j), j < n_groups.  Every
  // copied row is below K8 (the pack's rows); those past K meet zeros.
  const int groups = (ke - kb + kGroup - 1) / kGroup;
  const int n_groups = groups > warp ? (groups - warp + kWarps - 1) / kWarps
                                     : 0;

  // Copy group j into its slot (nothing past the last: an empty commit
  // keeps the count of groups in flight the same on every lane).
  auto fetch = [&](int j) {
    if (j < n_groups) {
      const int64_t kg =
          kb + static_cast<int64_t>(kGroup) * (warp + kWarps * j);
      uint32_t* slot = my_ring + (j % kRing) * kSlot;
      const int8_t* rows = strip_w + kg * N;
      const int8_t* signs = strip_s + kg / kGroup * N;
      // 8 rows x 8 chunks of 16 bytes, then the sign row's 8.
#pragma unroll
      for (int c = lane; c < (kGroup + 1) * 8; c += 32) {
        const int r = c >> 3, b = (c & 7) * 16;
        if (b < width)
          copy_async(slot + r * 32 + b / 4,
                     (r < kGroup ? rows + r * N : signs) + b);
      }
    }
    copy_commit();
  };

  float acc[R][kCols];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  // Multiply-accumulate group j, its rows at row `row` of the staged chunk.
  auto mac = [&](int j, int row) {
    const uint32_t* slot = my_ring + (j % kRing) * kSlot;
    const uint32_t sgn = slot[kGroup * 32 + lane];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float wv[kCols];
      widen(slot[i * 32 + lane], sgn, i, wv);
      const float* xs = stage + (row + i) * kTile;
      float xv[kTile];
      const float4 lo4 = *reinterpret_cast<const float4*>(xs);
      xv[0] = lo4.x, xv[1] = lo4.y, xv[2] = lo4.z, xv[3] = lo4.w;
      if constexpr (R > 4) {
        const float4 hi4 = *reinterpret_cast<const float4*>(xs + 4);
        xv[4] = hi4.x, xv[5] = hi4.y, xv[6] = hi4.z, xv[7] = hi4.w;
      }
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[m][c] = fmaf(xv[m], wv[c], acc[m][c]);
    }
  };

#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) fetch(j);
  constexpr int kPerChunk = kChunk / (kWarps * kGroup);  // a warp's groups
  for (int c0 = kb, j0 = 0; c0 < ke; c0 += kChunk, j0 += kPerChunk) {
    const int c1 = min(ke, c0 + kChunk);
    const int rows = (c1 - c0 + kGroup - 1) / kGroup * kGroup;
    // x's R rows of the chunk, [k][kTile]; zeros past c1 and past R.  A
    // thread's loads are all issued before its first store.
    constexpr int kPer = kChunk / kThreads;
    float v[kPer][kTile];
#pragma unroll
    for (int m = 0; m < kTile; ++m) {
      const float* xm =
          a.x + (m < R ? io.src[m] : 0) * a.K + c0 + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        v[q][m] = m < R && c0 + threadIdx.x + q * kThreads < c1
                      ? xm[q * kThreads] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = threadIdx.x + q * kThreads;
      if (k < rows) {
        float4* dst = reinterpret_cast<float4*>(stage + k * kTile);
        dst[0] = make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
        dst[1] = make_float4(v[q][4], v[q][5], v[q][6], v[q][7]);
      }
    }
    __syncthreads();
    const int j1 = min(n_groups, j0 + kPerChunk);
    for (int j = j0; j < j1; ++j) {
      fetch(j + kRing - 1);
      copy_wait<kRing - 1>();  // group j is in this lane's slot ...
      __syncwarp();            // ... and in every lane's
      mac(j, kGroup * (warp + kWarps * (j - j0)));
      __syncwarp();  // the slot is read before a later fetch refills it
    }
    __syncthreads();
  }
  copy_wait<0>();

  // The warps' sums in warp order, one pair at a time, each sent to the
  // block of the cluster that owns its slice of the R x kStrip partials.
  const int L = tq::slice_len(R * kStrip, a.splits);
  tq::cluster_wait();
#pragma unroll
  for (int m = 0; m < R; ++m) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) stage[threadIdx.x * kCols + c] = acc[m][c];
    __syncthreads();
    for (int j = threadIdx.x; j < kStrip; j += kThreads) {
      float s = stage[j];
      for (int v = 1; v < kWarps; ++v) s += stage[v * 32 * kCols + j];
      tq::cluster_send(cluster, part, m * kStrip + j, L, rank, s);
    }
    __syncthreads();
  }
  cluster.sync();
  float* out = a.out + static_cast<int64_t>(g) * a.P * N;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int e = rank * L + i;
    const int m = e / kStrip, j = e % kStrip;
    const int64_t gn = static_cast<int64_t>(strip) * kStrip + j;
    if (e >= R * kStrip || gn >= N) continue;
    out[io.dst[m] * N + gn] = __fmul_rn(
        __fmul_rn(tq::cluster_reduce(part, i, L, a.splits), scale),
        io.scale[m]);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
term_matmul_grouped_kernel(Args a) {
  // x's staged chunk ([k][kTile]), then the warps' partials.
  __shared__ __align__(16) float stage[kChunk * kTile];
  // This block's slice of the tile's partial sums, a row a cluster block.
  __shared__ __align__(16) float part[kTile * kStrip + 8];
  // Each warp's ring of weight groups.
  __shared__ __align__(16) uint32_t ring[kWarps * kRing * kSlot];
  __shared__ Tile tile;
  __shared__ Rows io;

  if (threadIdx.x < 32) {
    find_tile(a.ends, a.held, a.E, blockIdx.y, &tile);
    __syncwarp();
    const int m = threadIdx.x;
    if (tile.expert >= 0 && m < tile.rows) {
      const int64_t p = tile.row0 + m;
      io.src[m] = a.gather != nullptr ? a.gather[p] / a.top_k : p;
      io.dst[m] = a.scatter != nullptr ? a.scatter[p] : p;
      io.scale[m] = a.scale != nullptr ? a.scale[io.dst[m]] : 1.f;
    }
  }
  __syncthreads();
  const Tile t = tile;
  // Every block of a cluster has the same tile: they leave together.
  if (t.expert < 0) return;
  // Arrive now, wait before the first write to another block's shared
  // memory: every block of the cluster has started by then.
  tq::cluster_arrive();
  switch (t.rows) {
    case 1: tile_product<1>(a, t, io, stage, part, ring); break;
    case 2: tile_product<2>(a, t, io, stage, part, ring); break;
    case 3: tile_product<3>(a, t, io, stage, part, ring); break;
    case 4: tile_product<4>(a, t, io, stage, part, ring); break;
    case 5: tile_product<5>(a, t, io, stage, part, ring); break;
    case 6: tile_product<6>(a, t, io, stage, part, ring); break;
    case 7: tile_product<7>(a, t, io, stage, part, ring); break;
    default: tile_product<8>(a, t, io, stage, part, ring); break;
  }
}

}  // namespace

// x: (P, K) float32, the pairs in the experts' order, or (Q, K) read
// through gather (pair p: row gather[p] / top_k).  ends: (E,) int64, the
// inclusive prefix sums of the experts' loads (ends[E - 1] == P); held:
// (E,) uint8, nonzero for the experts this launch computes, or null for
// all;
// ptrs: (G, E, 2) int64, each product's experts' lo (K8, N) and signs
// (K8 / 8, N) planes, N a multiple of 16 and every plane 16-byte aligned;
// w_sf: (G,
// E) float32.  out: (G, P, N) float32, pair p in row p, or in row
// scatter[p] where scatter is given, times scale[scatter[p]] where that
// is; the rows of pairs of experts not held are left as they are.  Grid:
// strips * splits blocks along x (clusters of `splits` <= 8), `tiles` row
// tiles along y, G products along z; K split over the cluster in
// k_per_split rows (a multiple of 8).  Anything else returns
// cudaErrorInvalidValue.
extern "C" int tq_term_matmul_grouped(
    const float* x, const int64_t* ends, const uint8_t* held,
    const int64_t* ptrs, const float* w_sf, float* out,
    const int64_t* gather, const int64_t* scatter, const float* scale, int P,
    int E, int N, int K, int G, int tiles, int splits, int k_per_split,
    int top_k, cudaStream_t stream) {
  if (splits < 1 || splits > 8 || k_per_split % kGroup || k_per_split < 1 ||
      E < 1 || E > kMaxExperts || N % 16 || N < 1 || K < 1 || P < 1 ||
      G < 1 || tiles < 1 || tiles > 65535 || G > 65535 || top_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,       ends,  held, ptrs, w_sf,        out,   gather,
               scatter, scale, P,    E,    N,    K,    splits,
               k_per_split, top_k};
  const unsigned strips = static_cast<unsigned>((N + kStrip - 1) / kStrip);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * splits, static_cast<unsigned>(tiles),
                     static_cast<unsigned>(G));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, term_matmul_grouped_kernel, a);
  return static_cast<int>(cudaGetLastError());
}
