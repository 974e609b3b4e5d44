// Term-reveal fake quantization on Hopper: the two bodies of tr_quantize,
// and the scale-only copy it is measured against.
//
// Replaces the Pallas kernels tq_tpu/kernels/tr_quantize.py::tr_quantize
// (element-wise body _elementwise_body, grouped body _grouped_body) and
// ::tr_scale_copy (the element-wise kernel's grid with a body that only
// scales: the copy ceiling of the element-wise body).
//
// The element-wise body (B1) and tr_scale_copy (B5) share one grid.
//
// Bound on the card.  B5 and the float32 B1 move 8 bytes an element (4
// read, 4 written; B1's int32 output the same) and are bound by HBM: B1
// float32 runs at B5's time, its copy ceiling.  The bfloat16 B1 moves 4
// bytes an element (6 with int32 output), and its reveal, about 45 SASS
// instructions an element on the common path, binds it instead: at the
// issue rate of 132 SMs x 4 warp instructions a clock that is above its
// byte bound (PERF.md counts both, scripts/time_tr_quantize.py --sass).
//
// Design (kernels/tr_quantize.py::plan sizes the launch):
// * 16-byte loads and stores.  Each thread takes kUnroll vectors of 16
//   bytes of x a tile (4 float32 or 8 bfloat16 each), kThreads vectors
//   apart, so that a warp's load is 512 contiguous bytes; it issues all
//   of a tile's loads before any reveal, and the next tile's before the
//   reveal of this one, so that loads stay in flight while it computes;
//   it stores 16-byte vectors of the output type (float4, int4, or 8
//   bfloat16 packed in pairs).  The vector loop indexes in 32 bits (the
//   wrapper splits a launch past 2^32 elements).
// * Alignment and tails in the same launch.  The vectors start where x
//   and out are both 16-byte aligned; the elements before (head) and the
//   last partial vector (tail) take the same body one element at a time,
//   on the grid's last threads.  Where no element aligns both pointers
//   (x one float past a boundary, out on one), every element goes that
//   way.
// * The grid is whole waves: as many blocks as the occupancy API says the
//   card runs at once, in a grid-stride loop over tiles.  One tile a
//   thread ran 2% slower over a float32 forward's shapes (PERF.md).
// * Small x one element a thread.  Where one wave of threads of one
//   element each covers x, a thread's chain (the loads, 1 / sf, a reveal
//   of 8) would set the time on the vectors, so every element goes one
//   at a time, a block per 256, on the instantiation without the vector
//   loop (under 32 registers: a full SM), in order, with __fdiv_rn (for
//   one quotient it costs less than 1 / sf and the corrections); each
//   thread's first load is issued before sf is read.
// * The reveal interleaved over kGroup = 8 elements (tr_common.cuh,
//   shared with the mma kernel): the quotient |x| / sf from 1 / sf
//   computed once a thread (quantize_rcp, equal to __fdiv_rn in its
//   range, __fdiv_rn outside it, the range checked once for the 8), and
//   the keep-terms loop stepping the 8 at once, so their chains overlap;
//   a budget of at least the term count skips it.  Eight, not a whole
//   tile: sixteen bfloat16 at once held 94 registers (two blocks an SM,
//   against four) and ran slower in all but one timed row (PERF.md).
//
// The grouped body (B2) reads x in place as (outer, n, inner): n the
// grouping axis, inner the product of the trailing dimensions (every
// caller groups along a non-last axis: dense (in, out) and the LSTM's
// (in, 4H) on axis 0, conv HWIO on axis 2).  It moves 8 bytes an element
// like B1 and needs no transpose.
// * A thread takes one cell (outer, group, column): it issues the group's
//   g loads, inner apart, before anything else, so neighbouring threads
//   take neighbouring columns and each of a warp's g loads is one
//   contiguous span; it writes the results back at the same addresses, so
//   the output is contiguous in x's own layout.  The trailing partial
//   group reads the missing elements as zeros (no terms), as the
//   reference's zero-pad.  Blocks of 64 threads, so that small weights
//   (the MLP's 784x512 at g = 16: 25,088 cells) still spread over every
//   SM: at those sizes a thread's chain, not the bytes, sets the time, so
//   more, shorter threads win (four columns a thread on 16-byte loads ran
//   up to 2x slower there, and 3% faster at 3x3x512x512 only: PERF.md).
//   Cells are numbered in 32 bits where they fit, else in 64.
// * The plane walk is sized to g: the instantiations for g = 8 and 16
//   (the paths' group sizes) keep 2g words of masks, and every other g up
//   to 32 takes the generic one.  It visits only the planes that hold a
//   term of the group, in the reference's order, counting each plane's
//   terms over the g masks, and stops at the plane P where the budget
//   runs out (the cut); a second pass keeps every term of the planes
//   before P and P's term in the first `rem` elements holding one, in
//   ascending index: the k-way merge's order.
// * Quotients as B1's: quantize_n from 1 / sf, read after the loads.
// Bound: 46 registers at g = 8, 64 at g = 16 (the generic 141).  At
// 3x3x512x512 (g = 8) it runs at 56% of its byte bound and 2.3x B5 on as
// many elements: its arithmetic (quotient, masks, the walk, the kept
// value), not the bytes, binds it (PERF.md).

// The element-wise body also takes bfloat16 input (the serving mode's
// activations): the magnitude is quantized in float32 from the exact
// widening of the input, the kept integer rounds to bfloat16 (RNE), and
// its product with sf rounds to bfloat16 again, as the JAX package's
// sign * acc.astype(bfloat16) * sf followed by the cast to bfloat16.

#include <cuda_bf16.h>

#include <type_traits>

#include "tr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                 // 16-byte vectors a thread a tile
constexpr int kTile = kUnroll * kThreads;  // vectors a block a tile
// Elements a reveal takes at once: two float32 vectors, or one of eight
// bfloat16 (sixteen at once held 94 registers, two blocks an SM).
constexpr int kGroup = 8;
static_assert(kUnroll * 4 % kGroup == 0, "whole float32 groups a tile");
constexpr int kMaxGroup = 32;

// One launch's elements: `head` one at a time, then n_vec 16-byte vectors
// of x (x + head and out + head 16-byte aligned), then `tail` one at a
// time.
struct Span {
  int64_t head;
  uint32_t n_vec;
  uint32_t tail;
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// 16 bytes of x (w) into v[at ..], widened exactly to float32.
template <int M>
__device__ __forceinline__ void widen(const float*, uint4 w, float (&v)[M],
                                      int at) {
  v[at] = __uint_as_float(w.x);
  v[at + 1] = __uint_as_float(w.y);
  v[at + 2] = __uint_as_float(w.z);
  v[at + 3] = __uint_as_float(w.w);
}
template <int M>
__device__ __forceinline__ void widen(const __nv_bfloat16*, uint4 w,
                                      float (&v)[M], int at) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[at + 2 * j] = __uint_as_float(u[j] << 16);
    v[at + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(int32_t* p, int32_t v) { *p = v; }

// V outputs o[at ..] at p (16-byte aligned), in 16-byte stores.
template <int V, int M>
__device__ __forceinline__ void store_vec(float* p, const float (&o)[M],
                                          int at) {
#pragma unroll
  for (int j = 0; j < V; j += 4)
    *reinterpret_cast<float4*>(p + j) =
        make_float4(o[at + j], o[at + j + 1], o[at + j + 2], o[at + j + 3]);
}
template <int V, int M>
__device__ __forceinline__ void store_vec(int32_t* p, const int32_t (&o)[M],
                                          int at) {
#pragma unroll
  for (int j = 0; j < V; j += 4)
    *reinterpret_cast<int4*>(p + j) =
        make_int4(o[at + j], o[at + j + 1], o[at + j + 2], o[at + j + 3]);
}
template <int V, int M>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&o)[M], int at) {
#pragma unroll
  for (int j = 0; j < V; j += 8) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(o[at + j + 2 * k], o[at + j + 2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p + j) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The element-wise grid.  make_body() gives the body, which maps M widened
// inputs to M results (float, rounded to the output type at the store, or
// int32); it reads sf, so it is called once this thread's first loads are
// out, and the two loads overlap.  VEC: the vectors too.  A span of single
// elements alone (n_vec 0) runs on the instantiation without them, which
// holds fewer registers and so runs more blocks an SM.
template <bool VEC, typename In, typename Out, class MakeBody>
__device__ __forceinline__ void elementwise(const In* __restrict__ x,
                                            Out* __restrict__ out,
                                            const Span s,
                                            const MakeBody& make_body) {
  using Body = decltype(make_body());
  using R = typename Body::R;
  constexpr int V = 16 / sizeof(In);
  // One element at a time: without the vectors, in order; with them, the
  // head, then the tail, from the grid's last thread down (the first
  // threads take the vectors, so that a small x runs both at once).  The
  // next element's load is issued before this one's body.
  const int64_t singles = s.head + s.tail;
  const int64_t vec_end = s.head + static_cast<int64_t>(s.n_vec) * V;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  auto at = [&](int64_t i) {
    return !VEC || i < s.head ? i : vec_end + (i - s.head);
  };
  const int64_t gid =
      blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  int64_t i = VEC ? threads - 1 - gid : gid;
  float next1 = i < singles ? load1(x + at(i)) : 0.f;
  // Vectors, kUnroll a thread a tile, kThreads apart: the tile's loads,
  // then the next tile's (in flight during the reveal), then the reveal
  // of kGroup elements at once, and their stores, group by group.
  const uint4* const xv = reinterpret_cast<const uint4*>(x + s.head);
  Out* const ov = out + s.head;
  const uint32_t stride = gridDim.x * kTile;
  auto load = [&](uint32_t t, uint4 (&dst)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = t + u * kThreads;
      dst[u] = j < s.n_vec ? __ldg(xv + j) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint32_t t = blockIdx.x * kTile + threadIdx.x;
  uint4 w[kUnroll];
  if constexpr (VEC) load(t, w);
  const Body body = make_body();
  for (; i < singles; i += threads) {
    const float v[1] = {next1};
    if (i + threads < singles) next1 = load1(x + at(i + threads));
    R o[1];
    body(v, o);
    store1(out + at(i), o[0]);
  }
  if constexpr (VEC) {
    for (; t < s.n_vec; t += stride) {
      uint4 next[kUnroll];
      load(t + stride, next);  // zeros past the end, no access
#pragma unroll
      for (int g = 0; g < kUnroll; g += kGroup / V) {
        float v[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup / V; ++u) widen(x, w[g + u], v, u * V);
        R o[kGroup];
        body(v, o);
#pragma unroll
        for (int u = 0; u < kGroup / V; ++u) {
          const uint32_t j = t + (g + u) * kThreads;
          if (j < s.n_vec)
            store_vec<V>(ov + static_cast<size_t>(j) * V, o, u * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = next[u];
    }
  }
}

// B1's body: sign * value(kept terms of q) * sf, or the signed integer
// value itself (INT_OUT).  For bfloat16 input the value rounds to
// bfloat16 before the product (and the product at the store).
template <typename In, bool INT_OUT, bool SERIAL>
struct Reveal {
  using Out = std::conditional_t<INT_OUT, int32_t, In>;
  using R = std::conditional_t<INT_OUT, int32_t, float>;
  float sf, nsf, r, maxq;
  int budget;
  bool sf_ok, keep_all;

  // r_: the correctly rounded 1 / sf_ (unused by a body of one element).
  __device__ __forceinline__ Reveal(float sf_, float r_, int bits,
                                    int budget_)
      : sf(sf_), nsf(-sf_), r(r_),
        maxq(static_cast<float>((1u << bits) - 1u)), budget(budget_),
        sf_ok(tq::rcp_scale_ok(sf_)),
        // At least as many terms as q < 2^bits has: value == q.
        keep_all(budget_ >= 2 * (bits + 1) / 3) {}

  template <int M>
  __device__ __forceinline__ void operator()(const float (&v)[M],
                                             R (&o)[M]) const {
    uint32_t q[M];
    int32_t val[M];
    if constexpr (M == 1)  // one quotient: the division costs less than r
      q[0] = tq::quantize(v[0], sf, maxq);
    else
      tq::quantize_n(v, sf, r, maxq, sf_ok, q);
    if (keep_all) {
#pragma unroll
      for (int i = 0; i < M; ++i) val[i] = static_cast<int32_t>(q[i]);
    } else {
      tq::keep_terms_n<M, SERIAL>(q, budget, val);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if constexpr (INT_OUT) {
        o[i] = v[i] < 0.f ? -val[i] : val[i];
      } else {
        float m = static_cast<float>(val[i]);
        if constexpr (std::is_same_v<In, __nv_bfloat16>)
          m = __bfloat162float(__float2bfloat16_rn(m));
        // (sign * m) * sf, as tq::dequantize: the sign on sf instead.
        o[i] = __fmul_rn(m, v[i] < 0.f ? nsf : sf);
      }
    }
  }
};

// B5's body: x * sf.
struct Scale {
  using Out = float;
  using R = float;
  float sf;

  template <int M>
  __device__ __forceinline__ void operator()(const float (&v)[M],
                                             float (&o)[M]) const {
#pragma unroll
    for (int i = 0; i < M; ++i) o[i] = __fmul_rn(v[i], sf);
  }
};

template <typename In, bool INT_OUT, bool SERIAL, bool VEC>
__global__ void __launch_bounds__(kThreads)
    tr_elementwise_kernel(const In* __restrict__ x,
                          const float* __restrict__ sf,
                          typename Reveal<In, INT_OUT, SERIAL>::Out* out,
                          Span s, int bits, int budget) {
  elementwise<VEC>(x, out, s, [=] {
    const float scale = *sf;  // 1 / sf only for the vectors' groups of 8
    return Reveal<In, INT_OUT, SERIAL>(scale, VEC ? __frcp_rn(scale) : 0.f,
                                       bits, budget);
  });
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    tr_scale_copy_kernel(const float* __restrict__ x,
                         const float* __restrict__ sf, float* out, Span s) {
  elementwise<VEC>(x, out, s, [=] { return Scale{*sf}; });
}

// ---------------------------------------------------------------- B2

template <class F>
const void* address(F* f) {
  return reinterpret_cast<const void*>(f);
}

constexpr int kGroupedThreads = 64;

// One launch of the grouped body: x as (outer, n, inner); a cell is one
// (outer, group, column), groups = ceil(n / g).
struct Grouped {
  int64_t n, inner, groups, cells;
  int g;
};

// Cell t's outer index, group and column.
template <typename I>
__device__ __forceinline__ void cell_of(I t, I inner, I groups, int64_t& o,
                                        int64_t& grp, int64_t& col) {
  col = static_cast<int64_t>(t % inner);
  const I r = t / inner;
  grp = static_cast<int64_t>(r % groups);
  o = static_cast<int64_t>(r / groups);
}

// The greedy merge in cut-plane form over a group's term masks t[0..G):
// `whole` the planes kept entirely, `cut` the plane at which the budget
// ran out (0 if it did not), `rem` the terms left for it.  kept() is
// called once per element, in ascending index.
template <int G, bool SERIAL>
struct CutPlane {
  uint32_t whole = 0u, cut = 0u;
  int rem;

  __device__ __forceinline__ CutPlane(const uint32_t (&t)[G], int budget)
      : rem(budget) {
    uint32_t planes = 0u;  // the planes holding a term of the group
#pragma unroll
    for (int j = 0; j < G; ++j) planes |= t[j];
    while (planes != 0u && rem > 0) {
      const uint32_t p = SERIAL ? planes & (0u - planes) : tq::top_bit(planes);
      int c = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) c += (t[j] & p) != 0u;
      if (c > rem) {
        cut = p;
        break;
      }
      whole |= p;
      rem -= c;
      planes ^= p;
    }
  }

  __device__ __forceinline__ uint32_t kept(uint32_t t) {
    uint32_t k = t & whole;
    if ((t & cut) != 0u && rem > 0) {
      k |= cut;
      --rem;
    }
    return k;
  }
};

// One group in place: v[j] (0 where absent) becomes sign * value(kept
// terms) * sf.
template <int G, bool SERIAL>
__device__ __forceinline__ void reveal_group(float (&v)[G], float sf,
                                             float r, float maxq, bool sf_ok,
                                             int budget) {
  uint32_t q[G], t[G], negative = 0u;  // bit j: v[j] < 0
#pragma unroll
  for (int j = 0; j < G; ++j) negative |= (v[j] < 0.f ? 1u : 0u) << j;
  tq::quantize_n(v, sf, r, maxq, sf_ok, q);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    uint32_t neg;
    tq::term_masks(q[j], t[j], neg);
  }
  CutPlane<G, SERIAL> walk(t, budget);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    uint32_t tj, neg;  // neg again from q: fewer registers than keeping it
    tq::term_masks(q[j], tj, neg);
    v[j] = tq::dequantize((negative >> j) & 1u ? -1.f : 1.f,
                          tq::kept_value(walk.kept(t[j]), neg), sf);
  }
}

// G: the group size, or kMaxGroup for any g <= 32 (s.g, read at run time).
template <int G, bool SERIAL>
__global__ void __launch_bounds__(kGroupedThreads)
    tr_grouped_kernel(const float* __restrict__ x,
                      const float* __restrict__ sf_ptr,
                      float* __restrict__ out, const Grouped s, int bits,
                      int budget) {
  const uint64_t t = blockIdx.x * static_cast<uint64_t>(kGroupedThreads) +
                     threadIdx.x;
  if (t >= static_cast<uint64_t>(s.cells)) return;
  int64_t o, grp, col;
  if (s.cells <= static_cast<int64_t>(UINT32_MAX))
    cell_of<uint32_t>(static_cast<uint32_t>(t),
                      static_cast<uint32_t>(s.inner),
                      static_cast<uint32_t>(s.groups), o, grp, col);
  else
    cell_of<uint64_t>(t, s.inner, s.groups, o, grp, col);
  const int g = G == kMaxGroup ? s.g : G;
  const int64_t first = grp * g;
  const int64_t left = s.n - first;  // < g in the trailing partial group
  const int m = left < g ? static_cast<int>(left) : g;
  const int64_t at = (o * s.n + first) * s.inner + col;
  float v[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    v[j] = j < m ? __ldg(x + at + j * s.inner) : 0.f;
  const float sf = *sf_ptr;  // read once the loads are out
  const float r = __frcp_rn(sf);
  const float maxq = static_cast<float>((1u << bits) - 1u);
  const bool sf_ok = tq::rcp_scale_ok(sf);
  reveal_group<G, SERIAL>(v, sf, r, maxq, sf_ok, budget);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < m) out[at + j * s.inner] = v[j];
}

template <int G>
const void* grouped_function(bool serial) {
  return serial ? address(&tr_grouped_kernel<G, true>)
                : address(&tr_grouped_kernel<G, false>);
}

// Variant bits of the element-wise kernels: 1 bfloat16 input, 2 int32
// output, 4 'serial'; kScaleCopy is tr_scale_copy.
constexpr int kScaleCopy = 8;

// The element-wise kernels by variant, with the vectors (VEC) or without.
template <bool VEC>
const void* const* elementwise_functions() {
  using bf16 = __nv_bfloat16;
  static const void* const fns[] = {
      address(&tr_elementwise_kernel<float, false, false, VEC>),
      address(&tr_elementwise_kernel<bf16, false, false, VEC>),
      address(&tr_elementwise_kernel<float, true, false, VEC>),
      address(&tr_elementwise_kernel<bf16, true, false, VEC>),
      address(&tr_elementwise_kernel<float, false, true, VEC>),
      address(&tr_elementwise_kernel<bf16, false, true, VEC>),
      address(&tr_elementwise_kernel<float, true, true, VEC>),
      address(&tr_elementwise_kernel<bf16, true, true, VEC>),
      address(&tr_scale_copy_kernel<VEC>)};
  return fns;
}

const void* elementwise_function(int variant, bool vec) {
  if (variant < 0 || variant > kScaleCopy) return nullptr;
  return (vec ? elementwise_functions<true>()
              : elementwise_functions<false>())[variant];
}

// The span of a launch, or false where the kernel cannot take it: vectors
// past 32-bit indexing, or x + head / out + head off 16 bytes.
bool make_span(const void* x, const void* out, int in_bytes, int out_bytes,
               int64_t head, int64_t n_vec, int64_t tail, int blocks,
               Span* s) {
  if (head < 0 || n_vec < 0 || n_vec > INT32_MAX || tail < 0 ||
      tail > INT32_MAX || blocks < 1)
    return false;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) + head * in_bytes;
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out) + head * out_bytes;
  if (n_vec > 0 && (xa % 16 || oa % 16)) return false;
  *s = Span{head, static_cast<uint32_t>(n_vec), static_cast<uint32_t>(tail)};
  return true;
}

}  // namespace

// The element-wise body: x (float32, or bfloat16 where variant & 1) into
// out (x's type, or int32 where variant & 2; 'serial' where variant & 4)
// over the span (head, n_vec, tail) of kernels/tr_quantize.py::plan, on
// `blocks` blocks; a span without vectors, on the instantiation without
// the vector loop.  A span the kernel cannot take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tq_tr_quantize_elementwise(const void* x, const float* sf,
                                          void* out, int64_t head,
                                          int64_t n_vec, int64_t tail,
                                          int blocks, int bits, int budget,
                                          int variant, cudaStream_t stream) {
  const int in_bytes = variant & 1 ? 2 : 4;
  const int out_bytes = variant & 2 ? 4 : in_bytes;
  Span s;
  if (variant < 0 || variant >= kScaleCopy ||
      !make_span(x, out, in_bytes, out_bytes, head, n_vec, tail, blocks, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &sf, &out, &s, &bits, &budget};
  return static_cast<int>(cudaLaunchKernel(elementwise_function(variant,
                                                                s.n_vec > 0),
                                           dim3(blocks), dim3(kThreads), args,
                                           0, stream));
}

extern "C" int tq_tr_scale_copy(const float* x, const float* sf, float* out,
                                int64_t head, int64_t n_vec, int64_t tail,
                                int blocks, cudaStream_t stream) {
  Span s;
  if (!make_span(x, out, 4, 4, head, n_vec, tail, blocks, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &sf, &out, &s};
  return static_cast<int>(cudaLaunchKernel(elementwise_function(kScaleCopy,
                                                                s.n_vec > 0),
                                           dim3(blocks), dim3(kThreads), args,
                                           0, stream));
}

// Blocks of the element-wise kernel `variant` (kScaleCopy: tr_scale_copy),
// with the vectors, an SM runs at once (the occupancy API), or a negative
// CUDA error.
extern "C" int tq_tr_elementwise_blocks_per_sm(int variant) {
  const void* fn = elementwise_function(variant, true);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The grouped body: x (float32) viewed as (outer, n, inner), grouped along
// n by group_size (1..32); out the same layout.  Anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tq_tr_quantize_grouped(const float* x, const float* sf,
                                      float* out, int64_t outer, int64_t n,
                                      int64_t inner, int group_size, int bits,
                                      int budget, int serial,
                                      cudaStream_t stream) {
  if (group_size < 1 || group_size > kMaxGroup || outer < 1 || n < 1 ||
      inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (n + group_size - 1) / group_size;
  Grouped s{n, inner, groups, outer * groups * inner, group_size};
  const int64_t blocks = (s.cells + kGroupedThreads - 1) / kGroupedThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = group_size == 8    ? grouped_function<8>(serial)
                   : group_size == 16 ? grouped_function<16>(serial)
                                      : grouped_function<kMaxGroup>(serial);
  void* args[] = {&x, &sf, &out, &s, &bits, &budget};
  return static_cast<int>(
      cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                       dim3(kGroupedThreads), args, 0, stream));
}

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
