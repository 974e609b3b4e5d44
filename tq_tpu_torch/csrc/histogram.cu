// Fixed-range histogram of float32 values on Hopper: one calibration
// batch's counts (layers/quantize.py::histogram_update) in one launch.
//
// Replaces no TPU kernel: the JAX package counts with .at[idx].add
// (tq_tpu/layers/quantize.py::histogram_update), a scatter-add that XLA
// emits.  The port's plain version takes seven full-size element-wise
// passes and index_add_, whose global atomics (half of them on the bin of
// ReLU's zeros, serialised at one address) took 79% of the calibration
// cell's device time (PERF.md).
//
// Bound on the card: HBM, 4 bytes an element read once; the counts are 8
// bytes a bin, a few KB a launch.
//
// Design (kernels/histogram.py sizes the launch):
// * The bin as the plain version's: floor((x - minv) * inv_width) in
//   float32, with __fsub_rn and __fmul_rn so that nothing is contracted
//   into an fma, the top edge clamped into the last bin, counted only
//   where minv <= x <= maxv (so NaN and +-inf never).  Counts are exact
//   integers: the histogram equals the plain version's on every input.
// * Block-private counts: each block keeps num_bins uint32 counts in
//   dynamic shared memory (32 KB at 8,192 bins; past 48 KB after
//   cudaFuncSetAttribute, up to kMaxBins), and at its end adds each
//   non-zero bin once into the int64 counts with a 64-bit global
//   atomicAdd.  A block counts fewer than 2^32 elements: the grid is
//   full past a few million elements, so a bin would overflow only past
//   2^40 elements.
// * No aggregation of equal bins: a shared-memory atomic costs the same
//   whether a warp's 32 lanes hit one address or 32 (an all-zero or a
//   constant input runs at the time of a ReLU output), and matching
//   the lanes' bins first (__match_any_sync, one shared atomic a distinct
//   bin) ran 2.6x slower on a ReLU output and 4.4x on a signed one
//   (PERF.md).  The global atomics of a single-pass scatter-add,
//   every SM on one L2 address, are what serialised.
// * 16-byte loads in a grid-stride loop, kUnroll vectors a thread issued
//   before any is counted, a warp's load 512 contiguous bytes.
//   The elements before the first 16-byte-aligned vector and after the
//   last whole one (at most 3 each) go to block 0's first threads.
// * Two blocks an SM (the wrapper's grid): enough loads in flight for the
//   bytes (one block an SM ran 10-13% slower at (64, 56, 56, 64), three
//   no faster), few blocks to zero and flush.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                 // 16-byte vectors a thread a step
constexpr int kMaxBins = 16384;            // 64 KB of shared memory a block
constexpr int kDefaultSharedBytes = 48 * 1024;

struct Range {
  float minv;
  float maxv;
  float inv_width;  // float32(1 / bin width)
  int num_bins;
};

// The bin of x, or -1 where x is not counted.
__device__ __forceinline__ int bin_of(float x, const Range& r) {
  if (!(x >= r.minv && x <= r.maxv)) return -1;
  const float f = floorf(__fmul_rn(__fsub_rn(x, r.minv), r.inv_width));
  return max(0, min(static_cast<int>(f), r.num_bins - 1));
}

__device__ __forceinline__ void count(uint32_t* bins, float x,
                                      const Range& r) {
  const int bin = bin_of(x, r);
  if (bin >= 0) atomicAdd(&bins[bin], 1u);
}

// x[0, head) one at a time, then n_vec float4 vectors from x + head
// (16-byte aligned), then `tail` elements one at a time; num_bins counts,
// zeroed before the launch.
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const float* __restrict__ x, int64_t head,
                     int64_t n_vec, int64_t tail,
                     unsigned long long* __restrict__ counts, Range r) {
  extern __shared__ uint32_t bins[];
  for (int b = threadIdx.x; b < r.num_bins; b += kThreads) bins[b] = 0;
  __syncthreads();

  if (blockIdx.x == 0) {  // head + tail <= 6 threads
    if (threadIdx.x < head)
      count(bins, __ldg(x + threadIdx.x), r);
    else if (threadIdx.x - head < tail)
      count(bins, __ldg(x + head + 4 * n_vec + (threadIdx.x - head)), r);
  }

  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n_vec) v[u] = __ldg(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < n_vec) {
        count(bins, v[u].x, r);
        count(bins, v[u].y, r);
        count(bins, v[u].z, r);
        count(bins, v[u].w, r);
      }
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < r.num_bins; b += kThreads) {
    const uint32_t c = bins[b];
    if (c != 0) atomicAdd(counts + b, static_cast<unsigned long long>(c));
  }
}

// Lift the 48 KB default where num_bins needs more shared memory.
cudaError_t allow_shared(int num_bins) {
  const int bytes = num_bins * static_cast<int>(sizeof(uint32_t));
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(histogram_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// Writes the histogram of x (float32) over [minv, maxv] in num_bins bins
// of float32 reciprocal width inv_width to counts (int64, num_bins): a
// memset, then the kernel over the span (head, n_vec, tail) of
// kernels/histogram.py::plan on `blocks` blocks.  Zeroing here, not with
// a PyTorch operator, spares the caller an operator's host time a call.
// A span or bin count the kernel cannot take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tq_histogram(const float* x, int64_t head, int64_t n_vec,
                            int64_t tail, long long* counts, int num_bins,
                            float minv, float maxv, float inv_width,
                            int blocks, cudaStream_t stream) {
  if (num_bins < 1 || num_bins > kMaxBins || blocks < 1 || head < 0 ||
      head > 3 || n_vec < 0 || tail < 0 || tail > 3 ||
      (n_vec > 0 && reinterpret_cast<uintptr_t>(x + head) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_shared(num_bins);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, num_bins * sizeof(long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  Range r{minv, maxv, inv_width, num_bins};
  void* args[] = {&x, &head, &n_vec, &tail, &c, &r};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(histogram_kernel), dim3(blocks),
      dim3(kThreads), args, num_bins * sizeof(uint32_t), stream));
}
