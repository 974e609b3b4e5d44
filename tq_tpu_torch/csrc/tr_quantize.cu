// Term-reveal fake quantization on Hopper: the two bodies of tr_quantize.
//
// Replaces the Pallas kernel tq_tpu/kernels/tr_quantize.py::tr_quantize
// (element-wise body _elementwise_body, grouped body _grouped_body).
//
// Bound on the card: memory.  Each element is read once (4 B) and written
// once (4 B) and costs a few dozen integer operations, far below the
// H100's operations-per-byte balance, so the least time is bytes / HBM
// rate.  Design: one thread per element (element-wise) or per group
// (grouped), a grid-stride loop, no shared memory.  The grouped body keeps
// its g <= 32 term masks in registers and walks the planes with the
// reference kernel's greedy merge, so the TPU kernel's lower-triangular
// matmul for the within-plane rank is not needed.  The grouped body's
// loads are strided by g floats between neighbouring threads (uncoalesced);
// at the weight shapes it runs on (conversion, once per tensor) that costs
// little, and a warp-per-group layout is left to later work.

#include "tr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1 << 20) ? b : (1 << 20));
}

__device__ __forceinline__ float max_q(int bits) {
  return static_cast<float>((1u << bits) - 1u);
}

// group_size == 1: out[i] = sign * value(kept terms of q[i]) * sf, or the
// signed integer value itself when int_out is set.
__global__ void tr_elementwise_kernel(const float* __restrict__ x,
                                      const float* __restrict__ sf_ptr,
                                      void* __restrict__ out, int64_t n,
                                      int bits, int budget, int serial,
                                      int int_out) {
  const float sf = *sf_ptr;
  const float maxq = max_q(bits);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = x[i];
    const int32_t val = tq::keep_terms(tq::quantize(v, sf, maxq), budget,
                                       serial != 0);
    if (int_out)
      static_cast<int32_t*>(out)[i] = v < 0.f ? -val : val;
    else
      static_cast<float*>(out)[i] = tq::dequantize(v, val, sf);
  }
}

// group_size > 1: x is (n_groups, g) contiguous (the wrapper moved the
// grouping axis last and zero-padded it).  A term at (element j, plane p)
// is kept while the group's budget lasts, visiting planes top-down
// ('largest') or bottom-up ('serial') and, within a plane, elements in
// ascending index -- the order of the reference's k-way merge.
__global__ void tr_grouped_kernel(const float* __restrict__ x,
                                  const float* __restrict__ sf_ptr,
                                  float* __restrict__ out, int64_t n_groups,
                                  int g, int bits, int budget, int serial) {
  const float sf = *sf_ptr;
  const float maxq = max_q(bits);
  for (int64_t grp = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       grp < n_groups; grp += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float* xg = x + grp * g;
    float* og = out + grp * g;
    uint32_t t[kMaxGroup], neg[kMaxGroup], kept[kMaxGroup];
    uint32_t negative = 0;  // bit j: element j is < 0
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      t[j] = neg[j] = kept[j] = 0u;
      if (j < g) {
        const float v = xg[j];
        if (v < 0.f) negative |= 1u << j;
        tq::term_masks(tq::quantize(v, sf, maxq), t[j], neg[j]);
      }
    }
    int rem = budget;
    for (int s = 0; s <= bits && rem > 0; ++s) {
      const uint32_t plane = 1u << (serial ? s : bits - s);
#pragma unroll
      for (int j = 0; j < kMaxGroup; ++j) {
        if (rem > 0 && (t[j] & plane)) {
          kept[j] |= plane;
          --rem;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < g) {
        const float sign = (negative >> j) & 1u ? -1.f : 1.f;
        og[j] = tq::dequantize(sign, tq::kept_value(kept[j], neg[j]), sf);
      }
    }
  }
}

}  // namespace

extern "C" int tq_tr_quantize_elementwise(const float* x, const float* sf,
                                          void* out, int64_t n, int bits,
                                          int budget, int serial, int int_out,
                                          cudaStream_t stream) {
  tr_elementwise_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      x, sf, out, n, bits, budget, serial, int_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tq_tr_quantize_grouped(const float* x, const float* sf,
                                      float* out, int64_t n_groups,
                                      int group_size, int bits, int budget,
                                      int serial, cudaStream_t stream) {
  if (group_size < 1 || group_size > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  tr_grouped_kernel<<<blocks_for(n_groups), kThreads, 0, stream>>>(
      x, sf, out, n_groups, group_size, bits, budget, serial);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
