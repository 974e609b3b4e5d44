// Term-reveal fake quantization on Hopper: the two bodies of tr_quantize,
// and the scale-only copy it is measured against.
//
// Replaces the Pallas kernels tq_tpu/kernels/tr_quantize.py::tr_quantize
// (element-wise body _elementwise_body, grouped body _grouped_body) and
// ::tr_scale_copy (the element-wise kernel's grid with a body that only
// scales: the copy ceiling of the element-wise body).
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
//
// The element-wise body also takes bfloat16 input (the serving mode's
// activations): the magnitude is quantized in float32 from the exact
// widening of the input, the kept integer rounds to bfloat16 (RNE), and
// its product with sf rounds to bfloat16 again, as the JAX package's
// sign * acc.astype(bfloat16) * sf followed by the cast to bfloat16.  It
// moves half the bytes of the float32 body but measures no faster on the
// H100 (PERF.md): one element per thread on a grid-stride loop, not the
// bytes, limits both, and a plain copy on this grid (tr_scale_copy) is
// slower than PyTorch's own vectorized multiply.

#include <cuda_bf16.h>

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sign(x) * v * sf stored as In: float32 as is; bfloat16 with v rounded to
// bfloat16 before the product and the product rounded after it.
__device__ __forceinline__ void store_dequantized(float* out, int64_t i,
                                                  float x, int32_t v,
                                                  float sf) {
  out[i] = tq::dequantize(x, v, sf);
}
__device__ __forceinline__ void store_dequantized(__nv_bfloat16* out,
                                                  int64_t i, float x,
                                                  int32_t v, float sf) {
  const float s = __bfloat162float(__float2bfloat16_rn(static_cast<float>(v)));
  out[i] = __float2bfloat16_rn(__fmul_rn(x < 0.f ? -s : s, sf));
}

// group_size == 1: out[i] = sign * value(kept terms of q[i]) * sf (in the
// input's type), or the signed integer value itself when int_out is set.
template <typename In>
__global__ void tr_elementwise_kernel(const In* __restrict__ x,
                                      const float* __restrict__ sf_ptr,
                                      void* __restrict__ out, int64_t n,
                                      int bits, int budget, int serial,
                                      int int_out) {
  const float sf = *sf_ptr;
  const float maxq = max_q(bits);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = widen(x[i]);
    const int32_t val = tq::keep_terms(tq::quantize(v, sf, maxq), budget,
                                       serial != 0);
    if (int_out)
      static_cast<int32_t*>(out)[i] = v < 0.f ? -val : val;
    else
      store_dequantized(static_cast<In*>(out), i, v, val, sf);
  }
}

// tr_scale_copy: out[i] = x[i] * sf, on the element-wise body's grid.
__global__ void tr_scale_copy_kernel(const float* __restrict__ x,
                                     const float* __restrict__ sf_ptr,
                                     float* __restrict__ out, int64_t n) {
  const float sf = *sf_ptr;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = __fmul_rn(x[i], sf);
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

extern "C" int tq_tr_quantize_elementwise(const void* x, const float* sf,
                                          void* out, int64_t n, int bits,
                                          int budget, int serial, int int_out,
                                          int in_bf16, cudaStream_t stream) {
  if (in_bf16)
    tr_elementwise_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sf, out, n, bits, budget,
        serial, int_out);
  else
    tr_elementwise_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const float*>(x), sf, out, n, bits, budget, serial,
        int_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tq_tr_scale_copy(const float* x, const float* sf, float* out,
                                int64_t n, cudaStream_t stream) {
  tr_scale_copy_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, sf, out, n);
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
