// The producer/consumer skeleton shared by the tensor-core term_matmul
// kernels (term_matmul_mma.cu: the f32 mode; term_matmul_mma_lp.cu: the
// bf16 and int8 modes): the step barrier between their load warps and
// MMA warps, and the launch of one kernel on clusters of `splits` blocks
// along x, with the occupancy query the wrapper sizes the clusters by,
// and the launch arguments; what their load warps share: the weight
// formats, the loads of four elements of a row and the widening of a
// weight as stored; and the MMA warps' ldmatrix fragment loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tq {

// The barrier that ends a step, for the MMA warps and the load warps
// alike: they reach it from different code, so it is the unaligned form,
// a named barrier over the block's THREADS threads.
template <int THREADS>
__device__ __forceinline__ void step_barrier() {
  asm volatile("barrier.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// A launch of `threads`-thread blocks with `smem` bytes of dynamic shared
// memory on clusters of `splits` blocks along x.  `la` holds the cluster
// attribute and must outlive the launch call.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem,
                                         int splits, cudaStream_t stream,
                                         cudaLaunchAttribute (&la)[1]) {
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = static_cast<unsigned>(splits);
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `splits` blocks of `kernel` the card runs at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
template <typename Kernel>
int cluster_occupancy(Kernel kernel, int threads, int smem, int splits) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(static_cast<unsigned>(splits), 1, 1), threads,
                     smem, splits, nullptr, la);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Four 8 x 16-byte matrices of shared memory into the fragment registers
// (lane l gives the address of row l % 8 of matrix l / 8; register q
// holds matrix q's 4-byte word l % 4 of row l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The wrapper's codes of the weight formats (kernels/term_matmul.py's
// _FORMATS), and the bytes of a weight as stored (the 9-bit pack: its lo
// byte; the sign plane, one bit a weight, is a second array).
enum WFmt : int { kWF32 = 0, kWBF16 = 1, kWInt8 = 2, kWInt16 = 3,
                  kWPacked8 = 4 };
template <int F>
constexpr int kWBytes = F == kWF32 ? 4 : (F == kWBF16 || F == kWInt16) ? 2
                                                                      : 1;

// Four elements of E bytes at src, of which the first n exist (zeros past
// them), as 4 * E bytes in E words, little-endian; read with loads of
// `vec` elements (4, 2 or 1; src aligned to vec * E bytes).
template <int E>
__device__ __forceinline__ void load4(const char* src, int n, int vec,
                                      uint32_t (&v)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = 0u;
  if (n >= 4 && vec == 4) {
    if constexpr (E == 4) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (E == 2) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(src));
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
    }
    return;
  }
  if (n >= 4 && vec == 2) {
    if constexpr (E == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(src));
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(src + 8));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else if constexpr (E == 2) {
      v[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
      v[1] = __ldg(reinterpret_cast<const unsigned int*>(src + 4));
    } else {
      v[0] = __ldg(reinterpret_cast<const unsigned short*>(src)) |
             (static_cast<uint32_t>(
                  __ldg(reinterpret_cast<const unsigned short*>(src + 2)))
              << 16);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= n) break;
    if constexpr (E == 4) {
      v[i] = __ldg(reinterpret_cast<const unsigned int*>(src) + i);
    } else if constexpr (E == 2) {
      v[i >> 1] |= static_cast<uint32_t>(__ldg(
                       reinterpret_cast<const unsigned short*>(src) + i))
                   << (16 * (i & 1));
    } else {
      v[0] |= static_cast<uint32_t>(
                  __ldg(reinterpret_cast<const unsigned char*>(src) + i))
              << (8 * i);
    }
  }
}

// Element j of a loaded row of four weights as a float: w, or q of
// integer and packed weights (exact in float32).  sgn: the pack's four sign bytes; k: the
// element's K row.  Integers are widened without int-to-float
// conversions (a quarter-rate instruction): q biased to an unsigned u is
// placed under the exponent of 2^23, and 2^23 plus the bias subtracted,
// exactly; the pack's sign goes into bit 31.
template <int F>
__device__ __forceinline__ float w_elem(const uint32_t (&v)[kWBytes<F>],
                                        uint32_t sgn, int j, int k) {
  if constexpr (F == kWF32) {
    return __uint_as_float(v[j]);
  } else if constexpr (F == kWBF16) {
    return __uint_as_float((v[j >> 1] >> (16 * (j & 1))) << 16);
  } else if constexpr (F == kWInt16) {  // u = q + 2^15
    const uint32_t u = ((v[j >> 1] >> (16 * (j & 1))) & 0xffffu) ^ 0x8000u;
    return __fsub_rn(__uint_as_float(0x4B000000u | u), 8421376.f);
  } else if constexpr (F == kWInt8) {  // u = q + 128
    const uint32_t u = ((v[0] >> (8 * j)) & 0xffu) ^ 0x80u;
    return __fsub_rn(__uint_as_float(0x4B000000u | u), 8388736.f);
  } else {  // 9-bit pack: |q| = lo + 128; sign bit k & 7 of the sign byte
    const uint32_t mag = ((v[0] >> (8 * j)) & 0xffu) ^ 0x80u;
    const float m = __fsub_rn(__uint_as_float(0x4B000000u | mag), 8388608.f);
    return __uint_as_float(__float_as_uint(m) |
                           (((sgn >> (8 * j + (k & 7))) & 1u) << 31));
  }
}

// The arguments of a tensor-core term_matmul launch.
struct MmaArgs {
  const float* x;
  const void* w;
  const int8_t* signs;
  const float* sf;
  const float* w_sf;
  float* out;
  int M, N, K, bits, budget, splits, k_per_split;
};

// Elements of `bytes` bytes a load of a row-major matrix with rows of
// `ld` elements at p may take: 4, 2 or 1, as the row length and the base
// pointer allow.
inline int load_elems(const void* p, int ld, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ld % 4 == 0 && a % (4 * bytes) == 0) return 4;
  if (ld % 2 == 0 && a % (2 * bytes) == 0) return 2;
  return 1;
}

}  // namespace tq
