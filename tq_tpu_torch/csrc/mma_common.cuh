// The producer/consumer skeleton shared by the tensor-core term_matmul
// kernels (term_matmul_mma.cu: the f32 mode; term_matmul_mma_lp.cu: the
// bf16 and int8 modes): the step barrier between their load warps and
// MMA warps, and the launch of one kernel on clusters of `splits` blocks
// along x, with the occupancy query the wrapper sizes the clusters by.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace tq
