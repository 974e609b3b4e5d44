// Split-K partial sums of a thread-block cluster, added in distributed
// shared memory: one launch, no workspace, no atomics, a fixed order.
//
// The blocks of a cluster (`splits` <= 8 of them, ranks 0 .. splits - 1)
// each hold a partial sum of the same tile of E entries.  Block r owns
// entries [r * L, (r + 1) * L) with L = slice_len(E, splits), and keeps a
// buffer `part` of splits * L entries at the same shared-memory offset in
// every block: row q of it receives block q's partials of the slice.
//
//   cluster_arrive();        // early: every block has started when ...
//   ... compute the partials ...
//   cluster_wait();          // ... this returns; remote writes are safe
//   cluster_send(...) for each entry the block holds;
//   cluster.sync();
//   cluster_reduce(...) for each entry of the block's own slice.
//
// The sum over the blocks runs in rank order, so it is deterministic and
// the launch can be captured in a CUDA graph.
#pragma once

#include <cooperative_groups.h>

namespace tq {

// Partial sums of float4 and int4 quads (cluster_reduce<float4>,
// cluster_reduce<int4>: exact); declared before the templates that use
// them.
__device__ __forceinline__ float4& operator+=(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

__device__ __forceinline__ int4& operator+=(int4& a, const int4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// Entries of a tile of E entries that each of `splits` blocks owns.
__host__ __device__ __forceinline__ int slice_len(int E, int splits) {
  return (E + splits - 1) / splits;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Store this block's (rank `rank`) partial sum s of tile entry e in the
// `part` buffer of the block that owns e.
template <typename T>
__device__ __forceinline__ void cluster_send(
    cooperative_groups::cluster_group& cluster, T* part, int e, int L,
    int rank, T s) {
  const int owner = e / L;
  cluster.map_shared_rank(part, owner)[rank * L + e - owner * L] = s;
}

// After cluster.sync(): entry i of this block's slice summed over the
// `splits` blocks in rank order.
template <typename T>
__device__ __forceinline__ T cluster_reduce(const T* part, int i, int L,
                                            int splits) {
  T s = {};
  for (int q = 0; q < splits; ++q) s += part[q * L + i];
  return s;
}

}  // namespace tq
