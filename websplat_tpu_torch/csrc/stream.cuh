// Exact-prefix stream appends shared by the frontend, overflow walk and
// compaction kernels.
//
// Replaces the TPU kernels' sequential SMEM cursor and ordered-overlap DMA
// writer (frontend_pallas.py:263-321): on the GPU, blocks run in parallel and
// in no order, so each block scans its threads' counts (cub::BlockScan, a
// block-level building block) and reserves its run of output rows with ONE
// atomicAdd on a global cursor.  The output is an exact prefix with no holes;
// its order across blocks is the atomics' order (the sort that follows
// re-orders everything).  The cursor ends at the TRUE total even past the
// capacity; rows past the capacity are not written (the caller counts them
// as dropped).
#pragma once

#include <cub/block/block_scan.cuh>

namespace ws {

template <int BLOCK>
struct BlockAppend {
  using Scan = cub::BlockScan<int, BLOCK>;
  typename Scan::TempStorage scan;
  int base;

  // Collective: every thread of the block calls it with its row count.
  // Returns the global index of this thread's first row.
  __device__ __forceinline__ int reserve(int count, int* cursor) {
    int excl, total;
    __syncthreads();  // the storage may still be in use by a previous call
    Scan(scan).ExclusiveSum(count, excl, total);
    if (threadIdx.x == 0) base = total > 0 ? atomicAdd(cursor, total) : 0;
    __syncthreads();
    return base + excl;
  }
};

// Collective block count of `pred`, added to a global counter.
__device__ __forceinline__ void block_count(bool pred, int* counter) {
  const int c = __syncthreads_count(pred);
  if (threadIdx.x == 0 && c > 0) atomicAdd(counter, c);
}

}  // namespace ws
