// Exact-prefix stream appends shared by the compaction and packed emission
// kernels (the overflow walk keeps the same rule with per-warp counts).
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
  int base;   // the block's first global row (valid after reserve)
  int total;  // the block's row count (valid after reserve)

  // Collective: every thread of the block calls it with its row count.
  // Returns the global index of this thread's first row.
  __device__ __forceinline__ int reserve(int count, int* cursor) {
    int excl, sum;
    __syncthreads();  // the storage may still be in use by a previous call
    Scan(scan).ExclusiveSum(count, excl, sum);
    if (threadIdx.x == 0) {
      base = sum > 0 ? atomicAdd(cursor, sum) : 0;
      total = sum;
    }
    __syncthreads();
    return base + excl;
  }
};

}  // namespace ws
