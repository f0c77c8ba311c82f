// Stream compaction: drop rows keyed 0xFFFFFFFF.
//
// Replaces websplat_tpu/ops/compact_pallas.py:_compact_kernel (called by
// compact_instances).  On the main path it compacts the dense extreme-tail
// candidate grid (n_tiles x mega capacity rows, 192,850 at the bench scene)
// before the sort.
//
// What bounds it on the card: pure memory traffic -- it reads 4 + 4 *
// n_payload bytes per row and writes the same per kept row (~4 MB per frame
// at the bench scene, a few microseconds at HBM rate, so launch latency
// dominates).  Its design: one thread per row, a block scan of the keep
// flags and one atomicAdd per block (stream.cuh) -- the TPU version's
// bit-serial monotone shuffle, ALIGN-rounded block offsets and chained DMAs
// existed only because the TPU has no scatter and no atomics.  The output is
// an exact prefix (the TPU left up to 127 sentinels per 4096-row block).
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int COMPACT_BLOCK = 256;

__global__ void __launch_bounds__(COMPACT_BLOCK)
    compact_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ payload,
                   int n_payload, int64_t m, uint32_t* __restrict__ out_keys,
                   uint32_t* __restrict__ out_payload, int64_t capacity,
                   int* __restrict__ counter) {
  __shared__ BlockAppend<COMPACT_BLOCK> append;
  const int64_t i = (int64_t)blockIdx.x * COMPACT_BLOCK + threadIdx.x;
  const uint32_t key = i < m ? keys[i] : INVALID_KEY;
  const bool keep = key != INVALID_KEY;
  const int pos = append.reserve(keep ? 1 : 0, counter);
  if (keep && pos < capacity) {
    out_keys[pos] = key;
    for (int k = 0; k < n_payload; ++k) out_payload[k * capacity + pos] = payload[k * m + i];
  }
}

}  // namespace ws

extern "C" {

// payload: (n_payload, m) rows; out_payload: (n_payload, capacity) rows;
// counter: one int, zeroed by the caller, ends at the number of kept rows
int ws_compact(const uint32_t* keys, const uint32_t* payload, int n_payload, int64_t m,
               uint32_t* out_keys, uint32_t* out_payload, int64_t capacity, int* counter,
               void* stream) {
  if (m > 0) {
    const int64_t grid = (m + ws::COMPACT_BLOCK - 1) / ws::COMPACT_BLOCK;
    ws::compact_kernel<<<(unsigned)grid, ws::COMPACT_BLOCK, 0, (cudaStream_t)stream>>>(
        keys, payload, n_payload, m, out_keys, out_payload, capacity, counter);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
