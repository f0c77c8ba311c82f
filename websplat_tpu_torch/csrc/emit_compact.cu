// Packed slot emission + compaction: per-splat rect words -> instances.
//
// Replaces websplat_tpu/ops/emit_compact_pallas.py:_emit_compact_kernel
// (called by emit_compact).  Each splat's rect word holds tx0 (7 bits), ty0
// (7), min(w_t, 15) (4) and a slot mask from bit 18; set bit j emits the
// rect's row-major rank j as the key tile << depth_bits | depth_q with the
// splat's 4 record words.
//
// What bounds it on the card: memory traffic -- 24 bytes read per splat,
// 20 written per instance -- and launch latency at small N.  Its design: one
// thread per splat decodes its rect and counts its mask bits; one block scan
// and one atomicAdd per block reserve the block's rows (stream.cuh); each
// thread then writes its instances in rank order.  The output is an exact
// prefix; the TPU kernel's per-(step, slot) unit offsets, rounded up to 1024
// for its DMAs, and its ordered-overlap output protocol existed because the
// TPU has no scatter and no atomics.  The cursor ends at the true count even
// past the capacity; rows past it are not written.
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int EMIT_BLOCK = 256;
constexpr int EMIT_MASK_SHIFT = 18;

__global__ void __launch_bounds__(EMIT_BLOCK)
    emit_compact_kernel(const uint32_t* __restrict__ depth_q, const uint32_t* __restrict__ rect,
                        const uint32_t* __restrict__ words, int64_t n, int slots, int tx_tiles,
                        int depth_bits, uint32_t* __restrict__ keys,
                        uint32_t* __restrict__ out_words, int64_t capacity,
                        int* __restrict__ counter) {
  __shared__ BlockAppend<EMIT_BLOCK> append;
  const int64_t i = (int64_t)blockIdx.x * EMIT_BLOCK + threadIdx.x;
  const uint32_t r = i < n ? rect[i] : 0u;
  const uint32_t mask = (r >> EMIT_MASK_SHIFT) & ((1u << slots) - 1u);
  int pos = append.reserve(__popc(mask), counter);
  if (mask == 0u) return;
  const int tx0 = (int)(r & 0x7Fu);
  const int ty0 = (int)((r >> 7) & 0x7Fu);
  const int w_t = max((int)((r >> 14) & 0xFu), 1);
  const uint32_t dq = depth_q[i];
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = words[k * n + i];
  for (int j = 0; j < slots; ++j) {
    if (!((mask >> j) & 1u)) continue;
    if (pos < capacity) {
      const int dy = j / w_t;
      const uint32_t tile = (uint32_t)((ty0 + dy) * tx_tiles + tx0 + (j - dy * w_t));
      keys[pos] = (tile << depth_bits) | dq;
#pragma unroll
      for (int k = 0; k < 4; ++k) out_words[k * capacity + pos] = w[k];
    }
    ++pos;
  }
}

}  // namespace ws

extern "C" {

// depth_q, rect: n u32; words: (4, n) u32; keys: capacity u32 and
// out_words: (4, capacity) u32, pre-filled by the caller; counter: one int,
// zeroed by the caller, ends at the number of valid instances
int ws_emit_compact(const uint32_t* depth_q, const uint32_t* rect, const uint32_t* words,
                    int64_t n, int slots, int tx_tiles, int depth_bits, uint32_t* keys,
                    uint32_t* out_words, int64_t capacity, int* counter, void* stream) {
  if (slots < 1 || slots > 8) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t grid = (n + ws::EMIT_BLOCK - 1) / ws::EMIT_BLOCK;
    ws::emit_compact_kernel<<<(unsigned)grid, ws::EMIT_BLOCK, 0, (cudaStream_t)stream>>>(
        depth_q, rect, words, n, slots, tx_tiles, depth_bits, keys, out_words, capacity,
        counter);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
