// Packed slot emission + compaction: per-splat rect words -> instances.
//
// Replaces websplat_tpu/ops/emit_compact_pallas.py:_emit_compact_kernel
// (called by emit_compact).  Each splat's rect word holds tx0 (7 bits), ty0
// (7), min(w_t, 15) (4) and a slot mask from bit 18; set bit j emits the
// rect's row-major rank j as the key tile << depth_bits | depth_q with the
// splat's 4 record words.
//
// What bounds it on the card: memory traffic -- 4 bytes read per splat, 20
// more per splat that emits, 20 written per instance.  Its design keeps
// every access coalesced and pays the reservation once per 512 splats:
// - a CTA of 256 threads takes 512 splats, thread t the splats t + 256 k
//   (k < 2), so each load instruction of a warp reads 128 contiguous bytes
//   of one array (the record planes sit at k * n, so for most n they are not
//   16-byte aligned and a vector load would need the splats of a thread to
//   be adjacent, leaving the word loads at a 16-byte stride).  CTAs of 256
//   to 512 splats time alike; 1024 splats per CTA is slower, since fewer
//   CTAs per SM then overlap one another's load -> reserve -> store chains;
// - the depth and record words are loaded before the reservation,
//   predicated on a non-zero mask, so their latency overlaps the scan;
// - one block scan and one ordered reservation (stream.cuh: tile order by
//   decoupled look-back) place the block's rows, so the stream's order is
//   the same on every run: tile by tile, within a tile thread t's splats
//   t, t + 256 in turn, each splat's set slots ascending;
// - each thread writes its instances into shared memory at their place in
//   the block's run, and after one barrier the block writes the run with
//   consecutive threads on consecutive rows, one plane at a time.  Rows of
//   a block past the staging buffer (more than 2 per splat; the bench
//   scene averages 1.4) go straight to device memory.
// The output is an exact prefix; the TPU kernel's per-(step, slot) unit
// offsets, rounded up to 1024 for its DMAs, and its ordered-overlap output
// protocol existed because the TPU has no scatter and no atomics.  The
// counter ends at the true count even past the capacity; rows past it are
// not written.
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int EMIT_BLOCK = 256;
constexpr int EMIT_PER_THREAD = 2;
constexpr int EMIT_SPLATS = EMIT_BLOCK * EMIT_PER_THREAD;
constexpr int EMIT_STAGE = 2 * EMIT_SPLATS;  // staged rows per block: 5 planes, 20 KB
constexpr int EMIT_MASK_SHIFT = 18;

__global__ void __launch_bounds__(EMIT_BLOCK)
    emit_compact_kernel(const uint32_t* __restrict__ depth_q, const uint32_t* __restrict__ rect,
                        const uint32_t* __restrict__ words, int64_t n, int slots, int tx_tiles,
                        int depth_bits, uint32_t* __restrict__ keys,
                        uint32_t* __restrict__ out_words, int64_t capacity,
                        OrderedScratch s) {
  __shared__ BlockAppend<EMIT_BLOCK> append;
  __shared__ uint32_t stage[5][EMIT_STAGE];
  const int64_t i0 = (int64_t)append.take(s) * EMIT_SPLATS + threadIdx.x;
  const uint32_t slot_mask = (1u << slots) - 1u;
  uint32_t r[EMIT_PER_THREAD], dq[EMIT_PER_THREAD], w[EMIT_PER_THREAD][4];
#pragma unroll
  for (int k = 0; k < EMIT_PER_THREAD; ++k) {
    const int64_t i = i0 + k * EMIT_BLOCK;
    r[k] = i < n ? rect[i] : 0u;
  }
  int count = 0;
#pragma unroll
  for (int k = 0; k < EMIT_PER_THREAD; ++k) {
    const int64_t i = i0 + k * EMIT_BLOCK;
    const uint32_t mask = (r[k] >> EMIT_MASK_SHIFT) & slot_mask;
    count += __popc(mask);
    dq[k] = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) w[k][c] = 0u;
    if (mask != 0u) {
      dq[k] = depth_q[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[k][c] = words[c * n + i];
    }
  }

  int local = append.reserve(count, s) - append.base;
  const int64_t base = append.base;
  const int total = append.total;
#pragma unroll
  for (int k = 0; k < EMIT_PER_THREAD; ++k) {
    const uint32_t mask = (r[k] >> EMIT_MASK_SHIFT) & slot_mask;
    if (mask == 0u) continue;
    const int tx0 = (int)(r[k] & 0x7Fu);
    const int ty0 = (int)((r[k] >> 7) & 0x7Fu);
    const int w_t = max((int)((r[k] >> 14) & 0xFu), 1);
    for (int j = 0; j < slots; ++j) {
      if (!((mask >> j) & 1u)) continue;
      const int dy = j / w_t;
      const uint32_t tile = (uint32_t)((ty0 + dy) * tx_tiles + tx0 + (j - dy * w_t));
      const uint32_t key = (tile << depth_bits) | dq[k];
      if (local < EMIT_STAGE) {
        stage[0][local] = key;
#pragma unroll
        for (int c = 0; c < 4; ++c) stage[1 + c][local] = w[k][c];
      } else if (base + local < capacity) {
        keys[base + local] = key;
#pragma unroll
        for (int c = 0; c < 4; ++c) out_words[c * capacity + base + local] = w[k][c];
      }
      ++local;
    }
  }
  __syncthreads();

  // the block's staged run, coalesced, one plane at a time
  const int64_t room = capacity - base;
  int run = min(total, EMIT_STAGE);
  if (room < run) run = room > 0 ? (int)room : 0;
  for (int q = threadIdx.x; q < run; q += EMIT_BLOCK) keys[base + q] = stage[0][q];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t* plane = out_words + c * capacity + base;
    for (int q = threadIdx.x; q < run; q += EMIT_BLOCK) plane[q] = stage[1 + c][q];
  }
}

}  // namespace ws

extern "C" {

// depth_q, rect: n u32; words: (4, n) u32; keys: capacity u32 and
// out_words: (4, capacity) u32, pre-filled by the caller; scratch:
// scratch_words u64 (stream.cuh; ceil(n / 512) tiles), zeroed here; its
// first int ends at the number of valid instances
int ws_emit_compact(const uint32_t* depth_q, const uint32_t* rect, const uint32_t* words,
                    int64_t n, int slots, int tx_tiles, int depth_bits, uint32_t* keys,
                    uint32_t* out_words, int64_t capacity, void* scratch, int64_t scratch_words,
                    void* stream) {
  if (slots < 1 || slots > 8) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + ws::EMIT_SPLATS - 1) / ws::EMIT_SPLATS;
  const int err = ws::clear_scratch(scratch, scratch_words, 1, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  if (n > 0) {
    ws::emit_compact_kernel<<<(unsigned)tiles, ws::EMIT_BLOCK, 0, (cudaStream_t)stream>>>(
        depth_q, rect, words, n, slots, tx_tiles, depth_bits, keys, out_words, capacity,
        ws::ordered_scratch(scratch, tiles));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
