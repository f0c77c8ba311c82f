// Ordered exact-prefix stream appends, shared by the frontend, the overflow
// walk, the compactions and the packed emission.
//
// Replaces the TPU kernels' sequential SMEM cursor and ordered-overlap DMA
// writer (frontend_pallas.py:263-321), which append in grid order.  On the
// GPU, blocks run in parallel and in no order, so a block cannot simply bump
// a cursor: the atomics' order would decide the order of the output across
// blocks, and with it which rows survive a capacity and the blend order of
// equal sort keys, from one run to the next.  Instead each block reserves
// its run in TILE order, by a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016):
//  - a block takes its tile index from a ticket counter (one atomicAdd) and
//    processes that tile's rows, so tile k's predecessors have all started
//    and will publish: the look-back cannot wait on a block that is not
//    resident;
//  - it scans its threads' counts (cub::BlockScan, a block-level building
//    block), publishes its total as an AGGREGATE status word of its own
//    tile, then one warp walks back over its predecessors' words, 32 at a
//    time, adding aggregates until it meets an inclusive PREFIX; it then
//    publishes its own inclusive prefix;
//  - so tile k's rows precede tile k+1's, on every run.  The output is an
//    exact prefix with no holes; rows past a capacity are not written (the
//    caller counts them as dropped).
// Each status word is one u64: the flags in the top two bits and the count
// below them, so a word is published and read in one access and carries no
// other data with it (relaxed, volatile accesses suffice).  A block with
// several streams (the frontend's instances and clamped rows, the walk's
// instances and giants) keeps one status word per stream and tile, and
// looks back over them in parallel, one warp per stream.  The ticket and
// the status words live in a scratch buffer that the C entry point zeroes
// on the launch's stream (cudaMemsetAsync) before the kernel runs; the same
// buffer holds the kernel's counters, which still end at the TRUE totals,
// past a capacity too (one atomicAdd per block and stream, no order needed).
#pragma once

#include <cstdint>

#include <cub/block/block_scan.cuh>

namespace ws {

constexpr unsigned long long STATUS_AGG = 1ull << 62;     // the tile's own total
constexpr unsigned long long STATUS_PREFIX = 1ull << 63;  // inclusive prefix through the tile
constexpr unsigned long long STATUS_VALUE = STATUS_AGG - 1ull;

// Scratch layout (u64 words): [0, 2) the kernel's int32 counters (up to 4),
// [2] the ticket, [3, 3 + streams * tiles) the status words, stream-major.
constexpr int SCRATCH_HEAD_WORDS = 3;

struct OrderedScratch {
  int* counters;
  unsigned int* ticket;
  unsigned long long* status;
  int tiles;

  __device__ unsigned long long* stream(int s) const { return status + (int64_t)s * tiles; }
};

inline int64_t scratch_words(int streams, int64_t tiles) {
  return SCRATCH_HEAD_WORDS + (int64_t)streams * tiles;
}

inline OrderedScratch ordered_scratch(void* scratch, int64_t tiles) {
  auto* w = (unsigned long long*)scratch;
  return OrderedScratch{(int*)w, (unsigned int*)(w + 2), w + SCRATCH_HEAD_WORDS, (int)tiles};
}

// Zero the scratch on the stream; 0 or a cudaError_t.  words_given: the
// buffer's size, which must cover `streams` status words per tile.
inline int clear_scratch(void* scratch, int64_t words_given, int streams, int64_t tiles,
                         cudaStream_t stream) {
  const int64_t need = scratch_words(streams, tiles);
  if (scratch == nullptr || words_given < need) return (int)cudaErrorInvalidValue;
  return (int)cudaMemsetAsync(scratch, 0, (size_t)need * 8u, stream);
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long w) {
  *(volatile unsigned long long*)word = w;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* word) {
  return *(const volatile unsigned long long*)word;
}

// Collective over one warp: publishes tile's total, walks back to the
// nearest inclusive prefix and publishes tile's own.  Returns the tile's
// exclusive prefix (the stream's row count before it) to every lane.
__device__ __forceinline__ long long lookback(unsigned long long* status, int tile,
                                              unsigned long long total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(&status[0], STATUS_PREFIX | total);
    return 0;
  }
  if (lane == 0) publish(&status[tile], STATUS_AGG | total);
  unsigned long long excl = 0;
  for (int nearest = tile - 1;; nearest -= 32) {
    const int j = nearest - lane;  // lane 0 holds the nearest predecessor
    unsigned long long w = STATUS_PREFIX;  // before tile 0: a prefix of 0
    if (j >= 0) {
      w = peek(&status[j]);
      while (!(w & (STATUS_AGG | STATUS_PREFIX))) {  // not published yet
        __nanosleep(32);
        w = peek(&status[j]);
      }
    }
    __syncwarp();
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w & STATUS_PREFIX) != 0);
    // lanes up to the nearest prefix add in; the ones past it are in it
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned long long v = lane <= stop ? (w & STATUS_VALUE) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (prefixes) break;
  }
  if (lane == 0) publish(&status[tile], STATUS_PREFIX | (excl + total));
  return (long long)excl;
}

// The block's tile: thread 0 takes a ticket, every thread gets it.
// Collective; call once per block, before the tile's rows are read.
__device__ __forceinline__ int take_tile(unsigned int* ticket, int* slot) {
  if (threadIdx.x == 0) *slot = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  return *slot;
}

// A block whose tile has no rows in any stream: publishes a total of 0
// (thread 0) so that its successors' look-backs pass it.
__device__ __forceinline__ void skip_tile(const OrderedScratch& s, int tile, int streams) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < streams; ++k)
      publish(&s.stream(k)[tile], (tile == 0 ? STATUS_PREFIX : STATUS_AGG) | 0ull);
  }
}

// One stream, one reservation per tile.
template <int BLOCK>
struct BlockAppend {
  using Scan = cub::BlockScan<int, BLOCK>;
  typename Scan::TempStorage scan;
  int tile;   // the block's tile (valid after take)
  int base;   // the block's first global row (valid after reserve)
  int total;  // the block's row count (valid after reserve)

  __device__ __forceinline__ int take(const OrderedScratch& s) { return take_tile(s.ticket, &tile); }

  // Collective: every thread of the block calls it once, with its row
  // count.  Returns the global index of this thread's first row; counter
  // (*s.counters) ends at the stream's true total.
  __device__ __forceinline__ int reserve(int count, const OrderedScratch& s) {
    int excl, sum;
    Scan(scan).ExclusiveSum(count, excl, sum);
    publish(sum, s);
    return base + excl;
  }

  // Collective, for a block whose rows come in two halves: thread t's
  // count0 rows lie in the first half, in thread order, and its count1
  // rows in the second, in thread order (each half's sum < 2^16).  One
  // scan of the two counts packed in one int; returns the global index of
  // this thread's first row in each half.
  __device__ __forceinline__ int2 reserve_halves(int count0, int count1,
                                                 const OrderedScratch& s) {
    int excl, sum;
    Scan(scan).ExclusiveSum(count0 | (count1 << 16), excl, sum);
    const int sum0 = sum & 0xFFFF;
    publish(sum0 + (sum >> 16), s);
    return make_int2(base + (excl & 0xFFFF), base + sum0 + (excl >> 16));
  }

  // The block's total: its base by look-back, the stream's counter.
  __device__ __forceinline__ void publish(int sum, const OrderedScratch& s) {
    if (threadIdx.x < 32) {
      const long long b = lookback(s.stream(0), tile, (unsigned long long)sum);
      if (threadIdx.x == 0) {
        base = (int)b;
        total = sum;
        if (sum > 0) atomicAdd(s.counters, sum);
      }
    }
    __syncthreads();
  }
};

}  // namespace ws
