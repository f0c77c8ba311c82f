// Stable sort of the frame's instance stream by screen-tile bucket first,
// over its live rows only: the count-following sort.
//
// Replaces the JAX frame's sort (websplat_tpu/ops/sort.py:sort_instances
// with n_valid, its prefix ladder _ladder_sort: lax.sort over the smallest
// of 16 prefix rungs that covers the device-side count, picked by
// lax.switch).  It is an XLA op there, not a Pallas kernel; the reference's
// own radix sort (radix_sort.wgsl, driven by GPURSSorter::
// record_sort_indirect) launches for the capacity and reads the live count
// from device memory, and so does this one: no host read, no device-side
// branch around a launch, a fixed number of launches, so a captured frame
// (render/graph.py) replays it as it is.
//
// Input: the frame's stream buffer (render/renderer.py:FrameStream): keys
// (T,) u32 and 4 word rows, cut into S static segments (offset_s,
// capacity_s); segment s holds live_s = min(emitted_s, capacity_s)
// instances at its head, emitted_s read from the device.  The live rows,
// segment by segment in buffer order, are n = sum live_s rows; the sort
// orders them by key, stably, so the result equals a stable sort of the
// whole buffer on [0, n) (every live key is below the 0xFFFFFFFF sentinel).
// Output: the keys mapped to int32 (key ^ 0x80000000, ops/sort.py:map_keys)
// with rows [n, T) the mapped sentinel, and the 4 words of rows [0, n) in
// the same order (the words' tail is not written).
//
// What bounds it: bytes.  The function reads 20 B and writes 20 B per live
// row and 4 B per tail row (utils/roofline.py:sort_work).  The design is a
// hybrid MSD/LSD radix sort (Stehle & Jacobsen, SIGMOD 2017): one global
// pass on the key's top bits, then each bucket sorted on chip.
//  - The bucket is the key's top BUCKET_BITS bits.  The frame key is
//    tile << depth_bits | depth_q (config.py:key_bits), so at 1200x799 (950
//    tiles, 10 tile bits; depth_q's top bit is the f32 sign of a clamped z,
//    0) a bucket is one screen tile; above 11 tile bits it holds several
//    tiles, which is still exact.
//  - live_sort_count_kernel reads the live rows' keys through the segment
//    table and counts the buckets (shared-memory counters, one global add
//    per bin and block), zeroes the scatter's status words of the live
//    tiles and writes the output keys' sentinel tail; the last block to
//    finish turns the counts into each bucket's first output row and
//    counts the non-empty buckets and the largest (the sort's counter).
//  - live_sort_scatter_kernel, the only global pass over the rows, takes
//    tiles of SORT_TILE live rows by ticket (stream.cuh:take_tile), ranks
//    each row within its bucket in row order (a warp holds its contiguous
//    rows; __match_any_sync groups its equal buckets; 16-bit counters, one
//    array per warp), publishes the tile's bucket counts, stages the tile's
//    keys and 16-byte records (the 4 words, copied from the buffer's 4 rows
//    by cp.async) in shared memory in (bucket, row) order, reserves each
//    bucket's run in TILE order by a decoupled look-back over one status
//    word per (tile, bucket) (Merrill & Garland 2016), and writes each run
//    contiguously, key and record, once.  Equal keys keep their order
//    across blocks, never the atomics' order: the sort is stable and the
//    same on every run.
//  - live_sort_local_kernel: persistent blocks take buckets by ticket, the
//    largest size class first, fetching the next bucket's keys into L2
//    meanwhile.  A bucket is sorted stably on the bits of key - (its least
//    key) only: 8-bit LSD passes in shared memory (warp ranks as the
//    scatter's), none for a bucket with one distinct key, at most three
//    (the bucket fixes the top 11 bits).  Nothing is read from device
//    memory at a random place: a 16-byte read there costs a whole request
//    to L2, and L2 serves too few of those a second for every row of a
//    sort (PERF.md §6).  So a bucket of at most WHOLE_CAPACITY rows is held
//    whole, keys and records staged by cp.async, sorted and written out
//    from shared memory.  A larger one (up to local_capacity(passes) rows)
//    runs its passes on 6 B a row: key - min as 16 bits where it fits
//    them, a packed word (the bits above pass 0's digit and a 15-bit
//    index), the last pass's 16-bit index; then its columns (the records'
//    word pairs or words, then the keys) are staged in shared memory in
//    turn and written out coalesced.
//  - The oversize route, inside the same kernel: a bucket of more rows
//    than local_capacity(its passes) runs the same passes with its keys
//    and indices in global memory (held in L2): the output words' rows 1-3
//    and the output keys over the bucket's own output range, which the
//    bucket alone writes; its words are then gathered.  No launch is added
//    and no scratch grows; the counter says how many rows took it.
// Every kernel runs a grid of at most as many blocks as the card holds at
// once, sized from T (the count kernel by stride, the scatter by ticket
// over the live tiles, the local sort by ticket over the non-empty
// buckets), so no block is launched only to find nothing to do.  Nothing
// is allocated here: the wrapper passes one scratch buffer (the bucketed
// records and keys, then the head: the buckets' first rows, the tickets,
// the counter), and the scatter's status words lie in the output words,
// which nothing else writes before the local sort; the entry point zeroes
// the head with cudaMemsetAsync and the count kernel zeroes the status
// words of the live tiles.
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "cp_async.cuh"
#include "stream.cuh"

namespace ws {

constexpr int SORT_BLOCK = 512;  // the count and scatter kernels
constexpr int SORT_WARPS = SORT_BLOCK / 32;
constexpr int SORT_ITEMS = 16;  // rows per thread of a scatter tile
constexpr int SORT_WARP_ROWS = 32 * SORT_ITEMS;
constexpr int SORT_TILE = SORT_BLOCK * SORT_ITEMS;
constexpr int COUNT_ROWS = 8;  // rows per thread the count kernel loads at once
constexpr int MAX_SEGMENTS = 8;
// the bucket: the key's top BUCKET_BITS bits; thread t of a count or
// scatter block owns buckets [BINS * t, BINS * (t + 1))
constexpr int BUCKET_BITS = 11;
constexpr int BUCKET_SHIFT = 32 - BUCKET_BITS;
constexpr int BUCKETS = 1 << BUCKET_BITS;
constexpr int BINS = BUCKETS / SORT_BLOCK;
static_assert(BINS == 4, "a thread's buckets are one 16-byte status read");
// the local sort: passes in rounds of at most LOCAL_ROUND rows, at most
// LOCAL_ITEMS a thread
constexpr int LOCAL_BLOCK = 512;
constexpr int LOCAL_WARPS = LOCAL_BLOCK / 32;
constexpr int LOCAL_ITEMS = 16;
constexpr int LOCAL_ROUND = LOCAL_BLOCK * LOCAL_ITEMS;
constexpr int LOCAL_DIGIT_BITS = 8;
constexpr int LOCAL_RADIX = 1 << LOCAL_DIGIT_BITS;
constexpr int LOCAL_MAX_PASSES = (BUCKET_SHIFT + LOCAL_DIGIT_BITS - 1) / LOCAL_DIGIT_BITS;
constexpr int SWEEP_ITEMS = 16;  // keys per thread a sweep of a bucket loads at once
constexpr int FINAL_ITEMS = 8;  // rows per thread the gathering final write loads at once
// rows a block sorts in shared memory: a bucket of one or two passes keeps
// a packed word (the bits of key - min above pass 0's digit, then the
// row's local index) and the last pass's 16-bit index, 6 B a row; one of
// three passes two packed words, 8 B a row, in the same bytes
constexpr int INDEX_BITS = 15;
constexpr int LOCAL_CAPACITY = 1 << INDEX_BITS;
constexpr int LOCAL_CAPACITY_3 = LOCAL_CAPACITY * 6 / 8;
constexpr int LOCAL_BUFFER_BYTES = LOCAL_CAPACITY * 6;

__host__ __device__ constexpr int local_capacity(int passes) {
  return passes <= 2 ? LOCAL_CAPACITY : LOCAL_CAPACITY_3;
}
// rows a block holds whole in shared memory, keys and records with the
// passes' buffers (16 + 4 + 4 + 4 B a row), so that it writes its output
// with no read from device memory at a random place (a 16-byte read there
// costs a whole request to L2: the rows of a sort are too many for that)
constexpr int WHOLE_CAPACITY = 7008;
static_assert(WHOLE_CAPACITY * 28 <= LOCAL_BUFFER_BYTES, "a whole chunk fits the buffers");
// the passes' histograms, two entries a thread (the last unused)
constexpr int HIST_ENTRIES = 2 * LOCAL_BLOCK;
// the final write of a bucket past WHOLE_CAPACITY stages columns (its
// records' words, then its keys) in the buffers' bytes that its indices
// leave
constexpr int STAGE_BYTES = LOCAL_CAPACITY * 4;
static_assert(BUCKET_SHIFT - LOCAL_DIGIT_BITS + INDEX_BITS <= 32, "the packed word fits 32 bits");
static_assert(LOCAL_RADIX <= LOCAL_BLOCK && LOCAL_MAX_PASSES * LOCAL_RADIX <= 2 * LOCAL_BLOCK,
              "a thread per digit, two entries of the histograms a thread");
// scratch head (int32 words): the buckets' counts (then their first output
// rows), the two tickets, the count blocks' done count, the counter
constexpr int TICKET_SCATTER = BUCKETS;
constexpr int TICKET_LOCAL = BUCKETS + 1;
constexpr int COUNT_DONE = BUCKETS + 2;
// the counter: non-empty buckets, the largest, rows sorted on chip (the
// one-key buckets' copies included), rows through the oversize route
constexpr int SORT_STATS = BUCKETS + 3;
constexpr int STAT_BUCKETS = 0, STAT_LARGEST = 1, STAT_ON_CHIP = 2, STAT_OVERSIZE = 3;
constexpr int SORT_HEAD_WORDS = BUCKETS + 8;
// status words: the flags in the top two bits, the bucket's count below
constexpr unsigned RUN_AGG = 1u << 30;
constexpr unsigned RUN_PREFIX = 1u << 31;
constexpr unsigned RUN_VALUE = RUN_AGG - 1u;
constexpr uint32_t MAPPED_SENTINEL = 0x7FFFFFFFu;  // 0xFFFFFFFF ^ 0x80000000
static_assert(SORT_TILE <= 0xFFFF, "ranks and staged rows fit 16 bits");

__device__ __forceinline__ int bucket_of(uint32_t key) { return (int)(key >> BUCKET_SHIFT); }

struct Segments {
  int count;
  int offset[MAX_SEGMENTS];
  int capacity[MAX_SEGMENTS];
};

// The live-row table in shared memory: pre[s] live rows before segment s,
// pre[count] = n; off[s] the segment's first buffer row.  Collective.
struct LiveTable {
  int pre[MAX_SEGMENTS + 1];
  int off[MAX_SEGMENTS];
  int count;

  // one thread fills it
  __device__ __forceinline__ void fill(const Segments& seg, const int* __restrict__ emitted) {
    int acc = 0;
    pre[0] = 0;
    for (int s = 0; s < seg.count; ++s) {
      acc += min(max(emitted[s], 0), seg.capacity[s]);
      pre[s + 1] = acc;
      off[s] = seg.offset[s];
    }
    count = seg.count;
  }

  __device__ __forceinline__ void load(const Segments& seg, const int* __restrict__ emitted) {
    if (threadIdx.x == 0) fill(seg, emitted);
    __syncthreads();
  }

  __device__ __forceinline__ int n() const { return pre[count]; }

  // buffer row of live row i (0 <= i < n)
  __device__ __forceinline__ int row(int i) const {
    int s = 0;
    while (s + 1 < count && i >= pre[s + 1]) ++s;
    return off[s] + (i - pre[s]);
  }
};

__device__ __forceinline__ int live_tiles(int n) { return (n + SORT_TILE - 1) / SORT_TILE; }

// The output keys' sentinel tail [n, T), by the grid's threads in turn,
// 16 bytes a store past the first 16-byte boundary: nothing else writes
// past n.
__device__ __forceinline__ void write_tail(uint32_t* __restrict__ keys_out, int n, int64_t rows) {
  const int64_t thread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t lo = min((int64_t)(n + 3) / 4 * 4, rows), hi = lo + (rows - lo) / 4 * 4;
  if (thread < lo - n) keys_out[n + thread] = MAPPED_SENTINEL;
  if (thread < rows - hi) keys_out[hi + thread] = MAPPED_SENTINEL;
  const uint4 s4 = make_uint4(MAPPED_SENTINEL, MAPPED_SENTINEL, MAPPED_SENTINEL, MAPPED_SENTINEL);
  for (int64_t j = lo / 4 + thread; j < hi / 4; j += threads)
    reinterpret_cast<uint4*>(keys_out)[j] = s4;
}

__global__ void __launch_bounds__(SORT_BLOCK)
    live_sort_count_kernel(const uint32_t* __restrict__ keys, Segments seg,
                           const int* __restrict__ emitted, unsigned* __restrict__ head,
                           unsigned* __restrict__ status, int status_tiles,
                           uint32_t* __restrict__ keys_out, int64_t rows) {
  using Scan = cub::BlockScan<int, SORT_BLOCK>;
  __shared__ unsigned h[BUCKETS];
  __shared__ LiveTable live;
  __shared__ typename Scan::TempStorage scan;
  __shared__ bool last;
  live.load(seg, emitted);
  const int n = live.n(), tiles = live_tiles(n);
  write_tail(keys_out, n, rows);
  if ((int)blockIdx.x >= tiles) return;  // block-uniform
  const int blocks = min((int)gridDim.x, tiles);
  for (int j = threadIdx.x; j < BUCKETS; j += SORT_BLOCK) h[j] = 0u;
  // the live tiles' status words (those a successor reads): the scatter's
  // look-backs start from zero
  const int64_t zero_words = (int64_t)min(tiles, status_tiles) * BUCKETS / 4;
  for (int64_t j = (int64_t)blockIdx.x * SORT_BLOCK + threadIdx.x; j < zero_words;
       j += (int64_t)blocks * SORT_BLOCK)
    reinterpret_cast<uint4*>(status)[j] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int64_t start = (int64_t)blockIdx.x * SORT_TILE; start < n;
       start += (int64_t)blocks * SORT_TILE) {
    for (int r0 = 0; r0 < SORT_ITEMS; r0 += COUNT_ROWS) {
      uint32_t k[COUNT_ROWS];
#pragma unroll
      for (int r = 0; r < COUNT_ROWS; ++r) {
        const int64_t i = start + (r0 + r) * SORT_BLOCK + threadIdx.x;
        k[r] = i < n ? __ldg(keys + live.row((int)i)) : 0u;
      }
#pragma unroll
      for (int r = 0; r < COUNT_ROWS; ++r)
        if (start + (r0 + r) * SORT_BLOCK + threadIdx.x < n) atomicAdd(&h[bucket_of(k[r])], 1u);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < BUCKETS; j += SORT_BLOCK)
    if (h[j]) atomicAdd(&head[j], h[j]);
  // the last block to finish turns the counts into each bucket's first
  // output row and counts the non-empty buckets and the largest
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&head[COUNT_DONE], 1u) == (unsigned)blocks - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int base = threadIdx.x * BINS;
  int x[BINS], y[BINS], nonempty = 0, largest = 0;
#pragma unroll
  for (int i = 0; i < BINS; ++i) {
    x[i] = (int)__ldcg(head + base + i);
    nonempty += x[i] > 0;
    largest = max(largest, x[i]);
  }
  Scan(scan).ExclusiveSum(x, y);
#pragma unroll
  for (int i = 0; i < BINS; ++i) head[base + i] = (unsigned)y[i];
  if (nonempty) atomicAdd(&head[SORT_STATS + STAT_BUCKETS], (unsigned)nonempty);
  if (largest) atomicMax(&head[SORT_STATS + STAT_LARGEST], (unsigned)largest);
}

// One 16-byte read or write of a thread's BINS status words (volatile:
// other blocks publish them while this one waits)
struct Status {
  unsigned w[BINS];
};

__device__ __forceinline__ Status load_status(const unsigned* p) {
  Status v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.w[0]), "=r"(v.w[1]), "=r"(v.w[2]), "=r"(v.w[3])
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, const Status& v) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.w[0]),
               "r"(v.w[1]), "r"(v.w[2]), "r"(v.w[3])
               : "memory");
}

// Thread t, for its BINS buckets, after the tile's counts are published:
// walks back over its predecessors' words to the nearest inclusive prefix
// of each bucket, LOOKBACK_SPAN tiles per round trip, and publishes its
// own where a successor reads it.  excl[i]: the bucket's rows in the tiles
// before this one.
constexpr int LOOKBACK_SPAN = 8;

__device__ __forceinline__ void bucket_lookback(unsigned* __restrict__ status, int tile,
                                                int status_tiles, const int (&total)[BINS],
                                                int (&excl)[BINS]) {
  unsigned* col = status + BINS * threadIdx.x;
#pragma unroll
  for (int i = 0; i < BINS; ++i) excl[i] = 0;
  if (tile == 0) return;  // published as a prefix already
  bool found[BINS] = {};
  int left = BINS;
  for (int j = tile - 1; left; j -= LOOKBACK_SPAN) {
    Status w[LOOKBACK_SPAN];
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u) {  // before tile 0: a prefix of 0
      if (j - u >= 0) {
        w[u] = load_status(col + (int64_t)(j - u) * BUCKETS);
      } else {
#pragma unroll
        for (int i = 0; i < BINS; ++i) w[u].w[i] = RUN_PREFIX;
      }
    }
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u) {
      if (!left) break;
      for (;;) {  // until every bucket still walking is published in tile j - u
        bool ready = true;
#pragma unroll
        for (int i = 0; i < BINS; ++i)
          ready &= found[i] || (w[u].w[i] & (RUN_AGG | RUN_PREFIX)) != 0u;
        if (ready) break;
        __nanosleep(32);
        w[u] = load_status(col + (int64_t)(j - u) * BUCKETS);
      }
#pragma unroll
      for (int i = 0; i < BINS; ++i) {
        const unsigned v = w[u].w[i];
        if (!found[i]) {
          excl[i] += (int)(v & RUN_VALUE);
          if (v & RUN_PREFIX) {
            found[i] = true;
            --left;
          }
        }
      }
    }
  }
  if (tile < status_tiles) {
    Status v;
#pragma unroll
    for (int i = 0; i < BINS; ++i) v.w[i] = RUN_PREFIX | (unsigned)(excl[i] + total[i]);
    store_status(col + (int64_t)tile * BUCKETS, v);
  }
}

struct ScatterArgs {
  const uint32_t* keys;   // the stream buffer's keys
  const uint32_t* words;  // its 4 word rows, words_ld apart
  int64_t words_ld;
  const unsigned* first;  // each bucket's first output row (the count kernel's scan)
  unsigned* ticket;
  unsigned* status;  // tile t's bucket b at t * BUCKETS + b, for t < status_tiles
  int status_tiles;
  uint32_t* keys_b;  // the bucketed keys and records
  uint4* recs_b;
  Segments seg;
  const int* emitted;
};

// dynamic shared memory of the scatter: the warps' 16-bit counters, which
// the staged tile (records, then keys) overwrites, then one int per bucket
constexpr int SCATTER_COUNT_BYTES = SORT_WARPS * BUCKETS * 2;
constexpr int SCATTER_STAGE_BYTES = SORT_TILE * (16 + 4);
constexpr int SCATTER_BIG_BYTES =
    SCATTER_COUNT_BYTES > SCATTER_STAGE_BYTES ? SCATTER_COUNT_BYTES : SCATTER_STAGE_BYTES;
constexpr int SCATTER_SMEM_BYTES = SCATTER_BIG_BYTES + BUCKETS * 4;

__global__ void __launch_bounds__(SORT_BLOCK, 1) live_sort_scatter_kernel(ScatterArgs a) {
  __shared__ typename cub::BlockScan<int, SORT_BLOCK>::TempStorage scan;
  __shared__ LiveTable live;
  __shared__ int s_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* count = reinterpret_cast<unsigned short*>(smem);  // [SORT_WARPS][BUCKETS]
  auto* stage_rec = reinterpret_cast<uint4*>(smem);       // [SORT_TILE], over the counters
  auto* stage_key = reinterpret_cast<uint32_t*>(smem + SORT_TILE * 16);  // [SORT_TILE]
  auto* run = reinterpret_cast<int*>(smem + SCATTER_BIG_BYTES);          // [BUCKETS]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (t == 0) {  // the first ticket and the live rows, one round trip
    s_tile = (int)atomicAdd(a.ticket, 1u);
    live.fill(a.seg, a.emitted);
  }
  int gfirst[BINS];  // this thread's buckets' first output rows
#pragma unroll
  for (int i = 0; i < BINS; ++i) gfirst[i] = (int)a.first[BINS * t + i];
  __syncthreads();
  const int n = live.n(), tiles = live_tiles(n);
  unsigned short* wc = count + warp * BUCKETS;

  // tiles by ticket (take_tile's barrier also orders the smem's reuse);
  // block-uniform: past the last live tile every tile is taken
  for (int tile = s_tile; tile < tiles; tile = take_tile(a.ticket, &s_tile)) {
    const int64_t start = (int64_t)tile * SORT_TILE;
    const int m = (int)min((int64_t)SORT_TILE, n - start);  // live rows in the tile
    // warp w holds tile rows [w * W, (w + 1) * W) (W = SORT_WARP_ROWS),
    // round r lane l row w * W + 32 r + l: ranks within the warp run in row
    // order; every key load issued before any is used
    uint32_t key[SORT_ITEMS];
    int row[SORT_ITEMS];
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
      key[r] = 0u;
      row[r] = 0;
      if (j < m) {
        row[r] = live.row((int)start + j);
        key[r] = a.keys[row[r]];
      }
    }
    for (int d = lane; d < BUCKETS / 2; d += 32) reinterpret_cast<unsigned*>(wc)[d] = 0u;
    __syncwarp();
    unsigned rank[SORT_ITEMS / 2];  // two 16-bit ranks per word
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      const bool valid = warp * SORT_WARP_ROWS + r * 32 + lane < m;
      const int d = valid ? bucket_of(key[r]) : BUCKETS;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const unsigned before = valid ? wc[d] : 0u;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) wc[d] = (unsigned short)(before + __popc(peers));
      __syncwarp();
      const unsigned rk = before + __popc(peers & lt);
      if (r & 1) rank[r >> 1] |= rk << 16;
      else rank[r >> 1] = rk;
    }
    __syncthreads();

    // per bucket of this thread: the warps' first ranks, the tile's count,
    // published at once, and its first row in the staged tile (a scan of
    // the counts; thread t's buckets are consecutive, so a blocked scan)
    int total[BINS] = {}, first[BINS];
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {  // BINS 16-bit counters, two a word
      auto* c = reinterpret_cast<unsigned*>(count + w * BUCKETS + BINS * t);
#pragma unroll
      for (int h = 0; h < BINS / 2; ++h) {
        const unsigned v = c[h];
        c[h] = (unsigned)total[2 * h] | (unsigned)total[2 * h + 1] << 16;
        total[2 * h] += (int)(v & 0xFFFFu);
        total[2 * h + 1] += (int)(v >> 16);
      }
    }
    if (tile < a.status_tiles) {
      const unsigned flag = tile == 0 ? RUN_PREFIX : RUN_AGG;
      Status v;
#pragma unroll
      for (int i = 0; i < BINS; ++i) v.w[i] = flag | (unsigned)total[i];
      store_status(a.status + (int64_t)tile * BUCKETS + BINS * t, v);
    }
    cub::BlockScan<int, SORT_BLOCK>(scan).ExclusiveSum(total, first);
#pragma unroll
    for (int i = 0; i < BINS; ++i) run[BINS * t + i] = first[i];
    __syncthreads();
    // each row's place in the staged tile
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      if (warp * SORT_WARP_ROWS + r * 32 + lane < m) {
        const int d = bucket_of(key[r]);
        const unsigned s =
            run[d] + count[warp * BUCKETS + d] + (rank[r >> 1] >> (16 * (r & 1)) & 0xFFFFu);
        rank[r >> 1] = (r & 1) ? (rank[r >> 1] & 0xFFFFu) | (s << 16)
                               : (rank[r >> 1] & 0xFFFF0000u) | s;
      }
    }
    __syncthreads();  // the counters and first rows are read: overwritten below
    // the staged tile: keys from registers, the 4 words of each row copied
    // from the buffer's 4 rows straight into its record
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      if (warp * SORT_WARP_ROWS + r * 32 + lane < m) {
        const unsigned s = rank[r >> 1] >> (16 * (r & 1)) & 0xFFFFu;
        stage_key[s] = key[r];
        auto* rec = reinterpret_cast<uint32_t*>(stage_rec + s);
#pragma unroll
        for (int w = 0; w < 4; ++w) cp_async4(rec + w, a.words + w * a.words_ld + row[r]);
      }
    }
    // the buckets' runs in the tiles before this one (while the copies
    // land), then each bucket's output row minus its staged row
    int excl[BINS];
    bucket_lookback(a.status, tile, a.status_tiles, total, excl);
#pragma unroll
    for (int i = 0; i < BINS; ++i) run[BINS * t + i] = gfirst[i] + excl[i] - first[i];
    cp_async_wait_all();
    __syncthreads();

    // staged row j goes to run[bucket] + j: each bucket's run is contiguous
    for (int j = t; j < m; j += SORT_BLOCK) {
      const uint32_t k = stage_key[j];
      const int pos = run[bucket_of(k)] + j;
      a.keys_b[pos] = k;
      a.recs_b[pos] = stage_rec[j];
    }
  }
}

struct LocalArgs {
  const uint32_t* keys_b;  // the bucketed keys and records (the scatter's)
  const uint4* recs_b;
  const unsigned* first;  // each bucket's first row
  unsigned* ticket;
  unsigned* stats;  // the counter
  uint32_t* keys_out;
  uint32_t* words_out;  // 4 rows, out_ld apart
  int64_t out_ld;
  Segments seg;
  const int* emitted;
};

// dynamic shared memory of the local sort: the passes' buffers, the warps'
// 16-bit digit counters, the digit histograms (then their first rows),
// each digit's first row in the current round and the order in which the
// buckets are taken
constexpr int LOCAL_SMEM_BYTES = LOCAL_BUFFER_BYTES + LOCAL_WARPS * LOCAL_RADIX * 2 +
                                 HIST_ENTRIES * 4 + LOCAL_RADIX * 4 + BUCKETS * 2;

// One stable LSD pass over m rows on the digit that load gives.  Rows in
// rounds of at most LOCAL_ROUND: a round of k rows gives each warp I =
// ceil(k / LOCAL_BLOCK) items a lane (so a short round ranks in few steps),
// warp w holding round rows [w * 32 I, (w + 1) * 32 I), item r of lane l
// row 32 (w I + r) + l, so ranks within a warp run in row order; thread d
// < LOCAL_RADIX keeps digit d's next output row in carry (its first: the
// histogram's scan), or, given scan (m <= LOCAL_ROUND: one round), finds it
// from the round's own counts.  load(j, digit) returns row j's payload and
// sets its digit; store(dest, payload) writes it.  Collective; ends with a
// barrier.
using LocalScan = cub::BlockScan<int, LOCAL_BLOCK>;

template <class P, class Load, class Store>
__device__ __forceinline__ void local_pass(int m, int carry, unsigned short* count, int* round_first,
                                           typename LocalScan::TempStorage* scan, Load load,
                                           Store store) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  unsigned short* wc = count + warp * LOCAL_RADIX;
  for (int base = 0; base < m; base += LOCAL_ROUND) {
    const int items = (min(LOCAL_ROUND, m - base) + LOCAL_BLOCK - 1) / LOCAL_BLOCK;
    P pl[LOCAL_ITEMS];
    int dg[LOCAL_ITEMS];
#pragma unroll
    for (int r = 0; r < LOCAL_ITEMS; ++r) {
      const int j = base + 32 * (warp * items + r) + lane;
      dg[r] = LOCAL_RADIX;
      if (r < items && j < m) pl[r] = load(j, dg[r]);
    }
    for (int d = lane; d < LOCAL_RADIX / 2; d += 32) reinterpret_cast<unsigned*>(wc)[d] = 0u;
    __syncwarp();
    unsigned short rank[LOCAL_ITEMS];
#pragma unroll
    for (int r = 0; r < LOCAL_ITEMS; ++r) {
      if (r >= items) break;  // warp-uniform
      const bool valid = dg[r] < LOCAL_RADIX;
      const unsigned peers = __match_any_sync(0xffffffffu, dg[r]);
      const unsigned before = valid ? wc[dg[r]] : 0u;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) wc[dg[r]] = (unsigned short)(before + __popc(peers));
      __syncwarp();
      rank[r] = (unsigned short)(before + __popc(peers & lt));
    }
    __syncthreads();
    int total = 0;
    if (t < LOCAL_RADIX) {  // digit t: the warps' first rows in the round
#pragma unroll
      for (int w = 0; w < LOCAL_WARPS; ++w) {
        const int c = count[w * LOCAL_RADIX + t];
        count[w * LOCAL_RADIX + t] = (unsigned short)total;
        total += c;
      }
    }
    if (scan) LocalScan(*scan).ExclusiveSum(total, carry);  // block-uniform
    if (t < LOCAL_RADIX) {
      round_first[t] = carry;
      carry += total;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < LOCAL_ITEMS; ++r)
      if (r < items && dg[r] < LOCAL_RADIX)
        store(round_first[dg[r]] + count[warp * LOCAL_RADIX + dg[r]] + rank[r], pl[r]);
    __syncthreads();  // the counters are reused by the next round
  }
}

// f(key) for each of m keys (device or shared memory), SWEEP_ITEMS a
// thread at once (the loads of a batch issued before any is used)
template <class F>
__device__ __forceinline__ void sweep_keys(const uint32_t* keys, int m, F f) {
  for (int base = 0; base < m; base += LOCAL_BLOCK * SWEEP_ITEMS) {
    uint32_t k[SWEEP_ITEMS];
#pragma unroll
    for (int r = 0; r < SWEEP_ITEMS; ++r) {
      const int p = base + r * LOCAL_BLOCK + threadIdx.x;
      k[r] = p < m ? keys[p] : 0u;
    }
#pragma unroll
    for (int r = 0; r < SWEEP_ITEMS; ++r)
      if (base + r * LOCAL_BLOCK + (int)threadIdx.x < m) f(k[r]);
  }
}

// the block's requests to fetch [p, p + bytes) into L2, a line each
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes) {
  const char* c = reinterpret_cast<const char*>(p);
  for (int64_t off = (int64_t)threadIdx.x * 128; off < bytes; off += (int64_t)LOCAL_BLOCK * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// The shared state of a local sort block and its collective steps.
struct LocalBlock {
  unsigned char* buf;        // LOCAL_BUFFER_BYTES
  unsigned short* count;     // [WARPS][RADIX]
  int* hist;                 // [HIST_ENTRIES]: each pass's [RADIX]
  int* round_first;          // [RADIX]
  uint32_t* red;             // [2 * WARPS]
  int t, lane, warp;

  // (min, max) of m keys; collective, ends with a barrier
  __device__ __forceinline__ void range(const uint32_t* keys, int m, uint32_t& lo, uint32_t& hi) {
    lo = 0xFFFFFFFFu;
    hi = 0u;
    sweep_keys(keys, m, [&](uint32_t k) {
      lo = min(lo, k);
      hi = max(hi, k);
    });
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      red[warp] = lo;
      red[LOCAL_WARPS + warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < LOCAL_WARPS; ++w) {
      lo = min(lo, red[w]);
      hi = max(hi, red[LOCAL_WARPS + w]);
    }
    __syncthreads();  // red is reused
  }

  // each pass's digit histogram of key - kmin (the order does not change
  // them), then each histogram's first rows (one scan of all of them, each
  // histogram's total before it taken off); with rel16, key - kmin (< 2^16)
  // is kept there for pass 0.  Collective.
  __device__ __forceinline__ void histograms(const uint32_t* keys, int m, uint32_t kmin,
                                             int passes, unsigned short* rel16) {
    for (int j = t; j < HIST_ENTRIES; j += LOCAL_BLOCK) hist[j] = 0;
    __syncthreads();
    int p = t;  // sweep_keys visits row t + LOCAL_BLOCK * k in turn
    sweep_keys(keys, m, [&](uint32_t k) {
      const uint32_t rel = k - kmin;
      if (rel16) rel16[p] = (unsigned short)rel;
      p += LOCAL_BLOCK;
      for (int q = 0; q < passes; ++q)
        atomicAdd(&hist[q * LOCAL_RADIX + (rel >> (LOCAL_DIGIT_BITS * q) & (LOCAL_RADIX - 1))], 1);
    });
    __syncthreads();
    int x[2], y[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = hist[2 * t + i];
    LocalScan(*scan).ExclusiveSum(x, y);
#pragma unroll
    for (int i = 0; i < 2; ++i) hist[2 * t + i] = y[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) base[i] = hist[(2 * t + i) / LOCAL_RADIX * LOCAL_RADIX];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) hist[2 * t + i] = y[i] - base[i];
    __syncthreads();
  }
  typename LocalScan::TempStorage* scan;

  __device__ __forceinline__ int carry(int q) const {
    return t < LOCAL_RADIX ? hist[q * LOCAL_RADIX + t] : 0;
  }

  // The stable LSD passes of m keys (device or shared memory) on the bits
  // of key - kmin (read from rel16 where given: then at most two passes):
  // pass 0 reads the keys and writes packed words to a (or, alone, the
  // indices); a middle pass moves them to b; the last reads its digit from
  // the packed word and writes the 16-bit index, to index (a's bytes for
  // one pass or three, which must then hold 2 B a row).  Returns where the
  // indices are: out row ps is key row index[ps].
  __device__ __forceinline__ const unsigned short* lsd(const uint32_t* keys,
                                                      const unsigned short* rel16, int m,
                                                      uint32_t kmin, int passes, uint32_t* a,
                                                      uint32_t* b, unsigned short* index) {
    constexpr uint32_t INDEX_MASK = (1u << INDEX_BITS) - 1u;
    if (passes != 2) index = reinterpret_cast<unsigned short*>(a);
    // one round a pass: each pass finds its digits' first rows itself
    typename LocalScan::TempStorage* in_round = m <= LOCAL_ROUND ? scan : nullptr;
    auto rel_of = [&](int j) { return rel16 ? (uint32_t)rel16[j] : keys[j] - kmin; };
    if (passes == 1)
      local_pass<uint32_t>(
          m, carry(0), count, round_first, in_round,
          [&](int j, int& d) {
            d = (int)(rel_of(j) & (LOCAL_RADIX - 1));
            return (uint32_t)j;
          },
          [&](int dest, uint32_t j) { index[dest] = (unsigned short)j; });
    else
      local_pass<uint32_t>(
          m, carry(0), count, round_first, in_round,
          [&](int j, int& d) {
            const uint32_t rel = rel_of(j);
            d = (int)(rel & (LOCAL_RADIX - 1));
            return (rel >> LOCAL_DIGIT_BITS) << INDEX_BITS | (uint32_t)j;
          },
          [&](int dest, uint32_t v) { a[dest] = v; });
    if (passes == 3)
      local_pass<uint32_t>(
          m, carry(1), count, round_first, in_round,
          [&](int j, int& d) {
            const uint32_t v = a[j];
            d = (int)(v >> INDEX_BITS & (LOCAL_RADIX - 1));
            return v;
          },
          [&](int dest, uint32_t v) { b[dest] = v; });
    if (passes > 1) {
      const uint32_t* src = passes == 3 ? b : a;
      const int shift = INDEX_BITS + LOCAL_DIGIT_BITS * (passes - 2);
      local_pass<uint32_t>(
          m, carry(passes - 1), count, round_first, in_round,
          [&](int j, int& d) {
            const uint32_t v = src[j];
            d = (int)(v >> shift & (LOCAL_RADIX - 1));
            return v & INDEX_MASK;
          },
          [&](int dest, uint32_t j) { index[dest] = (unsigned short)j; });
    }
    return index;
  }

  // Rows [0, m) of a bucket held whole: its keys and records staged from
  // device memory, sorted, and written to the output's same rows.
  // Collective.
  __device__ __forceinline__ void sort_whole(const uint32_t* keys, const uint4* recs, int m,
                                             uint32_t* keys_out, uint32_t* words_out,
                                             int64_t out_ld) {
    auto* srec = reinterpret_cast<uint4*>(buf);
    auto* skey = reinterpret_cast<uint32_t*>(buf + WHOLE_CAPACITY * 16);
    auto* a = reinterpret_cast<uint32_t*>(buf + WHOLE_CAPACITY * 20);
    auto* x = reinterpret_cast<uint32_t*>(buf + WHOLE_CAPACITY * 24);
    for (int j = t; j < m; j += LOCAL_BLOCK) {
      cp_async4(skey + j, keys + j);
      cp_async16(srec + j, recs + j);
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t lo, hi;
    range(skey, m, lo, hi);
    const int bits = hi > lo ? 32 - __clz((int)(hi - lo)) : 0;
    const int passes = (bits + LOCAL_DIGIT_BITS - 1) / LOCAL_DIGIT_BITS;
    const unsigned short* index = nullptr;
    static_assert(WHOLE_CAPACITY <= LOCAL_ROUND, "a whole chunk's passes take one round");
    if (passes) {
      index = lsd(skey, nullptr, m, lo, passes, a, x, reinterpret_cast<unsigned short*>(x));
    }
    for (int ps = t; ps < m; ps += LOCAL_BLOCK) {
      const int j = index ? index[ps] : ps;
      const uint4 rec = srec[j];
      __stcs(keys_out + ps, skey[j] ^ 0x80000000u);
      __stcs(words_out + ps, rec.x);
      __stcs(words_out + out_ld + ps, rec.y);
      __stcs(words_out + 2 * out_ld + ps, rec.z);
      __stcs(words_out + 3 * out_ld + ps, rec.w);
    }
    __syncthreads();  // the buffers are free
  }

  // A bucket's m rows in their final order, out row ps being bucket row
  // index[ps]: its columns (the records' words in two 8-byte halves where a
  // half fits STAGE_BYTES, else one by one, then the keys) staged in shared
  // memory, as many at once as STAGE_BYTES holds (cp.async, every copy of a
  // round in flight), each written out coalesced from its staged column,
  // so that no row is read from device memory at a random place.
  // Collective.
  __device__ __forceinline__ void write_columns(const uint32_t* keys, const uint4* recs, int m,
                                                const unsigned short* index,
                                                unsigned char* stage, uint32_t* keys_out,
                                                uint32_t* words_out, int64_t ld) {
    const int half = 8 * m <= STAGE_BYTES ? 2 : 1;  // words a record column holds
    const int cols = 4 / half + 1;                  // the last: the keys
    auto width = [&](int c) { return c + 1 < cols ? 4 * half : 4; };
    for (int c0 = 0; c0 < cols;) {
      int c1 = c0, bytes = 0;  // columns [c0, c1) this round, 8-byte ones first
      while (c1 < cols && bytes + width(c1) * m <= STAGE_BYTES) bytes += width(c1++) * m;
      for (int j = t; j < m; j += LOCAL_BLOCK) {
        int off = 0;
        for (int c = c0; c < c1; off += width(c++) * m) {
          if (c + 1 == cols) {
            cp_async4(stage + off + 4 * j, keys + j);
          } else {
            const uint32_t* src = reinterpret_cast<const uint32_t*>(recs + j) + half * c;
            if (half == 2) cp_async8(stage + off + 8 * j, src);
            else cp_async4(stage + off + 4 * j, src);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int ps = t; ps < m; ps += LOCAL_BLOCK) {
        const int j = index[ps];
        int off = 0;
        for (int c = c0; c < c1; off += width(c++) * m) {
          if (c + 1 == cols) {
            __stcs(keys_out + ps, reinterpret_cast<const uint32_t*>(stage + off)[j] ^ 0x80000000u);
          } else if (half == 2) {
            const uint2 v = reinterpret_cast<const uint2*>(stage + off)[j];
            __stcs(words_out + 2 * c * ld + ps, v.x);
            __stcs(words_out + (2 * c + 1) * ld + ps, v.y);
          } else {
            __stcs(words_out + c * ld + ps, reinterpret_cast<const uint32_t*>(stage + off)[j]);
          }
        }
      }
      __syncthreads();  // the stage is reused
      c0 = c1;
    }
  }
};

// A bucket's rows in their final order, out row ps being bucket row
// row(ps, idx) (which also gives its key): each record read from the
// bucket's own range through L2, every load of a thread's rows issued
// before its stores, the stores coalesced.  A thread reads only the rows it
// writes, so row() may read what the stores overwrite.
template <class Row>
__device__ __forceinline__ void gather_rows(const uint4* __restrict__ recs, uint32_t* keys_out,
                                            uint32_t* words_out, int64_t ld, int m, Row row) {
  for (int base = 0; base < m; base += LOCAL_BLOCK * FINAL_ITEMS) {
    uint32_t key[FINAL_ITEMS];
    uint4 rec[FINAL_ITEMS];
#pragma unroll
    for (int r = 0; r < FINAL_ITEMS; ++r) {
      const int ps = base + r * LOCAL_BLOCK + threadIdx.x;
      if (ps < m) {
        int idx;
        key[r] = row(ps, idx);
        rec[r] = __ldcg(recs + idx);
      }
    }
#pragma unroll
    for (int r = 0; r < FINAL_ITEMS; ++r) {
      const int ps = base + r * LOCAL_BLOCK + threadIdx.x;
      if (ps < m) {
        __stcs(keys_out + ps, key[r] ^ 0x80000000u);
        __stcs(words_out + ps, rec[r].x);
        __stcs(words_out + ld + ps, rec[r].y);
        __stcs(words_out + 2 * ld + ps, rec[r].z);
        __stcs(words_out + 3 * ld + ps, rec[r].w);
      }
    }
  }
}

__global__ void __launch_bounds__(LOCAL_BLOCK, 1) live_sort_local_kernel(LocalArgs a) {
  using OrderScan = cub::BlockScan<unsigned long long, LOCAL_BLOCK>;
  constexpr int PER_THREAD = BUCKETS / LOCAL_BLOCK;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LiveTable live;
  __shared__ union {
    typename cub::BlockScan<int, LOCAL_BLOCK>::TempStorage scan;
    typename OrderScan::TempStorage order;
  } temp;
  __shared__ uint32_t red[2 * LOCAL_WARPS];
  __shared__ int s_next, s_buckets;

  const int t = threadIdx.x;
  LocalBlock lb;
  lb.buf = smem;
  lb.count = reinterpret_cast<unsigned short*>(smem + LOCAL_BUFFER_BYTES);
  lb.hist = reinterpret_cast<int*>(lb.count + LOCAL_WARPS * LOCAL_RADIX);
  lb.round_first = lb.hist + HIST_ENTRIES;
  lb.red = red;
  lb.scan = &temp.scan;
  lb.t = t;
  lb.lane = t & 31;
  lb.warp = t >> 5;
  auto* order = reinterpret_cast<unsigned short*>(lb.round_first + LOCAL_RADIX);  // [BUCKETS]
  live.load(a.seg, a.emitted);
  const int n = live.n();
  // the order in which the blocks take the buckets, the same in every
  // block: by size class (over LOCAL_CAPACITY_3 rows, over a quarter of
  // it, over a sixteenth, the rest), largest first, bucket order within a
  // class; empty buckets are not taken.  Thread t: PER_THREAD buckets.
  {
    unsigned long long flag[PER_THREAD], pre[PER_THREAD], agg;
    int cls[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int b = PER_THREAD * t + i;
      const int size = (b + 1 < BUCKETS ? (int)a.first[b + 1] : n) - (int)a.first[b];
      cls[i] = size > LOCAL_CAPACITY_3 ? 0 : size > LOCAL_CAPACITY_3 / 4 ? 1
             : size > LOCAL_CAPACITY_3 / 16 ? 2 : size > 0 ? 3 : -1;
      flag[i] = cls[i] >= 0 ? 1ull << (16 * cls[i]) : 0ull;
    }
    static_assert(PER_THREAD * LOCAL_BLOCK == BUCKETS && BUCKETS < 1 << 16,
                  "a class's count fits 16 bits");
    OrderScan(temp.order).ExclusiveSum(flag, pre, agg);
    int class_first[4] = {0, 0, 0, 0};
    for (int c = 1; c < 4; ++c)
      class_first[c] = class_first[c - 1] + (int)(agg >> (16 * (c - 1)) & 0xFFFFu);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (cls[i] >= 0)
        order[class_first[cls[i]] + (int)(pre[i] >> (16 * cls[i]) & 0xFFFFu)] =
            (unsigned short)(PER_THREAD * t + i);
    if (t == 0) {
      s_buckets = class_first[3] + (int)(agg >> 48 & 0xFFFFu);
      s_next = (int)atomicAdd(a.ticket, 1u);
    }
    __syncthreads();
  }
  const int buckets = s_buckets;
  // ticket tk's bucket: its first row and rows
  auto span = [&](int tk, int64_t& s0, int& m) {
    const int b = order[tk];
    s0 = a.first[b];
    m = (int)((b + 1 < BUCKETS ? (int64_t)a.first[b + 1] : (int64_t)n) - s0);
  };

  // One bucket, from the scatter's [s0, s0 + m) to the outputs' same rows.
  // Routes: a bucket of at most WHOLE_CAPACITY rows is held whole; one of a
  // single key is copied; one of at most local_capacity(passes) rows runs
  // its passes in shared memory (key - min staged there as 16 bits where
  // it fits them), then writes its columns through shared memory; a larger
  // one takes the oversize route.
  auto sort_bucket = [&](const int64_t s0, const int m) {
    const uint32_t* keys = a.keys_b + s0;
    const uint4* recs = a.recs_b + s0;
    uint32_t* keys_out = a.keys_out + s0;
    uint32_t* words_out = a.words_out + s0;
    const int64_t ld = a.out_ld;
    if (m <= WHOLE_CAPACITY) {
      if (t == 0) atomicAdd(a.stats + STAT_ON_CHIP, (unsigned)m);
      lb.sort_whole(keys, recs, m, keys_out, words_out, ld);
      return;
    }
    uint32_t kmin, hi;
    lb.range(keys, m, kmin, hi);
    const int bits = hi > kmin ? 32 - __clz((int)(hi - kmin)) : 0;  // < BUCKET_SHIFT + 1
    const int passes = (bits + LOCAL_DIGIT_BITS - 1) / LOCAL_DIGIT_BITS;
    const bool on_chip = m <= local_capacity(passes);
    if (t == 0)
      atomicAdd(a.stats + (on_chip || passes == 0 ? STAT_ON_CHIP : STAT_OVERSIZE), (unsigned)m);
    if (passes == 0) {  // one distinct key: the bucket is in order
      gather_rows(recs, keys_out, words_out, ld, m, [&](int ps, int& idx) {
        idx = ps;
        return keys[ps];
      });
      return;
    }
    if (on_chip) {
      // a packed word and a 16-bit index a row (LOCAL_BUFFER_BYTES); the
      // indices of two passes in the top third, where key - min waits for
      // pass 0, else at the start; the columns staged in the other bytes
      auto* high = reinterpret_cast<unsigned short*>(lb.buf + LOCAL_CAPACITY * 4);
      unsigned short* rel16 = passes <= 2 ? high : nullptr;
      lb.histograms(keys, m, kmin, passes, rel16);
      const unsigned short* index =
          lb.lsd(keys, rel16, m, kmin, passes, reinterpret_cast<uint32_t*>(lb.buf),
                 reinterpret_cast<uint32_t*>(lb.buf) + LOCAL_CAPACITY_3, high);
      unsigned char* stage = index == high ? lb.buf : lb.buf + LOCAL_CAPACITY * 2;
      lb.write_columns(keys, recs, m, index, stage, keys_out, words_out, ld);
      return;
    }
    lb.histograms(keys, m, kmin, passes, nullptr);
  // the oversize route: (key, bucket row) pairs in the bucket's own
    // output range, pass 0 from the bucketed keys into (words row 1, words
    // row 2), then between those and (words row 3, the output keys)
    uint32_t* const key_at[2] = {words_out + ld, words_out + 3 * ld};
    uint32_t* const idx_at[2] = {words_out + 2 * ld, keys_out};
    for (int q = 0; q < passes; ++q) {
      const uint32_t* src_k = q == 0 ? keys : key_at[(q - 1) & 1];
      const uint32_t* src_i = q == 0 ? nullptr : idx_at[(q - 1) & 1];
      uint32_t* dst_k = key_at[q & 1];
      uint32_t* dst_i = idx_at[q & 1];
      const int shift = LOCAL_DIGIT_BITS * q;
      local_pass<uint2>(
          m, lb.carry(q), lb.count, lb.round_first, nullptr,
          [&](int j, int& d) {
            const uint32_t k = src_k[j];
            d = (int)((k - kmin) >> shift & (LOCAL_RADIX - 1));
            return make_uint2(k, src_i ? src_i[j] : (uint32_t)j);
          },
          [&](int dest, uint2 v) {
            dst_k[dest] = v.x;
            dst_i[dest] = v.y;
          });
    }
    const uint32_t* sorted_k = key_at[(passes - 1) & 1];
    const uint32_t* sorted_i = idx_at[(passes - 1) & 1];
    gather_rows(recs, keys_out, words_out, ld, m, [&](int ps, int& idx) {
      idx = (int)sorted_i[ps];
      return sorted_k[ps];
    });
  };

  // buckets by ticket, one ticket ahead: the next bucket's keys are
  // fetched into L2 while this one is sorted
  int cur = s_next;
  int64_t s0 = 0;
  int m = 0;
  if (cur < buckets) span(cur, s0, m);
  __syncthreads();
  if (t == 0) s_next = (int)atomicAdd(a.ticket, 1u);
  __syncthreads();
  while (cur < buckets) {
    const int next = s_next;
    int64_t next_s0 = 0;
    int next_m = 0;
    if (next < buckets) {
      span(next, next_s0, next_m);
      prefetch_l2(a.keys_b + next_s0, (int64_t)next_m * 4);
      if (next_m <= WHOLE_CAPACITY) prefetch_l2(a.recs_b + next_s0, (int64_t)next_m * 16);
    }
    sort_bucket(s0, m);
    __syncthreads();  // s_next read and the shared memory free for the next bucket
    if (t == 0) s_next = (int)atomicAdd(a.ticket, 1u);
    cur = next;
    s0 = next_s0;
    m = next_m;
    __syncthreads();
  }
}

inline int64_t sort_tiles(int64_t rows) { return (rows + SORT_TILE - 1) / SORT_TILE; }

inline int64_t sort_scratch_words(int64_t rows) { return 5 * rows + SORT_HEAD_WORDS; }

// Blocks of each kernel the card holds at once, for the current device:
// the grids' caps (a grid past them would only queue blocks that find no
// work).  Queried once; also raises the dynamic shared memory caps.
struct SortGrids {
  int device = -1;
  int count = 0, scatter = 0, local = 0;
};

template <class K>
inline cudaError_t resident(K kernel, int threads, int smem, int sms, int* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = per_sm * sms;
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

inline cudaError_t sort_grids(SortGrids* g) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == g->device) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = resident(live_sort_count_kernel, SORT_BLOCK, 0, sms, &g->count)) != cudaSuccess ||
      (err = resident(live_sort_scatter_kernel, SORT_BLOCK, SCATTER_SMEM_BYTES, sms,
                      &g->scatter)) != cudaSuccess ||
      (err = resident(live_sort_local_kernel, LOCAL_BLOCK, LOCAL_SMEM_BYTES, sms, &g->local)) !=
          cudaSuccess)
    return err;
  g->device = dev;
  return cudaSuccess;
}

inline unsigned grid_of(int64_t work, int cap) { return (unsigned)(work < cap ? work : cap); }

}  // namespace ws

extern "C" {

// the tile, the segment limit, the bucket plan and the scratch size, which
// ops/sort.py mirrors (chip_smoke.py phase 1 holds them equal)
int ws_sort_tile() { return ws::SORT_TILE; }
int ws_sort_max_segments() { return ws::MAX_SEGMENTS; }
// plan: the bucket's bits, the local sort's digit bits, its capacity in
// rows for a bucket of 1, 2 and 3 passes, the packed word's index bits,
// the head's words, the counter's first word in the head and the rows a
// block holds whole; returns the number of entries
int ws_sort_bucket_plan(int* plan) {
  plan[0] = ws::BUCKET_BITS;
  plan[1] = ws::LOCAL_DIGIT_BITS;
  plan[2] = ws::local_capacity(1);
  plan[3] = ws::local_capacity(2);
  plan[4] = ws::local_capacity(3);
  plan[5] = ws::INDEX_BITS;
  plan[6] = ws::SORT_HEAD_WORDS;
  plan[7] = ws::SORT_STATS;
  plan[8] = ws::WHOLE_CAPACITY;
  return 9;
}
int64_t ws_sort_scratch_words(int64_t rows) { return ws::sort_scratch_words(rows); }

// keys: rows u32; words: 4 rows of words_ld u32; segments: host array of
// n_seg (offset, capacity) pairs inside [0, rows); emitted: n_seg int32 on
// the device; out_keys: rows u32 (mapped keys, sentinel tail); out_words: 4
// contiguous rows of rows u32 ([0, n) written; the scatter's status words
// until then); scratch: scratch_words int32 (sort_scratch_words:
// ops/sort.py mirrors it), its head zeroed here
int ws_sort_live(const uint32_t* keys, const uint32_t* words, int64_t words_ld, int64_t rows,
                 const int* segments, int n_seg, const int* emitted, uint32_t* out_keys,
                 uint32_t* out_words, void* scratch, int64_t scratch_words, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_seg < 1 || n_seg > ws::MAX_SEGMENTS || rows < 1 || rows >= (int64_t)ws::RUN_AGG ||
      scratch == nullptr || scratch_words < ws::sort_scratch_words(rows))
    return (int)cudaErrorInvalidValue;
  ws::Segments seg{};
  seg.count = n_seg;
  for (int s = 0; s < n_seg; ++s) {
    seg.offset[s] = segments[2 * s];
    seg.capacity[s] = segments[2 * s + 1];
    if (seg.offset[s] < 0 || seg.capacity[s] < 0 ||
        (int64_t)seg.offset[s] + seg.capacity[s] > rows)
      return (int)cudaErrorInvalidValue;
  }
  static ws::SortGrids grids;
  int err = (int)ws::sort_grids(&grids);
  if (err != 0) return err;
  const int64_t tiles = ws::sort_tiles(rows);
  // a successor reads tiles [0, tiles - 1)'s status words: fewer than
  // rows / 4, inside the output words
  const int status_tiles = (int)(tiles - 1);
  auto* recs_b = (uint4*)scratch;  // 16-byte aligned: the allocation's start
  auto* keys_b = (uint32_t*)(recs_b + rows);
  auto* head = (unsigned*)(keys_b + rows);
  unsigned* status = out_words;
  err = (int)cudaMemsetAsync(head, 0, ws::SORT_HEAD_WORDS * sizeof(unsigned), st);
  if (err != 0) return err;
  ws::live_sort_count_kernel<<<ws::grid_of(tiles, grids.count), ws::SORT_BLOCK, 0, st>>>(
      keys, seg, emitted, head, status, status_tiles, out_keys, rows);
  ws::live_sort_scatter_kernel<<<ws::grid_of(tiles, grids.scatter), ws::SORT_BLOCK,
                                 ws::SCATTER_SMEM_BYTES, st>>>(
      ws::ScatterArgs{keys, words, words_ld, head, head + ws::TICKET_SCATTER, status,
                      status_tiles, keys_b, recs_b, seg, emitted});
  ws::live_sort_local_kernel<<<ws::grid_of(ws::BUCKETS, grids.local), ws::LOCAL_BLOCK,
                               ws::LOCAL_SMEM_BYTES, st>>>(
      ws::LocalArgs{keys_b, recs_b, head, head + ws::TICKET_LOCAL, head + ws::SORT_STATS,
                    out_keys, out_words, rows, seg, emitted});
  return (int)cudaGetLastError();
}

}  // extern "C"
