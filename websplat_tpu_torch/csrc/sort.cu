// Stable LSD radix sort of the frame's instance stream, over its live rows
// only: the count-following sort.
//
// Replaces the JAX frame's sort (websplat_tpu/ops/sort.py:sort_instances
// with n_valid, its prefix ladder _ladder_sort: lax.sort over the smallest
// of 16 prefix rungs that covers the device-side count, picked by
// lax.switch).  It is an XLA op there, not a Pallas kernel; the reference's
// own radix sort (radix_sort.wgsl, driven by GPURSSorter::
// record_sort_indirect) launches for the capacity and reads the live count
// from device memory, and so does this one: no host read, no device-side
// branch, a fixed number of launches, so a captured frame (render/graph.py)
// replays it as it is.
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
// row and 4 B per tail row (utils/roofline.py:sort_work); a radix sort moves
// more than that, 8 B in and out per digit pass for the key and its row
// index, and a gather.  The design:
//  - four digit passes of 8 bits (the plan: digit_bits, digit_shift;
//    ops/sort.py mirrors it), least significant first.  Three passes of
//    11/11/10 bits were measured slower on the H100: a 2048-digit pass
//    scatters an 8192-row tile in runs of ~4 rows where the key's digit is
//    spread evenly (the depth's low bits, the tile), and such a pass cost
//    about twice an 8-bit one (PERF.md §6);
//  - a histogram kernel reads the live rows through the segment table,
//    counts all four digits at once (shared-memory counters, one global
//    add per bin and block; the last block to finish turns the counts into
//    each digit's first output row), copies each live row's 4 words, which
//    lie in 4 rows of the buffer, to one 16-byte record, and writes the
//    output keys' sentinel tail;
//  - each pass takes tiles of 8192 rows by ticket (stream.cuh:take_tile;
//    the first ticket and the live-row table in one round trip), loads a
//    tile's keys (every load issued before any is used), ranks
//    its rows within their digit in row order (a warp holds 512
//    contiguous rows; per round __match_any_sync groups its equal digits;
//    16-bit counters, one array per warp), publishes the tile's digit
//    counts, stages the tile in shared memory in (digit, row) order (the
//    keys first, then the indices, loaded late from L2 where a prefetch
//    put them, so a thread never holds both), and reserves
//    each digit's run in TILE order by a decoupled look-back over one
//    status word per (tile, digit) (Merrill & Garland 2016; each digit's
//    thread reads LOOKBACK_SPAN predecessors per round trip), so equal
//    keys keep their order across blocks, never the atomics' order: the
//    sort is stable and the same on every run;
//  - a block then writes each digit's run contiguously;
//  - the first pass carries each row's live index; the last maps the keys;
//    a gather kernel then moves the 4 words once, one 16-byte record read
//    per row, through L2 only (gathered inside the last pass, the words'
//    four scattered rows made that pass three times slower).
// Every kernel runs a grid of at most as many blocks as the card holds at
// once, sized from T, and walks the live rows (the passes by ticket, the
// histogram and the gather by stride), so no block is launched only to
// find nothing to do.  Nothing is allocated here: the wrapper passes one
// scratch buffer (the records, one ping-pong key and index pair, the
// histograms, the tickets, the status words), and the output words' first
// row holds the row indices between passes; the entry point zeroes the
// scratch's head with cudaMemsetAsync and the histogram kernel zeroes the
// status words of the live tiles.
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "stream.cuh"

namespace ws {

constexpr int SORT_BLOCK = 512;
constexpr int SORT_MIN_BLOCKS = 2;  // per SM: at most 64 registers a thread
constexpr int SORT_WARPS = SORT_BLOCK / 32;
constexpr int SORT_ITEMS = 16;  // rows per thread
constexpr int SORT_WARP_ROWS = 32 * SORT_ITEMS;
constexpr int SORT_TILE = SORT_BLOCK * SORT_ITEMS;
constexpr int HIST_ROWS = 8;  // rows per thread the histogram kernel loads at once
constexpr int GATHER_BLOCK = 256;
constexpr int GATHER_ITEMS = 16;
constexpr int GATHER_CHUNK = GATHER_BLOCK * GATHER_ITEMS;
constexpr int MAX_SEGMENTS = 8;
// the digit plan, least significant first: widths and shifts
constexpr int DIGIT_PASSES = 4;
__host__ __device__ constexpr int digit_bits(int) { return 8; }
__host__ __device__ constexpr int digit_shift(int p) { return 8 * p; }
__host__ __device__ constexpr int radix(int p) { return 1 << digit_bits(p); }
// digit p's first word in a tile's status words and in the histograms
__host__ __device__ constexpr int digit_offset(int p) {
  return p == 0 ? 0 : digit_offset(p - 1) + radix(p - 1);
}
static_assert(digit_shift(DIGIT_PASSES - 1) + digit_bits(DIGIT_PASSES - 1) == 32,
              "the digits tile the 32-bit key");
constexpr int HIST_WORDS = digit_offset(DIGIT_PASSES);
// scratch head (int32 words): the digits' histograms (then their first
// output rows), a ticket per pass, the histogram blocks' done count
constexpr int SORT_HEAD_WORDS = HIST_WORDS + 8;
constexpr int HIST_DONE = HIST_WORDS + 7;
static_assert(DIGIT_PASSES < 8, "a ticket per pass");
constexpr int HIST_IPT = HIST_WORDS / SORT_BLOCK;  // the last histogram block's scan
static_assert(HIST_IPT * SORT_BLOCK == HIST_WORDS && HIST_WORDS == DIGIT_PASSES * radix(0) &&
                  radix(0) % HIST_IPT == 0,
              "equal digits, each digit's histogram starting at a thread's first value");
// status words: the flags in the top two bits, the digit's count below
constexpr unsigned DIGIT_AGG = 1u << 30;
constexpr unsigned DIGIT_PREFIX = 1u << 31;
constexpr unsigned DIGIT_VALUE = DIGIT_AGG - 1u;
constexpr uint32_t MAPPED_SENTINEL = 0x7FFFFFFFu;  // 0xFFFFFFFF ^ 0x80000000
static_assert(SORT_TILE <= 0xFFFF, "ranks and staged rows fit 16 bits");

__device__ __forceinline__ int digit_of(uint32_t key, int p) {
  return (int)((key >> digit_shift(p)) & (unsigned)(radix(p) - 1));
}

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
// 16 bytes a store past the first 16-byte boundary: no pass writes past n.
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
    live_sort_histogram_kernel(const uint32_t* __restrict__ keys,
                               const uint32_t* __restrict__ words, int64_t words_ld,
                               Segments seg, const int* __restrict__ emitted,
                               unsigned* __restrict__ hist, unsigned* __restrict__ status,
                               uint4* __restrict__ records, uint32_t* __restrict__ keys_out,
                               int64_t rows) {
  using Scan = cub::BlockScan<int, SORT_BLOCK>;
  __shared__ unsigned h[HIST_WORDS];
  __shared__ LiveTable live;
  __shared__ typename Scan::TempStorage scan;
  __shared__ bool last;
  live.load(seg, emitted);
  const int n = live.n(), tiles = live_tiles(n);
  write_tail(keys_out, n, rows);
  if ((int)blockIdx.x >= tiles) return;  // block-uniform
  for (int j = threadIdx.x; j < HIST_WORDS; j += SORT_BLOCK) h[j] = 0u;
  // the live tiles' status words: the passes' look-backs start from zero
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int j = threadIdx.x; j < HIST_WORDS; j += SORT_BLOCK)
      status[(int64_t)tile * HIST_WORDS + j] = 0u;
  __syncthreads();
  // a tile at a time, HIST_ROWS rows per thread loaded at once, then counted
  // and copied
  for (int64_t start = (int64_t)blockIdx.x * SORT_TILE; start < n;
       start += (int64_t)gridDim.x * SORT_TILE) {
    for (int r0 = 0; r0 < SORT_ITEMS; r0 += HIST_ROWS) {
      uint32_t k[HIST_ROWS];
      uint4 w[HIST_ROWS];
#pragma unroll
      for (int r = 0; r < HIST_ROWS; ++r) {
        const int64_t i = start + (r0 + r) * SORT_BLOCK + threadIdx.x;
        if (i < n) {
          const int row = live.row((int)i);
          k[r] = __ldg(keys + row);
          w[r] = make_uint4(words[row], words[words_ld + row], words[2 * words_ld + row],
                            words[3 * words_ld + row]);
        }
      }
#pragma unroll
      for (int r = 0; r < HIST_ROWS; ++r) {
        const int64_t i = start + (r0 + r) * SORT_BLOCK + threadIdx.x;
        if (i < n) {
          records[i] = w[r];
#pragma unroll
          for (int p = 0; p < DIGIT_PASSES; ++p)
            atomicAdd(&h[digit_offset(p) + digit_of(k[r], p)], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < HIST_WORDS; j += SORT_BLOCK)
    if (h[j]) atomicAdd(&hist[j], h[j]);
  // the last block to finish turns each digit's histogram into its
  // digits' first output rows: one scan of all of them, each digit's
  // total before it then taken off
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&hist[HIST_DONE], 1u) == (unsigned)min((int)gridDim.x, tiles) - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int base = threadIdx.x * HIST_IPT;
  int x[HIST_IPT], y[HIST_IPT];
#pragma unroll
  for (int i = 0; i < HIST_IPT; ++i) x[i] = (int)__ldcg(hist + base + i);
  Scan(scan).ExclusiveSum(x, y);
#pragma unroll
  for (int i = 0; i < HIST_IPT; ++i) h[base + i] = (unsigned)y[i];
  __syncthreads();
  const int seg0 = base / radix(0) * radix(0);  // this value's digit's histogram
#pragma unroll
  for (int i = 0; i < HIST_IPT; ++i) hist[base + i] = (unsigned)y[i] - h[seg0];
}

// Thread d, for digit d, after the tile's counts are published: walks
// back over its predecessors' words to the nearest inclusive prefix,
// LOOKBACK_SPAN words per round trip, and publishes its own.  Returns the
// digit's rows in the tiles before this one.
constexpr int LOOKBACK_SPAN = 16;

__device__ __forceinline__ int digit_lookback(unsigned* __restrict__ status, int tile, int total) {
  unsigned* col = status + threadIdx.x;
  if (tile == 0) return 0;  // published as a prefix already
  int excl = 0;
  bool found = false;
  for (int j = tile - 1; !found; j -= LOOKBACK_SPAN) {
    unsigned w[LOOKBACK_SPAN];
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u)  // before tile 0: a prefix of 0
      w[u] = j - u >= 0 ? *(const volatile unsigned*)(col + (int64_t)(j - u) * HIST_WORDS)
                        : DIGIT_PREFIX;
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u) {
      if (found) break;
      while (!(w[u] & (DIGIT_AGG | DIGIT_PREFIX))) {  // not published yet
        __nanosleep(32);
        w[u] = *(const volatile unsigned*)(col + (int64_t)(j - u) * HIST_WORDS);
      }
      excl += (int)(w[u] & DIGIT_VALUE);
      found = (w[u] & DIGIT_PREFIX) != 0;
    }
  }
  *(volatile unsigned*)(col + (int64_t)tile * HIST_WORDS) = DIGIT_PREFIX | (unsigned)(excl + total);
  return excl;
}

struct PassArgs {
  const uint32_t* keys_in;  // pass 0: the stream buffer's keys
  const int* idx_in;        // live index of each input key (not pass 0)
  uint32_t* keys_out;       // the last pass: the mapped keys of rows [0, n)
  int* idx_out;             // the last pass: the sorted rows' live indices
  const unsigned* first;    // this digit's first output rows (the histogram's scan)
  unsigned* status;         // this digit's status words: tile t's at t * HIST_WORDS
  unsigned* ticket;
  Segments seg;
  const int* emitted;
};

// dynamic shared memory of pass P: the warps' 16-bit counters, which the
// staged tile (keys and indices) overwrites, then one int per digit
template <int P>
__host__ __device__ constexpr int pass_big_bytes() {
  return SORT_WARPS * radix(P) * 2 > SORT_TILE * 8 ? SORT_WARPS * radix(P) * 2 : SORT_TILE * 8;
}
template <int P>
__host__ __device__ constexpr int pass_smem_bytes() {
  return pass_big_bytes<P>() + radix(P) * 4;
}

template <int P>
__global__ void __launch_bounds__(SORT_BLOCK, SORT_MIN_BLOCKS) live_sort_pass_kernel(PassArgs a) {
  constexpr int RADIX = radix(P);
  static_assert(RADIX <= SORT_BLOCK, "thread d of a block owns digit d");
  constexpr bool FIRST = P == 0, LAST = P == DIGIT_PASSES - 1;
  __shared__ typename cub::BlockScan<int, SORT_BLOCK>::TempStorage scan;
  __shared__ LiveTable live;
  __shared__ int s_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* count = reinterpret_cast<unsigned short*>(smem);  // [SORT_WARPS][RADIX]
  auto* stage_key = reinterpret_cast<uint32_t*>(smem);    // [SORT_TILE], over the counters
  auto* stage_idx = reinterpret_cast<int*>(stage_key + SORT_TILE);
  auto* digit = reinterpret_cast<int*>(smem + pass_big_bytes<P>());  // [RADIX]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (t == 0) {  // the first ticket and the live rows, one round trip
    s_tile = (int)atomicAdd(a.ticket, 1u);
    live.fill(a.seg, a.emitted);
  }
  const bool owner = t < RADIX;  // thread t owns digit t
  const int gfirst = owner ? (int)a.first[t] : 0;  // the digit's first output row
  __syncthreads();
  const int n = live.n(), tiles = live_tiles(n);
  unsigned short* wc = count + warp * RADIX;

  // tiles by ticket (take_tile's barrier also orders the smem's reuse);
  // block-uniform: past the last live tile every tile is taken
  for (int tile = s_tile; tile < tiles; tile = take_tile(a.ticket, &s_tile)) {
    const int64_t start = (int64_t)tile * SORT_TILE;
    const int m = (int)min((int64_t)SORT_TILE, n - start);  // live rows in the tile
    // warp w holds tile rows [w * W, (w + 1) * W) (W = SORT_WARP_ROWS),
    // round r lane l row w * W + 32 r + l: ranks within the warp run in row
    // order; every key load issued before any is used, and the indices
    // fetched into L2 meanwhile (loaded once the keys are staged, so a
    // thread holds 16 keys or 16 indices, not both)
    uint32_t key[SORT_ITEMS];
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
      key[r] = 0u;
      if (j < m) {
        const int i = (int)start + j;
        if (FIRST) {
          key[r] = a.keys_in[live.row(i)];
        } else {
          key[r] = a.keys_in[i];
          if (lane == 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(a.idx_in + i));
        }
      }
    }
    for (int d = lane; d < RADIX / 2; d += 32) reinterpret_cast<unsigned*>(wc)[d] = 0u;
    __syncwarp();
    unsigned rank[SORT_ITEMS / 2];  // two 16-bit ranks per word
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      const bool valid = warp * SORT_WARP_ROWS + r * 32 + lane < m;
      const int d = valid ? digit_of(key[r], P) : RADIX;
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

    // per digit: the warps' first ranks, the tile's count, published at
    // once, and its first row in the staged tile (a scan of the counts)
    int total = 0, first;
    if (owner) {
#pragma unroll
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int c = count[w * RADIX + t];
        count[w * RADIX + t] = (unsigned short)total;
        total += c;
      }
      *(volatile unsigned*)(a.status + (int64_t)tile * HIST_WORDS + t) =
          (tile == 0 ? DIGIT_PREFIX : DIGIT_AGG) | (unsigned)total;
    }
    cub::BlockScan<int, SORT_BLOCK>(scan).ExclusiveSum(total, first);
    if (owner) digit[t] = first;
    __syncthreads();
    // each row's place in the staged tile
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      if (warp * SORT_WARP_ROWS + r * 32 + lane < m) {
        const int d = digit_of(key[r], P);
        const unsigned s =
            digit[d] + count[warp * RADIX + d] + (rank[r >> 1] >> (16 * (r & 1)) & 0xFFFFu);
        rank[r >> 1] = (r & 1) ? (rank[r >> 1] & 0xFFFFu) | (s << 16)
                               : (rank[r >> 1] & 0xFFFF0000u) | s;
      }
    }
    __syncthreads();  // the counters and first rows are read: overwritten below
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
      const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
      if (j < m) {
        const unsigned s = rank[r >> 1] >> (16 * (r & 1)) & 0xFFFFu;
        stage_key[s] = key[r];
        if (FIRST) stage_idx[s] = (int)start + j;
      }
    }
    if (!FIRST) {
      int idx[SORT_ITEMS];
#pragma unroll
      for (int r = 0; r < SORT_ITEMS; ++r) {
        const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
        idx[r] = j < m ? a.idx_in[start + j] : 0;
      }
#pragma unroll
      for (int r = 0; r < SORT_ITEMS; ++r)
        if (warp * SORT_WARP_ROWS + r * 32 + lane < m)
          stage_idx[rank[r >> 1] >> (16 * (r & 1)) & 0xFFFFu] = idx[r];
    }
    // the digits' runs in the tiles before this one, then each digit's
    // output row minus its staged row
    if (owner) digit[t] = gfirst + digit_lookback(a.status, tile, total) - first;
    __syncthreads();

    // staged row j goes to digit[d] + j: each digit's run is contiguous
    for (int j = t; j < m; j += SORT_BLOCK) {
      const uint32_t k = stage_key[j];
      const int pos = digit[digit_of(k, P)] + j;
      a.keys_out[pos] = LAST ? k ^ 0x80000000u : k;
      a.idx_out[pos] = stage_idx[j];
    }
  }
}

// The 4 words of the sorted rows [0, n): out row i is live row perm[i],
// whose words the histogram kernel copied to records[perm[i]]; perm lies
// in the output's first row, and each thread reads its rows' entries
// before it overwrites them.  Coalesced writes, one 16-byte gathered read
// per row, through L2 only (ld.global.cg: a random 16-byte read gains
// nothing from an L1 line, and skipping L1 took ~11% off the gather), every
// load of a thread's rows issued before its stores.
__global__ void __launch_bounds__(GATHER_BLOCK)
    live_sort_gather_kernel(uint32_t* words_out, int64_t out_ld, Segments seg,
                            const int* __restrict__ emitted, const uint4* __restrict__ records) {
  __shared__ LiveTable live;
  live.load(seg, emitted);
  const int n = live.n();
  for (int64_t start = (int64_t)blockIdx.x * GATHER_CHUNK; start < n;
       start += (int64_t)gridDim.x * GATHER_CHUNK) {
    int row[GATHER_ITEMS];
#pragma unroll
    for (int r = 0; r < GATHER_ITEMS; ++r) {
      const int64_t i = start + r * GATHER_BLOCK + threadIdx.x;
      row[r] = i < n ? (int)words_out[i] : -1;
    }
    uint4 w[GATHER_ITEMS];
#pragma unroll
    for (int r = 0; r < GATHER_ITEMS; ++r)
      w[r] = row[r] >= 0 ? __ldcg(records + row[r]) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < GATHER_ITEMS; ++r) {
      if (row[r] < 0) continue;
      uint32_t* out = words_out + start + r * GATHER_BLOCK + threadIdx.x;
      out[0] = w[r].x;
      out[out_ld] = w[r].y;
      out[2 * out_ld] = w[r].z;
      out[3 * out_ld] = w[r].w;
    }
  }
}

inline int64_t sort_tiles(int64_t rows) { return (rows + SORT_TILE - 1) / SORT_TILE; }

inline int64_t sort_scratch_words(int64_t rows) {
  return SORT_HEAD_WORDS + HIST_WORDS * sort_tiles(rows) + 6 * rows;
}

// Blocks of each kernel the card holds at once, for the current device:
// the grids' caps (a grid past them would only queue blocks that find no
// work).  Queried once; also raises the passes' dynamic shared memory cap.
struct SortGrids {
  int device = -1;
  int histogram = 0, pass[DIGIT_PASSES] = {}, gather = 0;
};

template <int P>
inline cudaError_t pass_grids(int sms, int* out) {
  if constexpr (P == DIGIT_PASSES) {
    return cudaSuccess;
  } else {
    cudaError_t err = cudaFuncSetAttribute(live_sort_pass_kernel<P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           pass_smem_bytes<P>());
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, live_sort_pass_kernel<P>,
                                                          SORT_BLOCK, pass_smem_bytes<P>());
    out[P] = per_sm * sms;
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    return err == cudaSuccess ? pass_grids<P + 1>(sms, out) : err;
  }
}

inline cudaError_t sort_grids(SortGrids* g) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == g->device) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, live_sort_histogram_kernel,
                                                           SORT_BLOCK, 0)) != cudaSuccess)
    return err;
  g->histogram = per_sm * sms;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, live_sort_gather_kernel,
                                                           GATHER_BLOCK, 0)) != cudaSuccess)
    return err;
  g->gather = per_sm * sms;
  if ((err = pass_grids<0>(sms, g->pass)) != cudaSuccess) return err;
  if (g->histogram < 1 || g->gather < 1) return cudaErrorInvalidConfiguration;
  g->device = dev;
  return cudaSuccess;
}

inline unsigned grid_of(int64_t work, int cap) { return (unsigned)(work < cap ? work : cap); }

template <int P>
inline void launch_passes(const PassArgs* a, const SortGrids& g, int64_t tiles, cudaStream_t st) {
  if constexpr (P < DIGIT_PASSES) {
    live_sort_pass_kernel<P><<<grid_of(tiles, g.pass[P]), SORT_BLOCK, pass_smem_bytes<P>(), st>>>(
        a[P]);
    launch_passes<P + 1>(a, g, tiles, st);
  }
}

}  // namespace ws

extern "C" {

// the tile, the segment limit, the digit plan and the scratch size, which
// ops/sort.py mirrors (chip_smoke.py phase 1 holds them equal)
int ws_sort_tile() { return ws::SORT_TILE; }
int ws_sort_max_segments() { return ws::MAX_SEGMENTS; }
// plan: 2 ints per pass (width, shift), least significant first; returns
// the number of passes
int ws_sort_digit_plan(int* plan) {
  for (int p = 0; p < ws::DIGIT_PASSES; ++p) {
    plan[2 * p] = ws::digit_bits(p);
    plan[2 * p + 1] = ws::digit_shift(p);
  }
  return ws::DIGIT_PASSES;
}
int64_t ws_sort_scratch_words(int64_t rows) { return ws::sort_scratch_words(rows); }

// keys: rows u32; words: 4 rows of words_ld u32; segments: host array of
// n_seg (offset, capacity) pairs inside [0, rows); emitted: n_seg int32 on
// the device; out_keys: rows u32 (mapped keys, sentinel tail); out_words: 4
// rows of rows u32 ([0, n) written); scratch: scratch_words int32
// (sort_scratch_words: ops/sort.py mirrors it), its head zeroed here
int ws_sort_live(const uint32_t* keys, const uint32_t* words, int64_t words_ld, int64_t rows,
                 const int* segments, int n_seg, const int* emitted, uint32_t* out_keys,
                 uint32_t* out_words, void* scratch, int64_t scratch_words, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_seg < 1 || n_seg > ws::MAX_SEGMENTS || rows < 1 || rows >= (int64_t)ws::DIGIT_AGG ||
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
  auto* records = (uint4*)scratch;  // 16-byte aligned: the allocation's start
  auto* keys_a = (uint32_t*)(records + rows);
  auto* idx_a = (int*)(keys_a + rows);
  auto* head = (unsigned*)(idx_a + rows);
  unsigned* hist = head;
  unsigned* tickets = head + ws::HIST_WORDS;
  unsigned* status = head + ws::SORT_HEAD_WORDS;
  auto* idx_out = (int*)out_words;  // the output words' first row, until the gather
  err = (int)cudaMemsetAsync(head, 0, ws::SORT_HEAD_WORDS * sizeof(unsigned), st);
  if (err != 0) return err;
  ws::live_sort_histogram_kernel<<<ws::grid_of(tiles, grids.histogram), ws::SORT_BLOCK, 0, st>>>(
      keys, words, words_ld, seg, emitted, hist, status, records, out_keys, rows);
  // ping-pong, the last pass into the outputs: pass p writes (out_keys,
  // idx_out) when DIGIT_PASSES - 1 - p is even, else (keys_a, idx_a), and
  // reads what pass p - 1 wrote (pass 0: the buffer through the segments)
  ws::PassArgs a[ws::DIGIT_PASSES];
  for (int p = 0; p < ws::DIGIT_PASSES; ++p) {
    const bool to_out = (ws::DIGIT_PASSES - 1 - p) % 2 == 0;
    a[p] = ws::PassArgs{p == 0 ? keys : a[p - 1].keys_out,
                        p == 0 ? nullptr : a[p - 1].idx_out,
                        to_out ? out_keys : keys_a,
                        to_out ? idx_out : idx_a,
                        hist + ws::digit_offset(p),
                        status + ws::digit_offset(p),
                        tickets + p,
                        seg,
                        emitted};
  }
  ws::launch_passes<0>(a, grids, tiles, st);
  ws::live_sort_gather_kernel<<<ws::grid_of((rows + ws::GATHER_CHUNK - 1) / ws::GATHER_CHUNK,
                                            grids.gather),
                                ws::GATHER_BLOCK, 0, st>>>(out_words, rows, seg, emitted, records);
  return (int)cudaGetLastError();
}

}  // extern "C"
