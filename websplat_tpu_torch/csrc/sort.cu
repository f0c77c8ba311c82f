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
// branch, so a captured frame (render/graph.py) replays it as it is.
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
//  - a histogram kernel reads the live rows through the segment table,
//    counts all four 8-bit digits at once (shared-memory counters, one
//    global add per bin and block) and copies each live row's 4 words, which
//    lie in 4 rows of the buffer, to one 16-byte record;
//  - four scatter passes, one per digit, least significant first.  Each
//    block takes a tile of 4096 rows by ticket (stream.cuh:take_tile),
//    loads its keys and indices (every load issued before any is used),
//    ranks its rows within their digit in row order (warps hold contiguous
//    sub-tiles; per round __match_any_sync groups a warp's equal digits),
//    and reserves each digit's run in TILE order by a decoupled look-back
//    over one status word per (tile, digit) (Merrill & Garland 2016; as
//    stream.cuh does for one count; each digit's thread reads 32
//    predecessors' words per round trip), so equal keys keep their order
//    across blocks, never the atomics' order: the sort is stable and the
//    same on every run;
//  - a block stages its tile in shared memory in (digit, row) order and
//    writes each digit's run contiguously, so the scatter is coalesced;
//  - the first pass carries each row's live index; the last maps the keys
//    and writes the sentinel tail; a gather kernel then moves the 4 words
//    once, one 16-byte record read per row (where a gather of the 4
//    separate words reads 4 scattered sectors).
// The grids are sized from T; tiles at or past n exit (their ticket comes
// after every live tile's, so no live block waits on one).  Nothing is
// allocated here: the wrapper passes one scratch buffer (the histogram,
// the tickets, the status words, the records, the ping-pong keys and
// indices); the entry point zeroes its head with cudaMemsetAsync and the
// histogram kernel zeroes the status words of the live tiles.
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "stream.cuh"

namespace ws {

constexpr int SORT_BLOCK = 256;
constexpr int SORT_WARPS = SORT_BLOCK / 32;
constexpr int SORT_ITEMS = 16;  // rows per thread
constexpr int SORT_WARP_ROWS = 32 * SORT_ITEMS;
constexpr int SORT_TILE = SORT_BLOCK * SORT_ITEMS;
constexpr int HIST_ROWS = 8;  // rows per thread the histogram kernel loads at once
constexpr int RADIX = 256;
constexpr int DIGIT_PASSES = 4;
constexpr int MAX_SEGMENTS = 8;
// scratch head (int32 words): the four digits' histograms, four tickets
constexpr int SORT_HEAD_WORDS = DIGIT_PASSES * RADIX + 8;
// status words: the flags in the top two bits, the digit's count below
constexpr unsigned DIGIT_AGG = 1u << 30;
constexpr unsigned DIGIT_PREFIX = 1u << 31;
constexpr unsigned DIGIT_VALUE = DIGIT_AGG - 1u;
constexpr uint32_t MAPPED_SENTINEL = 0x7FFFFFFFu;  // 0xFFFFFFFF ^ 0x80000000
static_assert(SORT_BLOCK == RADIX, "thread t of a block owns digit t");

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

  __device__ __forceinline__ void load(const Segments& seg, const int* __restrict__ emitted) {
    if (threadIdx.x == 0) {
      int acc = 0;
      pre[0] = 0;
      for (int s = 0; s < seg.count; ++s) {
        acc += min(max(emitted[s], 0), seg.capacity[s]);
        pre[s + 1] = acc;
        off[s] = seg.offset[s];
      }
      count = seg.count;
    }
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

__global__ void __launch_bounds__(SORT_BLOCK)
    live_sort_histogram_kernel(const uint32_t* __restrict__ keys,
                               const uint32_t* __restrict__ words, int64_t words_ld,
                               Segments seg, const int* __restrict__ emitted,
                               unsigned* __restrict__ hist, unsigned* __restrict__ status,
                               int tiles, uint4* __restrict__ records) {
  __shared__ unsigned h[DIGIT_PASSES * RADIX];
  __shared__ LiveTable live;
  live.load(seg, emitted);
  const int n = live.n();
  const int64_t start = (int64_t)blockIdx.x * SORT_TILE;
  if (start >= n) return;  // block-uniform
  for (int j = threadIdx.x; j < DIGIT_PASSES * RADIX; j += SORT_BLOCK) h[j] = 0u;
  // this tile's status words in each pass: its look-backs start from zero
  for (int p = 0; p < DIGIT_PASSES; ++p)
    status[((int64_t)p * tiles + blockIdx.x) * RADIX + threadIdx.x] = 0u;
  __syncthreads();
  // HIST_ROWS rows per thread loaded at once, then counted and copied
  for (int r0 = 0; r0 < SORT_ITEMS; r0 += HIST_ROWS) {
    uint32_t k[HIST_ROWS];
    uint4 w[HIST_ROWS];
#pragma unroll
    for (int r = 0; r < HIST_ROWS; ++r) {
      const int64_t i = start + (r0 + r) * SORT_BLOCK + threadIdx.x;
      if (i < n) {
        const int row = live.row((int)i);
        k[r] = keys[row];
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
          atomicAdd(&h[p * RADIX + ((k[r] >> (8 * p)) & 0xFFu)], 1u);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < DIGIT_PASSES * RADIX; j += SORT_BLOCK)
    if (h[j]) atomicAdd(&hist[j], h[j]);
}

// Thread t of the block, for digit t, after the tile's count is published:
// walks back over its predecessors' words to the nearest inclusive prefix,
// LOOKBACK_SPAN words per round trip, and publishes its own.  Returns the
// digit's rows in the tiles before this one.
constexpr int LOOKBACK_SPAN = 32;

__device__ __forceinline__ int digit_lookback(unsigned* __restrict__ status, int tile,
                                              int total) {
  unsigned* col = status + threadIdx.x;
  if (tile == 0) return 0;  // published as a prefix already
  int excl = 0;
  bool found = false;
  for (int j = tile - 1; !found; j -= LOOKBACK_SPAN) {
    unsigned w[LOOKBACK_SPAN];
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u)  // before tile 0: a prefix of 0
      w[u] = j - u >= 0 ? *(const volatile unsigned*)(col + (int64_t)(j - u) * RADIX)
                        : DIGIT_PREFIX;
#pragma unroll
    for (int u = 0; u < LOOKBACK_SPAN; ++u) {
      if (found) break;
      while (!(w[u] & (DIGIT_AGG | DIGIT_PREFIX))) {  // not published yet
        __nanosleep(32);
        w[u] = *(const volatile unsigned*)(col + (int64_t)(j - u) * RADIX);
      }
      excl += (int)(w[u] & DIGIT_VALUE);
      found = (w[u] & DIGIT_PREFIX) != 0;
    }
  }
  *(volatile unsigned*)(col + (int64_t)tile * RADIX) = DIGIT_PREFIX | (unsigned)(excl + total);
  return excl;
}

enum SortPass { FIRST_PASS = 0, MIDDLE_PASS = 1, LAST_PASS = 2 };

struct PassArgs {
  const uint32_t* keys_in;  // FIRST_PASS: the stream buffer's keys
  const int* idx_in;        // buffer row of each input key (not FIRST_PASS)
  uint32_t* keys_out;       // LAST_PASS: the mapped keys, T rows
  int* idx_out;             // LAST_PASS: the sorted rows' buffer rows
  const unsigned* hist;     // this digit's 256 counts over the live rows
  unsigned* status;      // this pass's tiles x 256 status words
  unsigned* ticket;
  int shift;
  int64_t rows;  // T
  Segments seg;
  const int* emitted;
};

template <int PASS>
__global__ void __launch_bounds__(SORT_BLOCK) live_sort_pass_kernel(PassArgs a) {
  using Scan = cub::BlockScan<int, SORT_BLOCK>;
  __shared__ typename Scan::TempStorage scan;
  __shared__ int warp_count[SORT_WARPS][RADIX];  // then each warp's first rank per digit
  __shared__ int digit_first[RADIX];             // the digit's first row in the staged tile
  __shared__ int digit_dest[RADIX];  // its rows' output index minus their staged row
  __shared__ uint32_t stage_key[SORT_TILE];
  __shared__ int stage_idx[SORT_TILE];
  __shared__ LiveTable live;
  __shared__ int s_tile;

  const int tile = take_tile(a.ticket, &s_tile);
  live.load(a.seg, a.emitted);
  const int n = live.n();
  const int64_t start = (int64_t)tile * SORT_TILE;
  if (PASS == LAST_PASS) {  // the sentinel tail [n, T) of this tile's rows
    const int64_t end = min(start + SORT_TILE, a.rows);
    for (int64_t j = max(start, (int64_t)n) + threadIdx.x; j < end; j += SORT_BLOCK)
      a.keys_out[j] = MAPPED_SENTINEL;
  }
  if (start >= n) return;  // block-uniform: past every live tile
  const int m = (int)min((int64_t)SORT_TILE, n - start);  // live rows in the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  for (int d = lane; d < RADIX; d += 32) warp_count[warp][d] = 0;
  __syncwarp();
  // warp w holds tile rows [w * 512, (w + 1) * 512), round r lane l row
  // w * 512 + 32 r + l: ranks within the warp run in row order
  // every load issued before any is used
  uint32_t key[SORT_ITEMS];
  int idx[SORT_ITEMS], rank[SORT_ITEMS];
#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
    key[r] = 0u;
    idx[r] = 0;
    if (j < m) {
      const int i = (int)start + j;
      if (PASS == FIRST_PASS) {
        idx[r] = i;
        key[r] = __ldg(a.keys_in + live.row(i));
      } else {
        key[r] = __ldg(a.keys_in + i);
        idx[r] = __ldg(a.idx_in + i);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const bool valid = warp * SORT_WARP_ROWS + r * 32 + lane < m;
    const int d = valid ? (int)((key[r] >> a.shift) & 0xFFu) : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = valid ? warp_count[warp][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) warp_count[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & lt);
  }
  __syncthreads();

  // thread t owns digit t: the warps' first ranks and the tile's count
  const int t = threadIdx.x;
  int total = 0;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) {
    const int c = warp_count[w][t];
    warp_count[w][t] = total;
    total += c;
  }
  *(volatile unsigned*)(a.status + (int64_t)tile * RADIX + t) =
      (tile == 0 ? DIGIT_PREFIX : DIGIT_AGG) | (unsigned)total;
  int first, global_first;
  Scan(scan).ExclusiveSum(total, first);
  __syncthreads();
  Scan(scan).ExclusiveSum((int)a.hist[t], global_first);
  const int excl = digit_lookback(a.status, tile, total);
  digit_first[t] = first;
  digit_dest[t] = global_first + excl - first;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const int j = warp * SORT_WARP_ROWS + r * 32 + lane;
    if (j < m) {
      const int d = (int)((key[r] >> a.shift) & 0xFFu);
      const int s = digit_first[d] + warp_count[warp][d] + rank[r];
      stage_key[s] = key[r];
      stage_idx[s] = idx[r];
    }
  }
  __syncthreads();

  // staged row j goes to digit_dest[d] + j: each digit's run is contiguous
  for (int j = t; j < m; j += SORT_BLOCK) {
    const uint32_t k = stage_key[j];
    const int pos = digit_dest[(k >> a.shift) & 0xFFu] + j;
    a.keys_out[pos] = PASS == LAST_PASS ? k ^ 0x80000000u : k;
    a.idx_out[pos] = stage_idx[j];
  }
}

// The 4 words of the sorted rows [0, n): out row i is live row perm[i],
// whose words the histogram kernel copied to records[perm[i]].  Coalesced
// writes, one 16-byte gathered read per row, every load of a thread's rows
// issued before its stores.
__global__ void __launch_bounds__(SORT_BLOCK)
    live_sort_gather_kernel(const int* __restrict__ perm, Segments seg,
                            const int* __restrict__ emitted, const uint4* __restrict__ records,
                            uint32_t* __restrict__ words_out, int64_t out_ld) {
  __shared__ LiveTable live;
  live.load(seg, emitted);
  const int n = live.n();
  const int64_t start = (int64_t)blockIdx.x * SORT_TILE;
  if (start >= n) return;
  int row[SORT_ITEMS];
#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const int64_t i = start + r * SORT_BLOCK + threadIdx.x;
    row[r] = i < n ? __ldg(perm + i) : -1;
  }
  uint4 w[SORT_ITEMS];
#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r)
    w[r] = row[r] >= 0 ? __ldg(records + row[r]) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int r = 0; r < SORT_ITEMS; ++r) {
    if (row[r] < 0) continue;
    uint32_t* out = words_out + start + r * SORT_BLOCK + threadIdx.x;
    out[0] = w[r].x;
    out[out_ld] = w[r].y;
    out[2 * out_ld] = w[r].z;
    out[3 * out_ld] = w[r].w;
  }
}

inline int64_t sort_tiles(int64_t rows) { return (rows + SORT_TILE - 1) / SORT_TILE; }

inline int64_t sort_scratch_words(int64_t rows) {
  return SORT_HEAD_WORDS + DIGIT_PASSES * sort_tiles(rows) * RADIX + 7 * rows;
}

}  // namespace ws

extern "C" {

// the tile and the segment limit, which ops/sort.py mirrors (chip_smoke.py
// phase 1 holds them equal)
int ws_sort_tile() { return ws::SORT_TILE; }
int ws_sort_max_segments() { return ws::MAX_SEGMENTS; }

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
  const int64_t tiles = ws::sort_tiles(rows);
  auto* head = (unsigned*)scratch;
  unsigned* hist = head;
  unsigned* tickets = head + ws::DIGIT_PASSES * ws::RADIX;
  unsigned* status = head + ws::SORT_HEAD_WORDS;
  auto* records = (uint4*)(status + ws::DIGIT_PASSES * tiles * ws::RADIX);  // 16-byte aligned
  auto* keys_a = (uint32_t*)(records + rows);
  auto* idx_a = (int*)(keys_a + rows);
  auto* idx_b = idx_a + rows;
  int err = (int)cudaMemsetAsync(scratch, 0, ws::SORT_HEAD_WORDS * sizeof(unsigned), st);
  if (err != 0) return err;
  ws::live_sort_histogram_kernel<<<(unsigned)tiles, ws::SORT_BLOCK, 0, st>>>(
      keys, words, words_ld, seg, emitted, hist, status, (int)tiles, records);
  // ping-pong: buffer -> (keys_a, idx_a) -> (out_keys, idx_b) -> (keys_a,
  // idx_a) -> (out_keys mapped, idx_b), then the words by idx_b
  const uint32_t* k_in[ws::DIGIT_PASSES] = {keys, keys_a, out_keys, keys_a};
  const int* i_in[ws::DIGIT_PASSES] = {nullptr, idx_a, idx_b, idx_a};
  uint32_t* k_out[ws::DIGIT_PASSES] = {keys_a, out_keys, keys_a, out_keys};
  int* i_out[ws::DIGIT_PASSES] = {idx_a, idx_b, idx_a, idx_b};
  for (int p = 0; p < ws::DIGIT_PASSES; ++p) {
    ws::PassArgs a{k_in[p], i_in[p], k_out[p], i_out[p], hist + p * ws::RADIX,
                   status + p * tiles * ws::RADIX, tickets + p, 8 * p, rows, seg, emitted};
    if (p == 0)
      ws::live_sort_pass_kernel<ws::FIRST_PASS><<<(unsigned)tiles, ws::SORT_BLOCK, 0, st>>>(a);
    else if (p == ws::DIGIT_PASSES - 1)
      ws::live_sort_pass_kernel<ws::LAST_PASS><<<(unsigned)tiles, ws::SORT_BLOCK, 0, st>>>(a);
    else
      ws::live_sort_pass_kernel<ws::MIDDLE_PASS><<<(unsigned)tiles, ws::SORT_BLOCK, 0, st>>>(a);
  }
  ws::live_sort_gather_kernel<<<(unsigned)tiles, ws::SORT_BLOCK, 0, st>>>(
      idx_b, seg, emitted, records, out_words, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
