// Overflow rank walk over clamped-splat rows.
//
// Replaces websplat_tpu/ops/overflow_pallas.py:_make_kernel (called by
// overflow_walk).  For each of the first n = min(*n_ptr, n_cap) 6-word rows
// (rect4, w0..w3, depth_q) it emits the rect's row-major ranks
// [rank_lo, min(n_rect, rank_hi)) whose tile the splat reaches, and forwards
// rows with n_rect > giant_thresh as a second 6-word stream.  The main path
// runs it twice per frame: ranks [6, 32) over the frontend's clamped rows,
// then [32, 160) over the giants (the c3dgs-10m benchmark configuration:
// [6, 128), then [128, 384)).
//
// What bounds it on the card: per row it reads 24 bytes and runs up to
// (rank_hi - rank_lo) reach tests of ~52 f32 operations, writing 20 bytes
// per kept instance.  At the bench scene both levels together move ~2.9 MB
// and run ~211k reach tests (bound ~1 us); at 10M splats the capture holds
// 416,768 rows, 201-244k of them live, with ~1-1.8M instances kept.  Its
// time was the grid's, not the work's: one 8-row block per slice of the
// capture capacity (52,096 blocks at 10M) took 0.30-0.32 ms for level 1
// whether 48% or 59% of the rows were live, each block paying a ticket,
// three barriers and two look-backs for at most 8 rows.  So the grid is
// persistent and a tile holds as many rows as the live count allows
// (0.044-0.074 ms for level 1 at 10M on an H100; PERF.md section 6):
//  - at most the blocks the card holds at once (occupancy x SMs, queried
//    once), never more than the capacity's smallest tiles; each block
//    takes tiles by ticket (stream.cuh: take_tile) and stops at the first
//    past n = min(*n_ptr, n_cap), read on the device, so a captured graph
//    stays valid for any count and no block exists only to publish
//    nothing;
//  - a tile's rows follow n (walk_warp_rows): spread evenly over the
//    grid's warps, 1 to 32 a warp, so level 1's many rows come in tiles of
//    up to 256 and level 2's few long giants in tiles of 8, one a warp (a
//    fixed tile of 64-256 rows left level 2 a handful of warps and took
//    2-6x the old walk's time there); lane k loads and decodes the warp's
//    row k (all of the tile's loads issued at once, one decode per row,
//    not one per lane), and the tile pays its ticket, its scan and its two
//    look-backs once;
//  - a warp's ranks are laid end to end over its rows (WarpRows): round t
//    tests flat indices 32 t + lane, each lane finding its row by a search
//    over the rows' running rank counts and its row's reach by shuffles, so
//    a round is full however few ranks a row has (a clamped row of the
//    bench view tests 6.8 ranks on average, where a warp per row left most
//    lanes idle).  The flat order is row order, a row's ranks ascending: a
//    round's ballot gives each kept rank's offset (__popc(mask &
//    lanemask_lt)), and the first WALK_KEPT_ROUNDS masks stay in shared
//    memory for the writes; rounds past them are tested again when
//    written.
// The warps' totals are scanned in shared memory and the block reserves its
// runs of instances and of giants (lane k forwards its row) once each, in
// tile order (stream.cuh: a decoupled look-back, one warp per stream), so
// the output is an exact prefix in row order, a row's ranks ascending: the
// plain version's order, element for element, and the giants past a
// capacity are the same rows.  The rank -> (dx, dy) map is a real integer
// division and the reach test decodes the record with the rasterizer's
// codecs and divides like make_reaches, so it stays bit-equal to
// decoded_reaches.
#include <algorithm>
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int WALK_WARPS = 8;
constexpr int WALK_BLOCK = 32 * WALK_WARPS;
constexpr int WALK_MAX_WARP_ROWS = 32;  // lane k of a warp holds the warp's row k
constexpr int WALK_KEPT_ROUNDS = 4 * WALK_MAX_WARP_ROWS;  // round masks a warp keeps for its writes
constexpr unsigned FULL_MASK = 0xffffffffu;

struct WalkParams {
  int rank_lo, rank_hi, giant_thresh;
  int tx_tiles, ts_x, ts_y, depth_bits;
  float inv_thr;
  CenterQuant cq;
};

// Rows a warp walks per tile for n live rows over a grid of `blocks`: the
// rows spread evenly over the grid's warps, in as few waves of tiles as
// WALK_MAX_WARP_ROWS allows.  A tile is WALK_WARPS times as many rows, at
// least WALK_WARPS, so the scratch holds a status word per WALK_WARPS rows.
__host__ __device__ __forceinline__ int walk_warp_rows(int n, int blocks) {
  if (n < 1) return 1;
  const int64_t warps = (int64_t)blocks * WALK_WARPS;
  const int64_t waves = (n + warps * WALK_MAX_WARP_ROWS - 1) / (warps * WALK_MAX_WARP_ROWS);
  return (int)((n + warps * waves - 1) / (warps * waves));
}

// A row's rect origin and width in tiles, from its rect4 word.
struct RowRect {
  int tx0, ty0, w_t;
};

__device__ __forceinline__ RowRect row_rect(uint32_t w0) {
  const int tx0 = (int)(w0 & 0xFFu), ty0 = (int)((w0 >> 8) & 0xFFu);
  return RowRect{tx0, ty0, (int)((w0 >> 16) & 0xFFu) - tx0 + 1};
}

// A warp's rows, their ranks laid end to end: lane k holds row k, whose
// ranks [rank_lo, min(n_rect, rank_hi)) take the flat indices [excl, incl).
// Round t tests flat indices 32 t + lane, so a round's lanes hold the
// ranks of as many rows as it takes to fill them, in row order, a row's
// ranks ascending: the order the instances are written in.
struct WarpRows {
  uint32_t w[6];
  Reach reach;
  int excl, incl, len;  // this lane's row's flat range; the warp's flat total

  // The flat index f of this lane in round t: its row's lane (the rows
  // ending at or before f, a search over the lanes' incl) and its rank.
  __device__ __forceinline__ int2 locate(int f, int rank_lo) const {
    int r = 0;
#pragma unroll
    for (int b = 16; b > 0; b >>= 1)
      if (__shfl_sync(FULL_MASK, incl, r + b - 1) <= f) r += b;
    r = min(r, 31);  // lanes past the warp's total (f >= len) test nothing
    return make_int2(r, rank_lo + f - __shfl_sync(FULL_MASK, excl, r));
  }

  // Round t's reach tests: the warp's ballot of its kept flat indices.
  __device__ __forceinline__ unsigned test(int t, const WalkParams& p) const {
    const int f = 32 * t + (threadIdx.x & 31);
    const int2 rj = locate(f, p.rank_lo);
    const RowRect rc = row_rect(__shfl_sync(FULL_MASK, w[0], rj.x));
    const Reach rh{__shfl_sync(FULL_MASK, reach.px, rj.x), __shfl_sync(FULL_MASK, reach.py, rj.x),
                   __shfl_sync(FULL_MASK, reach.ha, rj.x), __shfl_sync(FULL_MASK, reach.hb, rj.x),
                   __shfl_sync(FULL_MASK, reach.hc, rj.x),
                   __shfl_sync(FULL_MASK, reach.a_max, rj.x)};
    bool ok = false;
    if (f < len) {
      const int dy = rj.y / rc.w_t;
      ok = rh.reaches(rc.tx0 + (rj.y - dy * rc.w_t), rc.ty0 + dy, p.ts_x, p.ts_y);
    }
    return __ballot_sync(FULL_MASK, ok);
  }
};

// s.counters: [0] instances emitted (may exceed capacity), [1] giant rows
// (may exceed giant_capacity); status streams: 0 instances, 1 giants.  A
// persistent grid: each block takes tiles by ticket until the first past
// min(*n_ptr, n_cap).
__global__ void __launch_bounds__(WALK_BLOCK)
    overflow_walk_kernel(const uint32_t* __restrict__ rows, int row_stride,
                         const int* __restrict__ n_ptr, int n_cap, WalkParams p,
                         uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                         int64_t words_ld, int capacity, uint32_t* __restrict__ giants,
                         int giant_capacity, OrderedScratch s) {
  __shared__ unsigned kept[WALK_WARPS][WALK_KEPT_ROUNDS];
  __shared__ int warp_n[WALK_WARPS], warp_g[WALK_WARPS];
  __shared__ int base_n, base_g, s_tile;
  const int n = min(*n_ptr, n_cap);
  const int warp_rows = walk_warp_rows(n, gridDim.x), tile_rows = WALK_WARPS * warp_rows;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // block-uniform: past the last live tile every block stops; take_tile's
  // barrier also orders the shared words' reuse from one tile to the next
  for (int tile = take_tile(s.ticket, &s_tile); tile < tiles;
       tile = take_tile(s.ticket, &s_tile)) {
    // the warp's rows [first, first + nr): lane k loads and decodes row
    // first + k, every load of the tile issued before any rank is tested
    const int first = tile * tile_rows + warp * warp_rows;
    const bool valid = lane < min(warp_rows, n - first);
    WarpRows wr;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      wr.w[k] = valid ? rows[(int64_t)k * row_stride + first + lane] : 0u;
    const RowRect rc = row_rect(wr.w[0]);
    const int n_rect = rc.w_t * ((int)(wr.w[0] >> 24) - rc.ty0 + 1);
    const int ranks = valid ? max(min(n_rect, p.rank_hi) - p.rank_lo, 0) : 0;
    const bool giant = valid && n_rect > p.giant_thresh;
    wr.reach = Reach{};
    if (valid) {
      const Record r = unpack_record(wr.w[1], wr.w[2], wr.w[3], wr.w[4], p.cq);
      wr.reach = Reach{r.px, r.py, r.ha, r.hb, r.hc, alpha_bound(r.op, p.inv_thr)};
    }
    wr.incl = ranks;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, wr.incl, o);
      if (lane >= o) wr.incl += v;
    }
    wr.excl = wr.incl - ranks;
    wr.len = __shfl_sync(FULL_MASK, wr.incl, 31);
    const int rounds = (wr.len + 31) / 32;

    // pass 1: the warp's kept count, its first round masks kept
    int count = 0;
    for (int t = 0; t < rounds; ++t) {
      const unsigned m = wr.test(t, p);
      count += __popc(m);
      if (lane == 0 && t < WALK_KEPT_ROUNDS) kept[warp][t] = m;
    }

    // the block's reservation: the warps' totals in shared memory, one
    // look-back per stream
    const unsigned gmask = __ballot_sync(FULL_MASK, giant);
    if (lane == 0) {
      warp_n[warp] = count;
      warp_g[warp] = __popc(gmask);
    }
    __syncthreads();
    if (warp < 2) {
      int total = lane < WALK_WARPS ? (warp == 0 ? warp_n[lane] : warp_g[lane]) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL_MASK, total, o);
      const long long b = lookback(s.stream(warp), tile, (unsigned long long)total);
      if (lane == 0) {
        (warp == 0 ? base_n : base_g) = (int)b;
        if (total > 0) atomicAdd(&s.counters[warp], total);
      }
    }
    int off_n = 0, off_g = 0;  // the warp's place in the block's runs
    for (int k = 0; k < warp; ++k) {
      off_n += warp_n[k];
      off_g += warp_g[k];
    }
    __syncthreads();

    // pass 2: lane k forwards its giant row; the kept ranks go out round by
    // round (rounds past the kept masks are tested again)
    const int gpos = base_g + off_g + __popc(gmask & lt);
    if (giant && gpos < giant_capacity) {
#pragma unroll
      for (int k = 0; k < 6; ++k) giants[(int64_t)k * giant_capacity + gpos] = wr.w[k];
    }
    int pos = base_n + off_n;
    for (int t = 0; t < rounds && pos < capacity; ++t) {  // warp-uniform
      const unsigned m = t < WALK_KEPT_ROUNDS ? kept[warp][t] : wr.test(t, p);
      if (m == 0u) continue;
      const int2 rj = wr.locate(32 * t + lane, p.rank_lo);
      const RowRect rr = row_rect(__shfl_sync(FULL_MASK, wr.w[0], rj.x));
      uint32_t row_words[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) row_words[k] = __shfl_sync(FULL_MASK, wr.w[1 + k], rj.x);
      const int q = pos + __popc(m & lt);
      if (((m >> lane) & 1u) && q < capacity) {
        const int dy = rj.y / rr.w_t;
        const int tx = rr.tx0 + (rj.y - dy * rr.w_t), ty = rr.ty0 + dy;
        keys[q] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | row_words[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) words[k * words_ld + q] = row_words[k];
      }
      pos += __popc(m);
    }
  }
}

// Blocks of the walk the card holds at once, for the current device (the
// persistent grid's cap); queried once.  0 or a cudaError_t.
inline int walk_resident_blocks(int* out) {
  static int device = -1, blocks = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != device) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ==
            cudaSuccess &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, overflow_walk_kernel,
                                                             WALK_BLOCK, 0)) == cudaSuccess) {
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      blocks = per_sm * sms;
      device = dev;
    }
  }
  *out = blocks;
  return (int)err;
}

// the scratch's tiles: the smallest tile's, WALK_WARPS rows
inline int walk_tiles(int n_cap) { return (n_cap + WALK_WARPS - 1) / WALK_WARPS; }

}  // namespace ws

extern "C" {

// the rows of the smallest tile, one status word's, which ops/overflow.py
// mirrors (chip_smoke.py phase 1 holds them equal)
int ws_overflow_walk_min_tile_rows() { return ws::WALK_WARPS; }

// the blocks a walk over n_cap rows launches on the current device, or
// minus a cudaError_t
int ws_overflow_walk_grid(int n_cap) {
  int blocks = 0;
  const int err = ws::walk_resident_blocks(&blocks);
  if (err != 0) return -err;
  return n_cap > 0 ? std::min(blocks, ws::walk_tiles(n_cap)) : 0;
}

// the rows a tile holds for n live rows of n_cap, or minus a cudaError_t
int ws_overflow_walk_tile_rows(int n, int n_cap) {
  const int grid = ws_overflow_walk_grid(n_cap);
  if (grid < 1) return grid;
  return ws::WALK_WARPS * ws::walk_warp_rows(std::min(std::max(n, 0), n_cap), grid);
}

// icfg: rank_lo, rank_hi, giant_thresh, tx_tiles, tile_w, tile_h, depth_bits
// fcfg: f32(1/alpha_threshold) (0 when off), margin, scale_x, scale_y
// words: 4 rows of words_ld u32 (capacity of them written at most)
// scratch: scratch_words u64 (stream.cuh: 2 streams, ceil(n_cap /
// WALK_WARPS) tiles), zeroed here; its first two ints end at the stats
// [instances emitted, giant rows], its ticket at the tiles taken plus the
// grid
int ws_overflow_walk(const uint32_t* rows, int row_stride, const int* n_ptr, int n_cap,
                     const int* icfg, const float* fcfg, uint32_t* keys, uint32_t* words,
                     int64_t words_ld, int capacity, uint32_t* giants, int giant_capacity,
                     void* scratch, int64_t scratch_words, void* stream) {
  ws::WalkParams p{icfg[0], icfg[1], icfg[2], icfg[3], icfg[4], icfg[5], icfg[6],
                   fcfg[0], ws::CenterQuant{fcfg[1], fcfg[2], fcfg[3]}};
  const int tiles = ws::walk_tiles(n_cap);
  int err = ws::clear_scratch(scratch, scratch_words, 2, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  if (n_cap > 0) {
    int blocks = 0;
    if ((err = ws::walk_resident_blocks(&blocks)) != 0) return err;
    ws::overflow_walk_kernel<<<std::min(blocks, tiles), ws::WALK_BLOCK, 0, (cudaStream_t)stream>>>(
        rows, row_stride, n_ptr, n_cap, p, keys, words, words_ld, capacity, giants,
        giant_capacity, ws::ordered_scratch(scratch, tiles));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
