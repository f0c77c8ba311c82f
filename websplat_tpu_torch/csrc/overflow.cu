// Overflow rank walk over clamped-splat rows.
//
// Replaces websplat_tpu/ops/overflow_pallas.py:_make_kernel (called by
// overflow_walk).  For each of the first n = min(*n_ptr, n_cap) 6-word rows
// (rect4, w0..w3, depth_q) it emits the rect's row-major ranks
// [rank_lo, min(n_rect, rank_hi)) whose tile the splat reaches, and forwards
// rows with n_rect > giant_thresh as a second 6-word stream.  The main path
// runs it twice per frame: ranks [6, 32) over the frontend's clamped rows,
// then [32, 160) over the giants.
//
// What bounds it on the card: per row it reads 24 bytes and runs up to
// (rank_hi - rank_lo) reach tests of ~52 f32 operations, writing 20 bytes
// per kept instance; at the bench scene both levels together move ~2.9 MB
// and run ~211k reach tests (bound ~1 us), so a launch takes far longer
// than its work needs: its time is latency (dependent reach tests, the
// block's reservation), not throughput.  So the lanes of a warp hold
// ranks, not rows: a warp takes one row, lane l tests ranks
// rank_lo + l + 32 r, so level 1 (26 ranks) is one round and level 2 (128
// ranks) four, where one thread per row would run up to 128 tests in a
// chain.  Every lane decodes the row itself (the six words are broadcast
// loads; decoding in one lane and shuffling timed slower).  One pass: each
// round's __ballot_sync gives the warp's count (__popc) and each lane's
// offset (__popc(mask & lanemask_lt)); the round masks and keys stay in
// registers.  The warps' totals are scanned in shared memory and the block
// reserves its runs of instances and of giants (lane 0 of each warp
// forwards its row) once each, in tile order (stream.cuh: a ticket and a
// decoupled look-back, one warp per stream), so the output is an exact
// prefix in row order, a row's ranks ascending: the plain version's order,
// element for element, and the giants past a capacity are the same rows.
// Where a row has more than one group of 128 ranks (overflow_window_slots
// - overflow_slots > 128) the block counts every group first and tests
// them again when it writes, so its rows stay in order.  The tiles are
// sized from n_cap and tiles past min(*n_ptr, n_cap) publish an empty run
// and exit, so the row count stays on the device (a grid that fills the
// card once and strides over the rows timed the same at the bench scene).
// The rank -> (dx, dy) map is a real integer division and the reach test
// decodes the record with the rasterizer's codecs and divides like
// make_reaches, so it stays bit-equal to decoded_reaches.
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int WALK_WARPS = 8;
constexpr int WALK_BLOCK = 32 * WALK_WARPS;
constexpr int WALK_ROUNDS = 4;  // rank rounds of 32 per group
constexpr unsigned FULL_MASK = 0xffffffffu;

struct WalkParams {
  int rank_lo, rank_hi, giant_thresh;
  int tx_tiles, ts_x, ts_y, depth_bits;
  float inv_thr;
  CenterQuant cq;
};

// s.counters: [0] instances emitted (may exceed capacity), [1] giant rows
// (may exceed giant_capacity); status streams: 0 instances, 1 giants
__global__ void __launch_bounds__(WALK_BLOCK)
    overflow_walk_kernel(const uint32_t* __restrict__ rows, int row_stride,
                         const int* __restrict__ n_ptr, int n_cap, WalkParams p,
                         uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                         int64_t words_ld, int capacity, uint32_t* __restrict__ giants,
                         int giant_capacity, OrderedScratch s) {
  __shared__ int warp_n[WALK_WARPS], warp_g[WALK_WARPS];
  __shared__ int sum_n, sum_g, base_n, base_g, s_tile;
  const int tile = take_tile(s.ticket, &s_tile);
  const int n = min(*n_ptr, n_cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  constexpr int GROUP = 32 * WALK_ROUNDS;
  const int groups = max((p.rank_hi - p.rank_lo + GROUP - 1) / GROUP, 1);

  const int row0 = tile * WALK_WARPS;
  if (row0 >= n) {  // block-uniform: no barrier is skipped by part of it
    skip_tile(s, tile, 2);
    return;
  }
  const int i = row0 + warp;
  const bool valid = i < n;
  uint32_t w[6];
  int tx0 = 0, ty0 = 0, w_t = 1, n_rect = 1;
  Reach reach;
  if (valid) {
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = rows[(int64_t)k * row_stride + i];
    tx0 = (int)(w[0] & 0xFFu);
    ty0 = (int)((w[0] >> 8) & 0xFFu);
    const int tx1 = (int)((w[0] >> 16) & 0xFFu);
    const int ty1 = (int)(w[0] >> 24);
    w_t = tx1 - tx0 + 1;
    n_rect = w_t * (ty1 - ty0 + 1);
    const Record r = unpack_record(w[1], w[2], w[3], w[4], p.cq);
    reach = Reach{r.px, r.py, r.ha, r.hb, r.hc, alpha_bound(r.op, p.inv_thr)};
  }
  const int j_end = valid ? min(n_rect, p.rank_hi) : 0;
  const bool giant = valid && n_rect > p.giant_thresh;

  // one group of ranks: each round's ballot mask and each lane's key
  unsigned mask[WALK_ROUNDS];
  uint32_t key[WALK_ROUNDS];
  auto walk_group = [&](int grp) {
    const int j0 = p.rank_lo + grp * GROUP;
    int count = 0;
#pragma unroll
    for (int r = 0; r < WALK_ROUNDS; ++r) {
      const int j = j0 + 32 * r + lane;
      bool ok = false;
      key[r] = 0u;
      if (j < j_end) {
        const int dy = j / w_t;
        const int tx = tx0 + (j - dy * w_t), ty = ty0 + dy;
        ok = reach.reaches(tx, ty, p.ts_x, p.ts_y);
        key[r] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | w[5];
      }
      mask[r] = __ballot_sync(FULL_MASK, ok);
      count += __popc(mask[r]);
    }
    return count;
  };
  // pass 1: the row's kept ranks over every group (one group: the masks
  // and keys stay in registers for pass 2)
  int count = 0;
  for (int grp = 0; grp < groups; ++grp) count += walk_group(grp);

  // the block's reservation: warp totals scanned in shared memory, one
  // look-back per stream
  if (lane == 0) {
    warp_n[warp] = count;
    warp_g[warp] = giant ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sn = 0, sg = 0;
#pragma unroll
    for (int k = 0; k < WALK_WARPS; ++k) {
      const int cn = warp_n[k], cg = warp_g[k];
      warp_n[k] = sn;
      warp_g[k] = sg;
      sn += cn;
      sg += cg;
    }
    sum_n = sn;
    sum_g = sg;
  }
  __syncthreads();
  if (warp < 2) {
    const int total = warp == 0 ? sum_n : sum_g;
    const long long b = lookback(s.stream(warp), tile, (unsigned long long)total);
    if (lane == 0) {
      (warp == 0 ? base_n : base_g) = (int)b;
      if (total > 0) atomicAdd(&s.counters[warp], total);
    }
  }
  __syncthreads();

  // pass 2: a row's ranks in ascending order from its warp's offset
  int pos = base_n + warp_n[warp];
  for (int grp = 0; grp < groups; ++grp) {
    if (groups > 1) walk_group(grp);
#pragma unroll
    for (int r = 0; r < WALK_ROUNDS; ++r) {
      if ((mask[r] >> lane) & 1u) {
        const int q = pos + __popc(mask[r] & lt);
        if (q < capacity) {
          keys[q] = key[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) words[k * words_ld + q] = w[1 + k];
        }
      }
      pos += __popc(mask[r]);
    }
  }
  const int gpos = base_g + warp_g[warp];
  if (giant && lane == 0 && gpos < giant_capacity) {
#pragma unroll
    for (int k = 0; k < 6; ++k) giants[(int64_t)k * giant_capacity + gpos] = w[k];
  }
}

}  // namespace ws

extern "C" {

// icfg: rank_lo, rank_hi, giant_thresh, tx_tiles, tile_w, tile_h, depth_bits
// fcfg: f32(1/alpha_threshold) (0 when off), margin, scale_x, scale_y
// words: 4 rows of words_ld u32 (capacity of them written at most)
// scratch: scratch_words u64 (stream.cuh: 2 streams, ceil(n_cap / 8)
// tiles), zeroed here; its first two ints end at the stats [instances
// emitted, giant rows]
int ws_overflow_walk(const uint32_t* rows, int row_stride, const int* n_ptr, int n_cap,
                     const int* icfg, const float* fcfg, uint32_t* keys, uint32_t* words,
                     int64_t words_ld, int capacity, uint32_t* giants, int giant_capacity,
                     void* scratch, int64_t scratch_words, void* stream) {
  ws::WalkParams p{icfg[0], icfg[1], icfg[2], icfg[3], icfg[4], icfg[5], icfg[6],
                   fcfg[0], ws::CenterQuant{fcfg[1], fcfg[2], fcfg[3]}};
  const int tiles = (n_cap + ws::WALK_WARPS - 1) / ws::WALK_WARPS;
  const int err = ws::clear_scratch(scratch, scratch_words, 2, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  if (n_cap > 0) {
    ws::overflow_walk_kernel<<<tiles, ws::WALK_BLOCK, 0, (cudaStream_t)stream>>>(
        rows, row_stride, n_ptr, n_cap, p, keys, words, words_ld, capacity, giants,
        giant_capacity, ws::ordered_scratch(scratch, tiles));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
