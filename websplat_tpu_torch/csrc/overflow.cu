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
// reserves its output with one atomicAdd for instances and one for giants
// (lane 0 of each warp forwards its row), so the output is an exact prefix
// (stream.cuh's rule).  The grid is sized from n_cap and blocks past
// min(*n_ptr, n_cap) exit at once, so the row count stays on the device (a
// grid that fills the card once and strides over the rows timed the same
// at the bench scene).  The rank -> (dx, dy) map is a real integer
// division and the reach test decodes the record with the rasterizer's
// codecs and divides like make_reaches, so it stays bit-equal to
// decoded_reaches.
#include <cstdint>

#include "packing.cuh"

namespace ws {

constexpr int WALK_WARPS = 8;
constexpr int WALK_BLOCK = 32 * WALK_WARPS;
constexpr int WALK_ROUNDS = 4;  // rank rounds of 32 per reservation
constexpr unsigned FULL_MASK = 0xffffffffu;

struct WalkParams {
  int rank_lo, rank_hi, giant_thresh;
  int tx_tiles, ts_x, ts_y, depth_bits;
  float inv_thr;
  CenterQuant cq;
};

// stats: [0] instances emitted (may exceed capacity),
//        [1] giant rows (may exceed giant_capacity)
__global__ void __launch_bounds__(WALK_BLOCK)
    overflow_walk_kernel(const uint32_t* __restrict__ rows, int row_stride,
                         const int* __restrict__ n_ptr, int n_cap, WalkParams p,
                         uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                         int capacity, uint32_t* __restrict__ giants, int giant_capacity,
                         int* __restrict__ stats) {
  __shared__ int warp_n[WALK_WARPS], warp_g[WALK_WARPS];
  __shared__ int base_n, base_g;
  const int n = min(*n_ptr, n_cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  constexpr int GROUP = 32 * WALK_ROUNDS;
  const int groups = max((p.rank_hi - p.rank_lo + GROUP - 1) / GROUP, 1);

  const int row0 = blockIdx.x * WALK_WARPS;
  if (row0 >= n) return;  // block-uniform: no barrier is skipped by part of it
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

  for (int grp = 0; grp < groups; ++grp) {
    const int j0 = p.rank_lo + grp * GROUP;
    unsigned mask[WALK_ROUNDS];
    uint32_t key[WALK_ROUNDS];
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

    // block reservation: warp totals scanned in shared memory, one
    // atomicAdd per stream
    __syncthreads();  // the previous reservation's slots are read
    if (lane == 0) {
      warp_n[warp] = count;
      warp_g[warp] = (grp == 0 && giant) ? 1 : 0;
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
      base_n = sn > 0 ? atomicAdd(&stats[0], sn) : 0;
      base_g = sg > 0 ? atomicAdd(&stats[1], sg) : 0;
    }
    __syncthreads();

    int pos = base_n + warp_n[warp];
#pragma unroll
    for (int r = 0; r < WALK_ROUNDS; ++r) {
      if ((mask[r] >> lane) & 1u) {
        const int q = pos + __popc(mask[r] & lt);
        if (q < capacity) {
          keys[q] = key[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + q] = w[1 + k];
        }
      }
      pos += __popc(mask[r]);
    }
    const int gpos = base_g + warp_g[warp];
    if (grp == 0 && giant && lane == 0 && gpos < giant_capacity) {
#pragma unroll
      for (int k = 0; k < 6; ++k) giants[(int64_t)k * giant_capacity + gpos] = w[k];
    }
  }
}

}  // namespace ws

extern "C" {

// icfg: rank_lo, rank_hi, giant_thresh, tx_tiles, tile_w, tile_h, depth_bits
// fcfg: f32(1/alpha_threshold) (0 when off), margin, scale_x, scale_y
int ws_overflow_walk(const uint32_t* rows, int row_stride, const int* n_ptr, int n_cap,
                     const int* icfg, const float* fcfg, uint32_t* keys, uint32_t* words,
                     int capacity, uint32_t* giants, int giant_capacity, int* stats,
                     void* stream) {
  ws::WalkParams p{icfg[0], icfg[1], icfg[2], icfg[3], icfg[4], icfg[5], icfg[6],
                   fcfg[0], ws::CenterQuant{fcfg[1], fcfg[2], fcfg[3]}};
  if (n_cap > 0) {
    const int grid = (n_cap + ws::WALK_WARPS - 1) / ws::WALK_WARPS;
    ws::overflow_walk_kernel<<<grid, ws::WALK_BLOCK, 0, (cudaStream_t)stream>>>(
        rows, row_stride, n_ptr, n_cap, p, keys, words, capacity, giants, giant_capacity,
        stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
