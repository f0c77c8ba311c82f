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
// (rank_hi - rank_lo) reach tests of ~40 f32 operations each (126 ranks in
// the second call), writing 20 bytes per kept instance; with ~26k rows at
// the bench scene it is a small, latency-bound launch.  Its design: one
// thread per row; the rank -> (dx, dy) map is a real integer division (the
// TPU kernel carried dx, dy incrementally because Mosaic has no vector
// integer division); the reach test decodes the record with the same codecs
// as the rasterizer and divides like make_reaches (the TPU kernel multiplied
// by hoisted reciprocals); a count pass and a write pass around one block
// scan + atomicAdd per block give an exact-prefix output (stream.cuh).
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int WALK_BLOCK = 128;

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
  __shared__ BlockAppend<WALK_BLOCK> append;
  const int n = min(*n_ptr, n_cap);
  const int i = blockIdx.x * WALK_BLOCK + threadIdx.x;
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

  int count = 0;
  for (int j = p.rank_lo; j < j_end; ++j) {
    const int dy = j / w_t;
    count += reach.reaches(tx0 + (j - dy * w_t), ty0 + dy, p.ts_x, p.ts_y) ? 1 : 0;
  }
  int pos = append.reserve(count, &stats[0]);
  for (int j = p.rank_lo; j < j_end && count > 0; ++j) {
    const int dy = j / w_t;
    const int tx = tx0 + (j - dy * w_t), ty = ty0 + dy;
    if (!reach.reaches(tx, ty, p.ts_x, p.ts_y)) continue;
    if (pos < capacity) {
      keys[pos] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | w[5];
#pragma unroll
      for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + pos] = w[1 + k];
    }
    ++pos;
    --count;
  }

  const bool giant = valid && n_rect > p.giant_thresh;
  const int gpos = append.reserve(giant ? 1 : 0, &stats[1]);
  if (giant && gpos < giant_capacity) {
#pragma unroll
    for (int k = 0; k < 6; ++k) giants[(int64_t)k * giant_capacity + gpos] = w[k];
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
    const int grid = (n_cap + ws::WALK_BLOCK - 1) / ws::WALK_BLOCK;
    ws::overflow_walk_kernel<<<grid, ws::WALK_BLOCK, 0, (cudaStream_t)stream>>>(
        rows, row_stride, n_ptr, n_cap, p, keys, words, capacity, giants, giant_capacity,
        stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
