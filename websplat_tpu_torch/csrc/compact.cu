// Stream compaction, and the dense extreme-tail grid emitted and compacted
// in one pass.
//
// Both replace websplat_tpu/ops/compact_pallas.py:_compact_kernel (called by
// compact_instances).
//
// compact_kernel drops rows keyed 0xFFFFFFFF from any stream: the general
// compactor, the counterpart of compact_instances.  No render path launches
// it: the culled compressed decode, its one caller, became
// csrc/decompress.cu:cull_decode_kernel, which compacts and decodes in one
// pass; chip_smoke.py holds it against its plain version on the dense grid
// and on view 0's culled stream (5 payload words).  What bounds it on the
// card: pure memory traffic -- it reads 4 + 4 * n_payload bytes per row and
// writes the same per kept row -- and, at the sizes it sees, launch latency.
// Its design: one thread per row, a block scan of the keep flags and one
// ordered reservation per block (stream.cuh: tile order by decoupled
// look-back) -- the TPU version's bit-serial monotone shuffle, ALIGN-rounded
// block offsets and chained DMAs existed only because the TPU has no scatter
// and no atomics.  The output is an exact prefix (the TPU left up to 127
// sentinels per 4096-row block) in input order, as the plain version's.
//
// dense_compact_kernel is the main path's form of the same stage: the JAX
// frame builds the dense (n_tiles x mega capacity) candidate grid in XLA
// (preprocess.py:dense_grid_emit, 192,850 rows of 5 words at the bench
// scene, nearly all sentinels) and compacts it with the kernel above
// (renderer.py:510-522).  Here the grid never exists: for each of the first
// min(*n_ptr, m_cap) 6-word mega rows (rect4, w0..w3, depth_q) the kernel
// walks the rect's row-major ranks [rank_lo, n_rect) whose tile lies in the
// grid, runs the decoded reach test and appends only the instances it
// keeps.  What bounds it: 24 bytes per row read, 20 per kept instance
// written and one reach test per rank -- under a microsecond at the bench
// scene, far below one launch, so its time is latency.  Few rows (~52 at
// the bench views) with many ranks (up to 790 each), so the tiles are (row,
// rank block), row-major: a CTA of 256 threads takes 256 ranks of one row,
// every thread decodes the row from broadcast loads and the block makes one
// ordered reservation, so the output runs row by row, ranks ascending
// within a row.  Tiles of rows at or past the device-side row count publish
// an empty run and exit, so the count is never read on the host.  The reach
// test is packing.cuh's, as in the overflow walk, so the kernel stays
// bit-equal to decoded_reaches.
#include <cstdint>

#include "packing.cuh"
#include "stream.cuh"

namespace ws {

constexpr int COMPACT_BLOCK = 256;
constexpr int DENSE_BLOCK = 256;

__global__ void __launch_bounds__(COMPACT_BLOCK)
    compact_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ payload,
                   int n_payload, int64_t m, uint32_t* __restrict__ out_keys,
                   uint32_t* __restrict__ out_payload, int64_t capacity, OrderedScratch s) {
  __shared__ BlockAppend<COMPACT_BLOCK> append;
  const int64_t i = (int64_t)append.take(s) * COMPACT_BLOCK + threadIdx.x;
  const uint32_t key = i < m ? keys[i] : INVALID_KEY;
  const bool keep = key != INVALID_KEY;
  const int pos = append.reserve(keep ? 1 : 0, s);
  if (keep && pos < capacity) {
    out_keys[pos] = key;
    for (int k = 0; k < n_payload; ++k) out_payload[k * capacity + pos] = payload[k * m + i];
  }
}

struct DenseParams {
  int rank_lo, tx_tiles, ty_tiles, ts_x, ts_y, depth_bits, rank_blocks;
  float inv_thr;
  CenterQuant cq;
};

// counter: ends at the number of kept instances (may exceed capacity)
__global__ void __launch_bounds__(DENSE_BLOCK)
    dense_compact_kernel(const uint32_t* __restrict__ rows, const int* __restrict__ n_ptr,
                         int m_cap, DenseParams p, uint32_t* __restrict__ keys,
                         uint32_t* __restrict__ words, int64_t words_ld, int capacity,
                         OrderedScratch s) {
  __shared__ BlockAppend<DENSE_BLOCK> append;
  const int tile = append.take(s);
  const int i = tile / p.rank_blocks;
  const int j0 = p.rank_lo + (tile - i * p.rank_blocks) * DENSE_BLOCK;
  if (i >= min(*n_ptr, m_cap)) {  // block-uniform: no barrier is skipped by part of it
    skip_tile(s, tile, 1);
    return;
  }
  uint32_t w[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = rows[(int64_t)k * m_cap + i];
  const int tx0 = (int)(w[0] & 0xFFu);
  const int ty0 = (int)((w[0] >> 8) & 0xFFu);
  const int w_t = (int)((w[0] >> 16) & 0xFFu) - tx0 + 1;
  const int h_t = (int)(w[0] >> 24) - ty0 + 1;
  const int n_rect = (w_t > 0 && h_t > 0) ? w_t * h_t : 0;
  if (j0 >= n_rect) {  // block-uniform
    skip_tile(s, tile, 1);
    return;
  }

  const Record r = unpack_record(w[1], w[2], w[3], w[4], p.cq);
  const Reach reach{r.px, r.py, r.ha, r.hb, r.hc, alpha_bound(r.op, p.inv_thr)};
  // the launch covers ranks below n_tiles; only a rect that extends past
  // the tile grid has more, at a stride of the launch's rank blocks: such
  // a tile counts its ranks first and tests them again when it writes
  const int stride = p.rank_blocks * DENSE_BLOCK;
  const bool one_pass = j0 + stride >= n_rect;  // block-uniform
  auto test = [&](int j, uint32_t& key) {
    key = 0u;
    if (j >= n_rect) return false;
    const int dy = j / w_t;
    const int tx = tx0 + (j - dy * w_t), ty = ty0 + dy;
    if (tx >= p.tx_tiles || ty >= p.ty_tiles) return false;
    key = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | w[5];
    return reach.reaches(tx, ty, p.ts_x, p.ts_y);
  };
  uint32_t key0;
  const bool ok0 = test(j0 + (int)threadIdx.x, key0);
  int count = ok0 ? 1 : 0;
  if (!one_pass) {
    uint32_t key;
    for (int j = j0 + stride + (int)threadIdx.x; j < n_rect; j += stride) count += test(j, key);
  }
  int pos = append.reserve(count, s);
  auto put = [&](uint32_t key) {
    if (pos < capacity) {
      keys[pos] = key;
#pragma unroll
      for (int k = 0; k < 4; ++k) words[k * words_ld + pos] = w[1 + k];
    }
    ++pos;
  };
  if (ok0) put(key0);
  if (!one_pass) {
    uint32_t key;
    for (int j = j0 + stride + (int)threadIdx.x; j < n_rect; j += stride)
      if (test(j, key)) put(key);
  }
}

}  // namespace ws

extern "C" {

// payload: (n_payload, m) rows; out_payload: (n_payload, capacity) rows;
// scratch: scratch_words u64 (stream.cuh), zeroed here; its first int ends
// at the number of kept rows
int ws_compact(const uint32_t* keys, const uint32_t* payload, int n_payload, int64_t m,
               uint32_t* out_keys, uint32_t* out_payload, int64_t capacity, void* scratch,
               int64_t scratch_words, void* stream) {
  const int64_t tiles = (m + ws::COMPACT_BLOCK - 1) / ws::COMPACT_BLOCK;
  const int err = ws::clear_scratch(scratch, scratch_words, 1, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  if (m > 0) {
    ws::compact_kernel<<<(unsigned)tiles, ws::COMPACT_BLOCK, 0, (cudaStream_t)stream>>>(
        keys, payload, n_payload, m, out_keys, out_payload, capacity,
        ws::ordered_scratch(scratch, tiles));
  }
  return (int)cudaGetLastError();
}

// rows: (6, m_cap) mega rows, the first min(*n_ptr, m_cap) valid;
// icfg: rank_lo, tx_tiles, ty_tiles, tile_w, tile_h, depth_bits;
// fcfg: f32(1/alpha_threshold) (0 when off), margin, scale_x, scale_y;
// keys: capacity u32, words: 4 rows of words_ld u32 (capacity of them
// written at most); scratch: scratch_words u64
// (stream.cuh; m_cap * max(ceil((tx_tiles * ty_tiles - rank_lo) / 256), 1)
// tiles), zeroed here; its first int ends at the number of kept instances
int ws_dense_compact(const uint32_t* rows, const int* n_ptr, int m_cap,
                     const int* icfg, const float* fcfg, uint32_t* keys, uint32_t* words,
                     int64_t words_ld, int capacity, void* scratch, int64_t scratch_words,
                     void* stream) {
  const int span = icfg[1] * icfg[2] - icfg[0];
  const int rank_blocks = span > 0 ? (span + ws::DENSE_BLOCK - 1) / ws::DENSE_BLOCK : 1;
  ws::DenseParams p{icfg[0], icfg[1], icfg[2], icfg[3], icfg[4], icfg[5], rank_blocks,
                    fcfg[0], ws::CenterQuant{fcfg[1], fcfg[2], fcfg[3]}};
  const int64_t tiles = (int64_t)m_cap * rank_blocks;
  const int err = ws::clear_scratch(scratch, scratch_words, 1, tiles, (cudaStream_t)stream);
  if (err != 0) return err;
  if (m_cap > 0) {
    ws::dense_compact_kernel<<<(unsigned)tiles, ws::DENSE_BLOCK, 0, (cudaStream_t)stream>>>(
        rows, n_ptr, m_cap, p, keys, words, words_ld, capacity,
        ws::ordered_scratch(scratch, tiles));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
