// Fused frame frontend: per-splat preprocess + record packing + row-major
// slot emission + clamped-splat capture, in one pass over the cloud.
//
// Replaces websplat_tpu/ops/frontend_pallas.py:_make_kernel (called by
// fused_frontend), on the branch the main path takes (overflow on: pure
// row-major walk over ranks [0, slots), frontend_pallas.py:348), for
// uncompressed and compressed clouds: p.compressed, uniform over the launch,
// selects the compressed eigen clamp (core_math.cuh:shape_math).
//
// What bounds it on the card: memory traffic.  The function needs 12 bytes
// of position per splat, the other 124 bytes of attributes (covariance,
// opacity, 24 words of SH) only for splats that pass the cull, and writes
// 20 bytes per emitted instance plus 24 per clamped splat; its ~400 f32
// operations per visible splat (EWA, eigen, 48 SH terms, record codecs, up
// to `slots` reach tests) sit below the memory time.  Its design: one thread
// per splat, reading the column-major cloud coalesced (no interleaved
// relayout, which the TPU needed to cut DMA streams), in the order the math
// needs it:
//  - the position first, then the frustum cull (core_math.cuh:frustum_cull);
//    a NaN position (the culled compressed decompression's rows past its
//    count) fails every one of its comparisons (no fast math), so such a
//    row is not visible, copies no SH and counts nowhere;
//  - for splats that pass it, the 24 SH words go to shared memory by
//    cp.async at once (24 KB per CTA), and the covariance and opacity are
//    loaded; EWA, eigen, the reach, the slot walk and the block scan run
//    while the SH copies fly, and only a splat that writes a row evaluates
//    SH and packs its record (core_math.cuh:pack_splat), from shared memory;
//  - ONE block scan over each thread's packed (instances, clamped, visible)
//    counts and at most three atomics per block reserve the block's runs of
//    the exact-prefix outputs (the TPU's sequential SMEM cursor and
//    ordered-overlap DMA protocol have no counterpart here).
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "core_math.cuh"
#include "cp_async.cuh"

namespace ws {

constexpr int FRONT_BLOCK = 256;
// 5 CTAs per SM: 48 registers and no spills (ptxas); a cap at 6 spills and
// ran slower on the H100
constexpr int FRONT_MIN_BLOCKS = 5;
constexpr int SH_WORDS = 24;
// fields of the packed per-thread count: instances in bits 0-12 (a block
// emits at most 16 x 256), clamped rows in 13-21 and visible splats in
// 22-30 (at most 256 each), so the block sums never carry across fields
constexpr int CLAMP_SHIFT = 13;
constexpr int VIS_SHIFT = 22;
constexpr int FIELD_MASK = (1 << 9) - 1;

// stats: [0] instances emitted (may exceed capacity), [1] visible splats,
// [2] clamped splats (visible, n_rect > slots; may exceed capacity_c)
__global__ void __launch_bounds__(FRONT_BLOCK, FRONT_MIN_BLOCKS)
    frontend_kernel(const float* __restrict__ xyz, const float* __restrict__ cov,
                    const float* __restrict__ opacity, const uint32_t* __restrict__ sh, int n,
                    FrameParams p, uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                    int capacity, uint32_t* __restrict__ cid, int capacity_c,
                    int* __restrict__ stats) {
  using Scan = cub::BlockScan<int, FRONT_BLOCK>;
  __shared__ uint32_t s_sh[SH_WORDS][FRONT_BLOCK];  // word k of thread t at [k][t]
  __shared__ typename Scan::TempStorage scan;
  __shared__ int s_base[2];
  const int i = blockIdx.x * FRONT_BLOCK + threadIdx.x;

  float x_w = 0.0f, y_w = 0.0f, z_w = 0.0f;
  Shape s;
  s.visible = false;
  if (i < n) {
    x_w = xyz[i];
    y_w = xyz[(int64_t)n + i];
    z_w = xyz[2 * (int64_t)n + i];
    const Frustum f = frustum_cull(x_w, y_w, z_w, p);
    if (f.visible) {
#pragma unroll
      for (int k = 0; k < SH_WORDS; ++k) cp_async4(&s_sh[k][threadIdx.x], &sh[(int64_t)k * n + i]);
      float cov6[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cov6[k] = cov[(int64_t)k * n + i];
      s = shape_math(x_w, y_w, z_w, f, cov6, opacity[i], p);
    }
  }

  // row-major slot walk: rank j -> (j % w_t, j / w_t) of the rect
  uint32_t mask = 0u;
  if (s.visible) {
    const Reach reach = reach_of(s);
    for (int j = 0; j < p.slots; ++j) {
      if (j >= s.n_rect) break;
      const int dy = j / s.w_t;
      const int tx = s.tx0 + (j - dy * s.w_t);
      const int ty = s.ty0 + dy;
      if (reach.reaches(tx, ty, p.ts_x, p.ts_y)) mask |= 1u << j;
    }
  }
  const bool clamped = s.visible && s.n_rect > p.slots;
  const int count = __popc(mask) | ((clamped ? 1 : 0) << CLAMP_SHIFT) |
                    ((s.visible ? 1 : 0) << VIS_SHIFT);
  int excl, total;
  Scan(scan).ExclusiveSum(count, excl, total);
  if (threadIdx.x == 0) {
    const int n_inst = total & ((1 << CLAMP_SHIFT) - 1);
    const int n_clamped = (total >> CLAMP_SHIFT) & FIELD_MASK;
    const int n_visible = total >> VIS_SHIFT;
    s_base[0] = n_inst > 0 ? atomicAdd(&stats[0], n_inst) : 0;
    s_base[1] = n_clamped > 0 ? atomicAdd(&stats[2], n_clamped) : 0;
    if (n_visible > 0) atomicAdd(&stats[1], n_visible);
  }
  __syncthreads();
  cp_async_wait_all();  // this thread's SH words (it reads no other thread's)
  if (mask == 0u && !clamped) return;

  uint32_t w[4];
  pack_splat(s, x_w, y_w, z_w, &s_sh[0][threadIdx.x], FRONT_BLOCK, p, w);
  int pos = s_base[0] + (excl & ((1 << CLAMP_SHIFT) - 1));
  for (int j = 0; mask != 0u; ++j) {
    if (!(mask & (1u << j))) continue;
    mask &= ~(1u << j);
    if (pos < capacity) {
      const int dy = j / s.w_t;
      const uint32_t tile = (uint32_t)((s.ty0 + dy) * p.tx_tiles + s.tx0 + (j - dy * s.w_t));
      keys[pos] = (tile << p.depth_bits) | s.depth_q;
#pragma unroll
      for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + pos] = w[k];
    }
    ++pos;
  }

  // clamped-splat rows (rect4, w0..w3, depth_q) for the overflow walk
  const int cpos = s_base[1] + ((excl >> CLAMP_SHIFT) & FIELD_MASK);
  if (clamped && cpos < capacity_c) {
    cid[cpos] = (uint32_t)(s.tx0 & 0xFF) | ((uint32_t)(s.ty0 & 0xFF) << 8) |
                ((uint32_t)(s.tx1 & 0xFF) << 16) | ((uint32_t)(s.ty1 & 0xFF) << 24);
#pragma unroll
    for (int k = 0; k < 4; ++k) cid[(int64_t)(1 + k) * capacity_c + cpos] = w[k];
    cid[(int64_t)5 * capacity_c + cpos] = s.depth_q;
  }
}

}  // namespace ws

extern "C" {

const char* ws_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cfg: width, height, tile_w, tile_h, tx_tiles, ty_tiles, depth_bits, slots,
//      compressed (0 / 1)
// fcfg: alpha_threshold, f32(1/alpha_threshold) (0 when off), margin,
//       scale_x, scale_y
int ws_frontend(const float* xyz, const float* cov, const float* opacity, const uint32_t* sh,
                int n, const float* scal_host, const int* cfg, const float* fcfg,
                uint32_t* keys, uint32_t* words, int capacity, uint32_t* cid,
                int capacity_c, int* stats, void* stream) {
  ws::FrameParams p;
  ws::frame_params_from_block(scal_host, p);
  p.width = cfg[0];
  p.height = cfg[1];
  p.ts_x = cfg[2];
  p.ts_y = cfg[3];
  p.tx_tiles = cfg[4];
  p.ty_tiles = cfg[5];
  p.depth_bits = cfg[6];
  p.slots = cfg[7];
  p.compressed = cfg[8];
  p.thr = fcfg[0];
  p.inv_thr = fcfg[1];
  p.cq = ws::CenterQuant{fcfg[2], fcfg[3], fcfg[4]};
  if (n > 0) {
    const int grid = (n + ws::FRONT_BLOCK - 1) / ws::FRONT_BLOCK;
    ws::frontend_kernel<<<grid, ws::FRONT_BLOCK, 0, (cudaStream_t)stream>>>(
        xyz, cov, opacity, sh, n, p, keys, words, capacity, cid, capacity_c, stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
