// Fused frame frontend: per-splat preprocess + record packing + slot
// emission + clamped-splat capture, in one pass over the cloud.
//
// Replaces websplat_tpu/ops/frontend_pallas.py:_make_kernel (called by
// fused_frontend), on both of its walks (frontend_pallas.py:348):
//  - overflow on (the main path): the pure row-major walk over ranks
//    [0, slots), and the clamped splats' rows for the overflow walk;
//  - overflow off (p.center_out, kernel C-o): splats whose rect fits the
//    budget walk it row-major; a clamped splat (n_rect > slots) walks
//    `slots` center-out candidates instead, the offsets SPIRAL_*[shape][j]
//    from its centre tile (preprocess.py:430-503), and no rows are written.
// p.compressed selects the compressed eigen clamp (core_math.cuh:
// shape_math).  Both fields are uniform over a launch; the walk and the
// slot count pick one of four instantiations of frontend_kernel, so the
// main path's code is the row-major, narrow one alone.
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
// The walk keeps each splat's reached slots as a bit mask: 32 bits and a
// 32-bit scan word up to 16 slots (Walk<false>); 64 bits and a 64-bit scan
// word above (Walk<true>), where ranks >= 64 of the row-major walk (overflow
// on with more than 64 slots) are tested again in the write loop.
#include <cstdint>

#include <cub/block/block_scan.cuh>

#include "core_math.cuh"
#include "cp_async.cuh"

namespace ws {

constexpr int FRONT_BLOCK = 256;
constexpr int SH_WORDS = 24;
constexpr int NARROW_SLOTS = 16;
constexpr int MAX_SLOT_SEQ = 64;

// center-out candidate offsets (ops/preprocess.py:SPIRAL, built as
// preprocess.py:438-450 builds them): [shape][j] for the square, wide
// (w_t >= 2 h_t) and tall (h_t >= 2 w_t) rect classes
__constant__ signed char SPIRAL_DX[3][MAX_SLOT_SEQ] = {
    {0, 0, -1, 1, 0, -1, 1, -1, 1, 0, -2, 2, 0, -1, 1, -2, 2, -2, 2, -1, 1, -2, 2, -2, 2, 0, -3, 3, 0, -1, 1, -3, 3, -3, 3, -1, 1, -2, 2, -3, 3, -3, 3, -2, 2, 0, -4, 4, 0, -1, 1, -4, 4, -4, 4, -1, 1, -3, 3, -3, 3, -2, 2, -4},
    {0, -1, 1, -2, 2, -3, 3, 0, 0, -4, 4, -1, 1, -1, 1, -2, 2, -2, 2, -3, 3, -3, 3, -5, 5, -4, 4, -4, 4, -6, 6, -5, 5, -5, 5, -7, 7, -6, 6, -6, 6, 0, 0, -1, 1, -1, 1, -7, 7, -7, 7, -2, 2, -2, 2, -3, 3, -3, 3, -4, 4, -4, 4, -5},
    {0, 0, 0, 0, 0, 0, 0, -1, 1, 0, 0, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, -2, 2, -2, -2, 2, 2, -1, -1, 1, 1, -2, -2, 2, 2, -2, -2, 2, 2, -2, -2, 2, 2, -2}};
__constant__ signed char SPIRAL_DY[3][MAX_SLOT_SEQ] = {
    {0, -1, 0, 0, 1, -1, -1, 1, 1, -2, 0, 0, 2, -2, -2, -1, -1, 1, 1, 2, 2, -2, -2, 2, 2, -3, 0, 0, 3, -3, -3, -1, -1, 1, 1, 3, 3, -3, -3, -2, -2, 2, 2, 3, 3, -4, 0, 0, 4, -4, -4, -1, -1, 1, 1, 4, 4, -3, -3, 3, 3, -4, -4, -2},
    {0, 0, 0, 0, 0, 0, 0, -1, 1, 0, 0, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, 0, 0, -1, -1, 1, 1, -2, 2, -2, -2, 2, 2, -1, -1, 1, 1, -2, -2, 2, 2, -2, -2, 2, 2, -2, -2, 2, 2, -2},
    {0, -1, 1, -2, 2, -3, 3, 0, 0, -4, 4, -1, 1, -1, 1, -2, 2, -2, 2, -3, 3, -3, 3, -5, 5, -4, 4, -4, 4, -6, 6, -5, 5, -5, 5, -7, 7, -6, 6, -6, 6, 0, 0, -1, 1, -1, 1, -7, 7, -7, 7, -2, 2, -2, 2, -3, 3, -3, 3, -4, 4, -4, 4, -5}};

// The slot mask and the packed per-thread count of a walk: instances from
// bit 0, clamped rows from CLAMP_SHIFT, visible splats from VIS_SHIFT; each
// field holds its block sum (at most slots x 256, 256 and 256), so the block
// sums never carry across fields.
template <bool WIDE>
struct Walk;
template <>
struct Walk<false> {  // slots <= NARROW_SLOTS: instances in bits 0-12
  using Mask = uint32_t;
  using Count = int;
  static constexpr int MASK_BITS = 32, CLAMP_SHIFT = 13, VIS_SHIFT = 22;
  // 5 CTAs per SM: 48 registers and no spills (ptxas); a cap at 6 spills
  // and ran slower on the H100
  static constexpr int MIN_BLOCKS = 5;
  __device__ static int popc(Mask m) { return __popc(m); }
};
template <>
struct Walk<true> {  // any slot count: instances in bits 0-31
  using Mask = unsigned long long;
  using Count = unsigned long long;
  static constexpr int MASK_BITS = 64, CLAMP_SHIFT = 32, VIS_SHIFT = 48;
  static constexpr int MIN_BLOCKS = 4;
  __device__ static int popc(Mask m) { return __popcll(m); }
};

// Candidate j of a splat's slot walk: its tile (tx, ty), and whether it is
// a candidate (before the reach test).  Row-major: rank j of the rect;
// center-out, for a clamped splat: SPIRAL offset j from the centre tile,
// a candidate inside the rect (preprocess.py:475-498).
template <bool CENTER_OUT>
__device__ __forceinline__ bool slot_tile(const Shape& s, int j, int slots, int& tx, int& ty) {
  if (CENTER_OUT && s.n_rect > slots) {
    const int shape = s.w_t >= 2 * s.h_t ? 1 : (s.h_t >= 2 * s.w_t ? 2 : 0);
    tx = s.ct_x + SPIRAL_DX[shape][j];
    ty = s.ct_y + SPIRAL_DY[shape][j];
    return tx >= s.tx0 && tx <= s.tx1 && ty >= s.ty0 && ty <= s.ty1;
  }
  const int dy = j / s.w_t;
  tx = s.tx0 + (j - dy * s.w_t);
  ty = s.ty0 + dy;
  return j < s.n_rect;
}

// stats: [0] instances emitted (may exceed capacity), [1] visible splats,
// [2] clamped splats (visible, n_rect > slots; may exceed capacity_c)
template <bool WIDE, bool CENTER_OUT>
__global__ void __launch_bounds__(FRONT_BLOCK, Walk<WIDE>::MIN_BLOCKS)
    frontend_kernel(const float* __restrict__ xyz, const float* __restrict__ cov,
                    const float* __restrict__ opacity, const uint32_t* __restrict__ sh, int n,
                    FrameParams p, uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                    int capacity, uint32_t* __restrict__ cid, int capacity_c,
                    int* __restrict__ stats) {
  using W = Walk<WIDE>;
  using Mask = typename W::Mask;
  using Count = typename W::Count;
  using Scan = cub::BlockScan<Count, FRONT_BLOCK>;
  constexpr Count INST_MASK = ((Count)1 << W::CLAMP_SHIFT) - 1;
  constexpr Count FIELD_MASK = ((Count)1 << (W::VIS_SHIFT - W::CLAMP_SHIFT)) - 1;
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

  // the slot walk: the reached candidates among j < min(slots, MASK_BITS)
  // as mask bits; ranks past MASK_BITS (row-major only) are counted here
  // and tested again when written
  const bool clamped = s.visible && s.n_rect > p.slots;
  const bool spiral = CENTER_OUT && clamped;
  Mask mask = 0;
  int n_inst = 0;
  if (s.visible) {
    const Reach reach = reach_of(s);
    const int j_end = spiral ? p.slots : min(p.slots, s.n_rect);
    for (int j = 0; j < j_end; ++j) {
      int tx, ty;
      const bool cand = slot_tile<CENTER_OUT>(s, j, p.slots, tx, ty);
      if (cand && reach.reaches(tx, ty, p.ts_x, p.ts_y)) {
        if (!WIDE || j < W::MASK_BITS) {
          mask |= (Mask)1 << j;
        } else {
          ++n_inst;
        }
      }
    }
    n_inst += W::popc(mask);
  }
  const Count count = (Count)n_inst | ((Count)(clamped ? 1 : 0) << W::CLAMP_SHIFT) |
                      ((Count)(s.visible ? 1 : 0) << W::VIS_SHIFT);
  Count excl, total;
  Scan(scan).ExclusiveSum(count, excl, total);
  if (threadIdx.x == 0) {
    const int b_inst = (int)(total & INST_MASK);
    const int b_clamped = (int)((total >> W::CLAMP_SHIFT) & FIELD_MASK);
    const int b_visible = (int)(total >> W::VIS_SHIFT);
    s_base[0] = b_inst > 0 ? atomicAdd(&stats[0], b_inst) : 0;
    s_base[1] = b_clamped > 0 ? atomicAdd(&stats[2], b_clamped) : 0;
    if (b_visible > 0) atomicAdd(&stats[1], b_visible);
  }
  __syncthreads();
  cp_async_wait_all();  // this thread's SH words (it reads no other thread's)
  if (n_inst == 0 && !(clamped && !CENTER_OUT)) return;

  uint32_t w[4];
  pack_splat(s, x_w, y_w, z_w, &s_sh[0][threadIdx.x], FRONT_BLOCK, p, w);
  int pos = s_base[0] + (int)(excl & INST_MASK);
  for (int j = 0; mask != 0; ++j) {
    if (!(mask & ((Mask)1 << j))) continue;
    mask &= ~((Mask)1 << j);
    if (pos < capacity) {
      int tx, ty;
      slot_tile<CENTER_OUT>(s, j, p.slots, tx, ty);
      keys[pos] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | s.depth_q;
#pragma unroll
      for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + pos] = w[k];
    }
    ++pos;
  }
  if (WIDE && !spiral) {
    const Reach reach = reach_of(s);
    for (int j = W::MASK_BITS; j < min(p.slots, s.n_rect); ++j) {
      int tx, ty;
      slot_tile<false>(s, j, p.slots, tx, ty);
      if (!reach.reaches(tx, ty, p.ts_x, p.ts_y)) continue;
      if (pos < capacity) {
        keys[pos] = ((uint32_t)(ty * p.tx_tiles + tx) << p.depth_bits) | s.depth_q;
#pragma unroll
        for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + pos] = w[k];
      }
      ++pos;
    }
  }

  // clamped-splat rows (rect4, w0..w3, depth_q) for the overflow walk
  if (CENTER_OUT) return;
  const int cpos = s_base[1] + (int)((excl >> W::CLAMP_SHIFT) & FIELD_MASK);
  if (clamped && cpos < capacity_c) {
    cid[cpos] = (uint32_t)(s.tx0 & 0xFF) | ((uint32_t)(s.ty0 & 0xFF) << 8) |
                ((uint32_t)(s.tx1 & 0xFF) << 16) | ((uint32_t)(s.ty1 & 0xFF) << 24);
#pragma unroll
    for (int k = 0; k < 4; ++k) cid[(int64_t)(1 + k) * capacity_c + cpos] = w[k];
    cid[(int64_t)5 * capacity_c + cpos] = s.depth_q;
  }
}

template <bool WIDE, bool CENTER_OUT>
void launch_frontend(int grid, cudaStream_t stream, const float* xyz, const float* cov,
                     const float* opacity, const uint32_t* sh, int n, const FrameParams& p,
                     uint32_t* keys, uint32_t* words, int capacity, uint32_t* cid,
                     int capacity_c, int* stats) {
  frontend_kernel<WIDE, CENTER_OUT><<<grid, FRONT_BLOCK, 0, stream>>>(
      xyz, cov, opacity, sh, n, p, keys, words, capacity, cid, capacity_c, stats);
}

}  // namespace ws

extern "C" {

const char* ws_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cfg: width, height, tile_w, tile_h, tx_tiles, ty_tiles, depth_bits, slots,
//      compressed (0 / 1), center_out (0 / 1: overflow off, slots <= 64)
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
  const bool wide = p.slots > ws::NARROW_SLOTS, center_out = cfg[9] != 0;
  if (center_out && p.slots > ws::MAX_SLOT_SEQ) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + ws::FRONT_BLOCK - 1) / ws::FRONT_BLOCK;
    auto launch = wide ? (center_out ? ws::launch_frontend<true, true>
                                     : ws::launch_frontend<true, false>)
                       : (center_out ? ws::launch_frontend<false, true>
                                     : ws::launch_frontend<false, false>);
    launch(grid, (cudaStream_t)stream, xyz, cov, opacity, sh, n, p, keys, words, capacity, cid,
           capacity_c, stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
