// Fused frame frontend: per-splat preprocess + record packing + row-major
// slot emission + clamped-splat capture, in one pass over the cloud.
//
// Replaces websplat_tpu/ops/frontend_pallas.py:_make_kernel (called by
// fused_frontend), on the branch the main path takes (overflow on: pure
// row-major walk over ranks [0, slots), frontend_pallas.py:348).
//
// What bounds it on the card: it reads 136 bytes per splat (34 f32/u32
// attribute rows) and writes 20 bytes per emitted instance plus 24 per
// clamped splat -- memory traffic of ~0.2 GB per frame at 1.24M splats --
// and runs ~400 f32 operations per splat (EWA, eigen, 48 SH terms, record
// codecs, up to `slots` reach tests), with IEEE divisions and square roots
// because the build forbids fast math.  Its design: one thread per splat, so
// the 34 attribute rows are read coalesced straight from the column-major
// cloud (no interleaved relayout, which the TPU needed to cut DMA streams);
// the per-thread slot bitmask is counted, one block scan gives each thread
// its offset, and ONE atomicAdd per block reserves the block's run of the
// exact-prefix output (stream.cuh) -- the TPU's sequential SMEM cursor and
// ordered-overlap DMA protocol have no counterpart here.
#include <cstdint>

#include "core_math.cuh"
#include "stream.cuh"

namespace ws {

constexpr int FRONT_BLOCK = 256;

// stats: [0] instances emitted (may exceed capacity), [1] visible splats,
// [2] clamped splats (visible, n_rect > slots; may exceed capacity_c)
__global__ void __launch_bounds__(FRONT_BLOCK)
    frontend_kernel(const float* __restrict__ xyz, const float* __restrict__ cov,
                    const float* __restrict__ opacity, const uint32_t* __restrict__ sh, int n,
                    FrameParams p, uint32_t* __restrict__ keys, uint32_t* __restrict__ words,
                    int capacity, uint32_t* __restrict__ cid, int capacity_c,
                    int* __restrict__ stats) {
  __shared__ BlockAppend<FRONT_BLOCK> append;
  const int i = blockIdx.x * FRONT_BLOCK + threadIdx.x;
  const bool active = i < n;

  Splat s;
  s.visible = false;
  if (active) {
    float cov6[6];
    uint32_t shw[24];
#pragma unroll
    for (int k = 0; k < 6; ++k) cov6[k] = cov[(int64_t)k * n + i];
#pragma unroll
    for (int k = 0; k < 24; ++k) shw[k] = sh[(int64_t)k * n + i];
    s = core_math(xyz[i], xyz[(int64_t)n + i], xyz[2 * (int64_t)n + i], cov6, opacity[i], shw,
                  p);
  }

  // row-major slot walk: rank j -> (j % w_t, j / w_t) of the rect
  uint32_t mask = 0u;
  if (s.visible) {
    for (int j = 0; j < p.slots; ++j) {
      if (j >= s.n_rect) break;
      const int dy = j / s.w_t;
      const int tx = s.tx0 + (j - dy * s.w_t);
      const int ty = s.ty0 + dy;
      if (s.reach.reaches(tx, ty, p.ts_x, p.ts_y)) mask |= 1u << j;
    }
  }
  int pos = append.reserve(__popc(mask), &stats[0]);
  for (int j = 0; mask != 0u; ++j) {
    if (!(mask & (1u << j))) continue;
    mask &= ~(1u << j);
    if (pos < capacity) {
      const int dy = j / s.w_t;
      const uint32_t tile = (uint32_t)((s.ty0 + dy) * p.tx_tiles + s.tx0 + (j - dy * s.w_t));
      keys[pos] = (tile << p.depth_bits) | s.depth_q;
#pragma unroll
      for (int k = 0; k < 4; ++k) words[(int64_t)k * capacity + pos] = s.w[k];
    }
    ++pos;
  }

  // clamped-splat rows (rect4, w0..w3, depth_q) for the overflow walk
  const bool clamped = s.visible && s.n_rect > p.slots;
  const int cpos = append.reserve(clamped ? 1 : 0, &stats[2]);
  if (clamped && cpos < capacity_c) {
    cid[cpos] = (uint32_t)(s.tx0 & 0xFF) | ((uint32_t)(s.ty0 & 0xFF) << 8) |
                ((uint32_t)(s.tx1 & 0xFF) << 16) | ((uint32_t)(s.ty1 & 0xFF) << 24);
#pragma unroll
    for (int k = 0; k < 4; ++k) cid[(int64_t)(1 + k) * capacity_c + cpos] = s.w[k];
    cid[(int64_t)5 * capacity_c + cpos] = s.depth_q;
  }
  block_count(s.visible, &stats[1]);
}

}  // namespace ws

extern "C" {

const char* ws_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cfg: width, height, tile_w, tile_h, tx_tiles, ty_tiles, depth_bits, slots
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
