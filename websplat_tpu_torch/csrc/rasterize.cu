// Tile rasterizer: front-to-back blending of each tile's depth-sorted span.
//
// Replaces websplat_tpu/ops/rasterize_pallas.py:_make_kernel on its
// composite="scan" / qform="monomial" branch (called by rasterize_pallas),
// including the wrapper's tile assembly and background composite
// (rasterize_pallas.py:1112-1116): the kernel writes the (H, W, 3) image.
//
// What bounds it on the card: arithmetic.  Every (instance, pixel) pair costs
// ~15 f32 operations and one expf; at the bench scene (~1.8M instances,
// 1024-pixel tiles) that is ~1.8G pairs before early termination, against
// only 16 bytes read per instance.  Its design:
//  - one CTA per tile and 256 threads with 4 pixels each;
//  - records are staged through shared memory in batches of 256: each
//    thread loads and decodes ONE record (u16 center, e5m12/rho16 conic,
//    op12, rgb9e5 -- the codecs of packing.cuh) into f32 arrays, so decode
//    work is per instance, not per pixel;
//  - the quadratic form is the DIRECT one, a = ha dx^2 + hb dx dy + hc dy^2
//    with per-pixel dx, dy (rasterize_xla.py:48-57).  The TPU kernel's
//    tile-local monomial expansion bounded f32 cancellation on its VPU; with
//    per-pixel offsets the direct form is already well conditioned;
//  - a pixel stops after the splat that takes its transmittance to <= eps,
//    and the CTA stops when all its pixels have (__syncthreads_count after
//    each batch).  The TPU stopped whole tiles at chunk granularity, so the
//    two differ by < eps * max(rgb) per channel.
// The blend arithmetic (alpha = min(0.99, exp(-a) * op) for a < 2*CUTOFF
// and op > 0; w = alpha*T; C += w*c; T *= 1 - alpha) is the plain version's
// (ops/rasterize.py:rasterize_torch), operation for operation.
#include <cstdint>

#include "packing.cuh"

namespace ws {

constexpr int RASTER_THREADS = 256;
constexpr int RASTER_BATCH = 256;
constexpr int MAX_PIX_PER_THREAD = 4;  // tiles of up to 1024 pixels

struct RasterParams {
  int width, height, tile_w, tile_h, tx_tiles;
  float eps;
  float bg[3];
  CenterQuant cq;
};

__global__ void __launch_bounds__(RASTER_THREADS)
    rasterize_kernel(const uint32_t* __restrict__ words, int64_t stride,
                     const int* __restrict__ ranges, RasterParams p, float* __restrict__ out) {
  __shared__ float s_px[RASTER_BATCH], s_py[RASTER_BATCH], s_ha[RASTER_BATCH],
      s_hb[RASTER_BATCH], s_hc[RASTER_BATCH], s_op[RASTER_BATCH], s_r[RASTER_BATCH],
      s_g[RASTER_BATCH], s_b[RASTER_BATCH];

  const int t = blockIdx.x;
  const int start = ranges[t];
  const int end = ranges[t + 1];
  const int tile_x = (t % p.tx_tiles) * p.tile_w;
  const int tile_y = (t / p.tx_tiles) * p.tile_h;
  const int n_pix = p.tile_w * p.tile_h;

  float pix_x[MAX_PIX_PER_THREAD], pix_y[MAX_PIX_PER_THREAD];
  float T[MAX_PIX_PER_THREAD], cr[MAX_PIX_PER_THREAD], cg[MAX_PIX_PER_THREAD],
      cb[MAX_PIX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    const int q = threadIdx.x + k * RASTER_THREADS;
    pix_x[k] = (float)(tile_x + q % p.tile_w) + 0.5f;
    pix_y[k] = (float)(tile_y + q / p.tile_w) + 0.5f;
    T[k] = q < n_pix ? 1.0f : 0.0f;  // pixels past the tile never blend
    cr[k] = cg[k] = cb[k] = 0.0f;
  }

  for (int b0 = start; b0 < end; b0 += RASTER_BATCH) {
    const int idx = b0 + threadIdx.x;
    if (idx < end) {
      const Record r = unpack_record(words[idx], words[stride + idx], words[2 * stride + idx],
                                     words[3 * stride + idx], p.cq);
      s_px[threadIdx.x] = r.px;
      s_py[threadIdx.x] = r.py;
      s_ha[threadIdx.x] = r.ha;
      s_hb[threadIdx.x] = r.hb;
      s_hc[threadIdx.x] = r.hc;
      s_op[threadIdx.x] = r.op;
      s_r[threadIdx.x] = r.r;
      s_g[threadIdx.x] = r.g;
      s_b[threadIdx.x] = r.b;
    }
    __syncthreads();
    const int nb = min(RASTER_BATCH, end - b0);
    for (int s = 0; s < nb; ++s) {
      const float px = s_px[s], py = s_py[s], ha = s_ha[s], hb = s_hb[s], hc = s_hc[s],
                  op = s_op[s];
#pragma unroll
      for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
        if (!(T[k] > p.eps)) continue;
        const float dx = pix_x[k] - px;
        const float dy = pix_y[k] - py;
        const float a = ha * dx * dx + hb * dx * dy + hc * dy * dy;
        if (!(a < CUTOFF2 && op > 0.0f)) continue;
        const float alpha = fminf(0.99f, expf(-a) * op);
        const float w = alpha * T[k];
        cr[k] = cr[k] + w * s_r[s];
        cg[k] = cg[k] + w * s_g[s];
        cb[k] = cb[k] + w * s_b[s];
        T[k] = T[k] * (1.0f - alpha);
      }
    }
    bool live = false;
#pragma unroll
    for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) live = live || (T[k] > p.eps);
    // also the barrier that frees the shared arrays for the next batch
    if (__syncthreads_count(live) == 0) break;
  }

#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    const int q = threadIdx.x + k * RASTER_THREADS;
    const int x = tile_x + q % p.tile_w, y = tile_y + q / p.tile_w;
    if (q < n_pix && x < p.width && y < p.height) {
      float* o = out + ((int64_t)y * p.width + x) * 3;
      o[0] = cr[k] + T[k] * p.bg[0];
      o[1] = cg[k] + T[k] * p.bg[1];
      o[2] = cb[k] + T[k] * p.bg[2];
    }
  }
}

}  // namespace ws

extern "C" {

// words: 4 rows of `stride` u32 (sorted records); ranges: num_tiles + 1
// ints; bg_host: 3 floats on the host; out: (height, width, 3) f32
int ws_rasterize(const uint32_t* words, int64_t stride, const int* ranges, const float* bg_host,
                 float* out, int width, int height, int tile_w, int tile_h, int tx_tiles,
                 float eps, float margin, float scale_x, float scale_y, void* stream) {
  if (tile_w * tile_h > ws::RASTER_THREADS * ws::MAX_PIX_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  ws::RasterParams p{width, height, tile_w, tile_h, tx_tiles, eps,
                     {bg_host[0], bg_host[1], bg_host[2]}, ws::CenterQuant{margin, scale_x, scale_y}};
  const int ty_tiles = (height + tile_h - 1) / tile_h;
  const int num_tiles = tx_tiles * ty_tiles;
  if (num_tiles > 0) {
    ws::rasterize_kernel<<<num_tiles, ws::RASTER_THREADS, 0, (cudaStream_t)stream>>>(
        words, stride, ranges, p, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
