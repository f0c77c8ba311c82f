// Tile rasterizer: front-to-back blending of each tile's depth-sorted span.
//
// Replaces websplat_tpu/ops/rasterize_pallas.py:_make_kernel on its
// composite="scan" and composite="tree" branches, with either qform (called
// by rasterize_pallas), including the wrapper's tile assembly and
// background composite (rasterize_pallas.py:1112-1116): the kernel writes
// the (H, W, 3) image.  rasterize_kernel blends splat by splat (scan);
// rasterize_tree_kernel composites 8-splat groups (tree, below).
//
// What bounds it on the card: f32 arithmetic.  A blended (instance, pixel)
// pair costs 21 f32 operations and one expf, against 16 bytes read per
// instance; but most pairs of a tile's span change nothing -- a splat covers
// a few pixels of its 32x32 tile -- and a pair must be evaluated to know it.
// So the design cuts the pairs it evaluates, without divergence:
//  - one CTA per tile, 8 warps; each warp owns a compact rectangle (16 x 8
//    on 32 x 32 tiles, ops/rasterize.py:warp_layout) cut into four 8 x 4
//    sub-blocks, and lane l holds pixel l of each sub-block; pixels outside
//    the image start dead (T = 0) and are never written;
//  - records are staged through shared memory in batches of 256: cp.async
//    copies the next batch's 4 raw words while the CTA blends the current
//    one; each thread decodes ONE record (the codecs of packing.cuh), its
//    conservative pixel box (record_box) and a 32-bit mask of the
//    sub-blocks its cutoff ellipse meets (record_hits: the box's, cut per
//    band of warp-rectangle rows to the ellipse's x-extent there), so
//    decode work is per instance (it adds to the kernel's time in full:
//    the time follows the instructions issued, PERF.md §6);
//  - each warp walks only the records that meet one of its live
//    sub-blocks, in span order (a ballot over 32 masks at a time), and
//    evaluates only those sub-blocks: warp-uniform branches;
//  - the quadratic form is the DIRECT one, a = ha dx^2 + hb dx dy + hc dy^2
//    with per-pixel dx, dy (rasterize_xla.py:48-57), for both qform values:
//    the TPU's tile-local monomials bounded its VPU's f32 cancellation and
//    have no use here (qform="direct" is this form, rasterize_pallas.py:
//    790-818);
//  - a pixel stops after the splat (scan) or the group (tree) that takes
//    its transmittance to <= eps, a warp when all its pixels have
//    (__any_sync), a sub-block at the next batch, and the CTA when all its
//    warps have (__syncthreads_count after each batch).  The TPU stopped
//    whole tiles at chunk granularity, so the two differ by < eps * max(rgb).
// Every written pixel blends the same pairs in the same order with the same
// f32 operations as the plain version (ops/rasterize.py:rasterize_torch):
// alpha = min(0.99, exp(-a) * op) for a < 2*CUTOFF and op > 0.  Scan:
// w = alpha*T; C += w*c; T *= 1 - alpha.  Tree (rasterize_pallas.py:888-914):
// a group is the 8 absolute stream positions [8g, 8g + 8); each pair is
// (alpha*c, 1 - alpha), x o y = (c_x + t_x c_y, t_x t_y) composites them as
// ((0 o 1) o (2 o 3)) o ((4 o 5) o (6 o 7)), and the pixel takes C += T*c_g,
// T *= t_g.  A skipped pair, and a position outside the tile's span, is one
// whose alpha is 0 there: the identity (0, 1), which composites exactly, so
// the tree walks the same records as the scan, a pixel evaluates only the
// positions of a group whose record meets its sub-block, and a group with
// one or two of them folds only those (fold_group).
#include <cstdint>

#include "cp_async.cuh"
#include "packing.cuh"

namespace ws {

constexpr int RASTER_THREADS = 256;
// scan: 4 CTAs per SM: 64 registers and 28 / 36 bytes of spill stores /
// loads per thread, none in the walk (ptxas); uncapped, the kernel fits 2 CTAs per SM
// and ran slower on the H100.  tree: 3 CTAs per SM (80 registers, no
// spill); at 4 (64 registers, 56 / 72 bytes of spill) it ran 1% slower on
// the H100 (PERF.md §6)
constexpr int RASTER_MIN_BLOCKS = 4;
constexpr int TREE_MIN_BLOCKS = 3;
constexpr int GROUP = 8;  // the tree composite's group (rasterize_pallas.py GROUP)
constexpr int RASTER_BATCH = 256;
constexpr int MAX_PIX_PER_THREAD = 4;  // tiles of up to 1024 pixels
static_assert(RASTER_BATCH <= RASTER_THREADS, "one thread stages and decodes each record");
constexpr int WARP_PIXELS = 32 * MAX_PIX_PER_THREAD;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// record_box constants: ops/rasterize.py BOX_* (the proof of the margin is
// there, beside splat_pixel_bounds, the plain mirror of record_box, and that
// of the band extents beside splat_subblock_mask, record_hits' mirror)
constexpr float BOX_GAMMA = 8.0f / 16777216.0f;  // 8 * 2^-24
constexpr float BOX_MAX_GR = 0.5f;
constexpr float BOX_PAD = 1.0f / 65536.0f;  // 2^-16
constexpr float BOX_ABS = 1.0f / 1024.0f;   // 2^-10
constexpr float BOX_FAR = 1073741824.0f;    // 2^30
constexpr float F32_MIN_NORMAL = 1.17549435e-38f;  // 2^-126

struct RasterParams {
  int width, height, tile_w, tile_h, tx_tiles;
  int warp_w;  // width of each warp's pixel rectangle; 0: row-major runs of 128
  float eps;
  const float* bg;  // 3 floats in device memory
  CenterQuant cq;
};

// The cutoff ellipse that record_box bounds, as record_hits reads it: a
// pixel row at offset dy from the centre meets it, if at all, within
// x - px in [-s dy - w, -s dy + w], s = hb / (2 ha), kx = det / ha^2,
// w = sqrt(kx (ey^2 - dy^2)); the right edge -s dy + w peaks at a dy in
// [plo, phi], the left edge bottoms out at a dy in [-phi, -plo].  ok: the
// box is the ellipse's (no fallback) and these hold (ops/rasterize.py,
// above splat_subblock_mask).
struct Ellipse {
  float s, kx, eb2, plo, phi;
  bool ok;
};

// v, a pixel index in f32, as a tile-local index clamped to [-1, size]
__device__ __forceinline__ int tile_local(float v, int origin, int size) {
  v = fminf(fmaxf(v, -BOX_FAR), BOX_FAR) - (float)origin;
  return (int)fminf(fmaxf(v, -1.0f), (float)size);
}

// A record's pixel box in tile-local pixel indices (x_lo, x_hi, y_lo, y_hi),
// clamped to [-1, tile size]: every pixel where the blend's f32 quadratic
// form is < 2*CUTOFF and op > 0 lies inside it.  The determinant, which
// cancels for needles, in f64, the rest in f32; the whole tile where
// det <= 0, a value is not finite or the conic is a needle, and empty where
// op <= 0.  Fills e for record_hits.
__device__ __forceinline__ int4 record_box(const Record& r, int tile_x, int tile_y, int tile_w,
                                           int tile_h, Ellipse& e) {
  e.ok = false;
  if (!(r.op > 0.0f)) return make_int4(tile_w, -1, tile_h, -1);
  const double det64 = (double)r.ha * (double)r.hc - 0.25 * (double)r.hb * (double)r.hb;
  const float det = (float)det64;
  const float rs = r.hb / (2.0f * sqrtf(r.ha * r.hc));  // rho, signed
  const float rho = fabsf(rs);
  const float r1 = 1.0f + rho;
  const float gr = BOX_GAMMA * r1 * r1 * r.ha * r.hc / det;
  const bool finite = isfinite(r.px) && isfinite(r.py) && isfinite(gr);
  if (!(det64 > 0.0 && det > 0.0f && finite && gr < BOX_MAX_GR))
    return make_int4(0, tile_w - 1, 0, tile_h - 1);
  const float kp = CUTOFF2 / (1.0f - gr);
  const float ex = sqrtf(kp * r.hc / det) * (1.0f + BOX_PAD) + BOX_ABS;
  const float eyr = sqrtf(kp * r.ha / det);
  const float ey = eyr * (1.0f + BOX_PAD) + BOX_ABS;
  if (det >= F32_MIN_NORMAL && ey < BOX_FAR) {
    e.ok = true;
    const float iha = 1.0f / r.ha;
    e.s = 0.5f * r.hb * iha;
    e.kx = det * iha * iha;
    e.eb2 = ey * ey;
    const float m = BOX_PAD * (ey + 1.0f);
    const float hi = rho * ey + m, lo = rho * (eyr * (1.0f - gr)) - m;
    e.plo = r.hb >= 0.0f ? -hi : lo;
    e.phi = r.hb >= 0.0f ? -lo : hi;
  }
  return make_int4(tile_local(ceilf(r.px - ex - 0.5f), tile_x, tile_w),
                   tile_local(floorf(r.px + ex - 0.5f), tile_x, tile_w),
                   tile_local(ceilf(r.py - ey - 0.5f), tile_y, tile_h),
                   tile_local(floorf(r.py + ey - 0.5f), tile_y, tile_h));
}

// The ellipse's edges on the row at offset dy, as x offsets from px: an
// upper bound of the right edge (x) and a lower bound of the left (y)
__device__ __forceinline__ float2 edge_offsets(float dy, const Ellipse& e) {
  const float c = -e.s * dy;
  const float w = sqrtf(e.kx * fmaxf(e.eb2 - dy * dy, 0.0f));
  const float wp = w + (BOX_PAD * (fabsf(c) + w) + BOX_ABS);
  return make_float2(c + wp, c - wp);
}

// Thread-to-pixel map.  Warp w owns a rectangle of 128 pixels (warp_w wide,
// ops/rasterize.py:warp_layout) cut into 4 sub-blocks of 32 pixels; lane l
// holds pixel l of each sub-block k, row-major in it.  Sub-blocks are 8 x 4
// on 16 x 8 rectangles (the 32 x 32 tile's layout).  With warp_w == 0, warp
// w owns the tile's row-major pixels [128 w, 128 w + 128) and sub-block k
// is the run [128 w + 32 k, 128 w + 32 k + 32).
struct PixelMap {
  int sb_w, sb_h, per_row;  // sub-block width and height, sub-blocks per rectangle row
};

__device__ __forceinline__ PixelMap pixel_map(const RasterParams& p) {
  if (p.warp_w == 0) return PixelMap{0, 0, 0};
  const int rh = WARP_PIXELS / p.warp_w;
  const int sb_w = max(min(p.warp_w, 8), 32 / rh);
  return PixelMap{sb_w, 32 / sb_w, p.warp_w / sb_w};
}

// log2 of the sub-blocks' width and height on grid layouts; -1 for runs
struct PixelShift {
  int col, row;
};

__device__ __forceinline__ PixelShift pixel_shift(const PixelMap& m) {
  if (m.sb_w == 0) return PixelShift{-1, -1};
  return PixelShift{__ffs(m.sb_w) - 1, __ffs(m.sb_h) - 1};
}

// tile-local pixel of lane l in sub-block k of warp w
__device__ __forceinline__ int2 pixel_of(int w, int k, int l, const PixelMap& m,
                                         const RasterParams& p) {
  if (m.sb_w == 0) {
    const int q = w * WARP_PIXELS + 32 * k + l;
    return make_int2(q % p.tile_w, q / p.tile_w);
  }
  const int gw = (p.tile_w + p.warp_w - 1) / p.warp_w;
  const int x0 = (w % gw) * p.warp_w + (k % m.per_row) * m.sb_w;
  const int y0 = (w / gw) * (WARP_PIXELS / p.warp_w) + (k / m.per_row) * m.sb_h;
  return make_int2(x0 + l % m.sb_w, y0 + l / m.sb_w);
}

// bounding box (x0, x1, y0, y1) of sub-block k of warp w
__device__ __forceinline__ int4 sub_block_box(int w, int k, const PixelMap& m,
                                              const RasterParams& p) {
  const int2 a = pixel_of(w, k, 0, m, p), b = pixel_of(w, k, 31, m, p);
  if (m.sb_w == 0 && a.y != b.y) return make_int4(0, p.tile_w - 1, a.y, b.y);
  return make_int4(min(a.x, b.x), max(a.x, b.x), a.y, b.y);
}

// Per-CTA tables of the sub-block mask: the bands (the distinct row spans of
// the warps' pixel rectangles, each with the mask of its sub-blocks) and,
// where the sub-blocks form a grid of sb_w x sb_h cells (warp_w > 0), the
// masks of the sub-blocks in grid columns (rows) <= c and >= c.  A loop
// over each band's sub-blocks on every layout ran A 4% slower on the H100
// (PERF.md §6, PR 25).
struct MaskTables {
  int4 band[32];  // (y0, y1, mask, -)
  // at [c + 1] for c in [-1, 32]: a box's clamped bounds shifted to cells
  uint32_t col_le[34], col_ge[34], row_le[34], row_ge[34];
  int n_bands;
};

// A record's 32-bit sub-block mask: the sub-blocks its box meets, and of
// those, where e.ok, the ones its cutoff ellipse meets.  Per band, on the
// band's rows inside the box: the ellipse's right edge is concave in dy,
// so where its peak lies past one end of the rows their largest x is at
// that end; likewise the left edge, convex; where the peak may lie among
// the rows, the box's bound stands.  A sub-block whose x-range misses the
// band's [x_lo, x_hi] holds no pixel that blends the record.
// (ops/rasterize.py:subblock_hits mirrors it; the margin argument is there.)
__device__ __forceinline__ uint32_t record_hits(const Record& r, const Ellipse& e, int4 box,
                                                int tile_x, int tile_y, int tile_w,
                                                const PixelShift& sh, const int4* s_sub,
                                                const MaskTables& mt) {
  uint32_t hits = 0u;
  // grid cells: the sub-blocks on the box's rows
  const uint32_t rows = sh.col >= 0 ? mt.row_le[(box.w >> sh.row) + 1] &
                                          mt.row_ge[(box.z >> sh.row) + 1]
                                    : 0u;
  for (int b = 0; b < mt.n_bands; ++b) {
    const int4 band = mt.band[b];
    const int ya = max(band.x, box.z), yb = min(band.y, box.w);
    if (ya > yb) continue;
    int xl = box.x, xh = box.y;
    if (e.ok) {
      const float dya = ((float)(tile_y + ya) + 0.5f) - r.py;
      const float dyb = ((float)(tile_y + yb) + 0.5f) - r.py;
      const bool rb = e.plo > dyb, ra = e.phi < dya, lb = -e.phi > dyb, la = -e.plo < dya;
      float2 va = make_float2(0.0f, 0.0f), vb = va;
      if (ra || la) va = edge_offsets(dya, e);
      if (rb || lb) vb = edge_offsets(dyb, e);
      // |v| < BOX_FAR: tile_local's clamp to BOX_FAR changes nothing here
      const float vr = rb ? vb.x : va.x, vl = lb ? vb.y : va.y;
      if ((rb || ra) && fabsf(vr) < BOX_FAR)
        xh = min(xh, (int)fmaxf(floorf(r.px + vr - 0.5f) - (float)tile_x, -1.0f));
      if ((lb || la) && fabsf(vl) < BOX_FAR)
        xl = max(xl, (int)fminf(ceilf(r.px + vl - 0.5f) - (float)tile_x, (float)tile_w));
    }
    if (sh.col >= 0) {  // grid cells: the columns [xl, xh] on the box's rows
      hits |= (uint32_t)band.z & rows & mt.col_le[(xh >> sh.col) + 1] &
              mt.col_ge[(xl >> sh.col) + 1];
    } else {
      for (uint32_t m = (uint32_t)band.z; m != 0u; m &= m - 1u) {
        const int j = __ffs(m) - 1;
        const int4 sb = s_sub[j];
        if (xh >= sb.x && xl <= sb.y && box.w >= sb.z && box.z <= sb.w) hits |= 1u << j;
      }
    }
  }
  return hits;
}

// the tree composite's over operator on (c.rgb, t) pairs
__device__ __forceinline__ float4 over(const float4 x, const float4 y) {
  return make_float4(x.x + x.w * y.x, x.y + x.w * y.y, x.z + x.w * y.z, x.w * y.w);
}

// The (alpha * rgb, 1 - alpha) pair of record s at pixel (cx, cy): the
// identity (0, 1) where the pixel is past the cutoff or op <= 0.  The
// cutoff is a select, not a branch, so a leaf is one straight run.
__device__ __forceinline__ float4 tree_leaf(int s, float cx, float cy, const float4* s_ra,
                                            const float4* s_rb, const float* s_rc) {
  const float4 ra = s_ra[s], rb = s_rb[s];  // (px, py, ha, hb), (hc, op, r, g)
  const float dx = cx - ra.x;
  const float dy = cy - ra.y;
  const float a = ra.z * dx * dx + ra.w * dx * dy + rb.x * dy * dy;
  const float alpha = fminf(0.99f, expf(-a) * rb.y);
  return a < CUTOFF2 && rb.y > 0.0f
             ? make_float4(alpha * rb.z, alpha * rb.w, alpha * s_rc[s], 1.0f - alpha)
             : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
}

// One group's tree composite at one pixel (cx, cy) over the positions in
// `occ` (bit j: record s0 + j meets the pixel's sub-block; warp-uniform),
// the others being the identity (0, 1) there (alpha is 0 in a sub-block
// the record's cutoff ellipse misses).  The fixed tree
// ((0 o 1) o (2 o 3)) o ((4 o 5) o (6 o 7)) with the absent positions left
// out is bit-equal to the tree over all 8,
// since x o (0, 1) = x and (0, 1) o y = y exactly for the pairs a record
// gives; op for op ops/rasterize.py:fold_present:
//  - one present position (10% of the bench view's folds) is its leaf,
//  - two (21%) are one over, whatever their positions,
//  - three or more fold all 8 positions, the absent ones as the identity:
//    7 overs.  Every form measured that folds only the present ones there
//    (an __ffs walk merged by position bits, closed forms for 3 or 4,
//    per-quad folds, pixel state in shared memory) ran slower on the H100
//    than the 8-position fold, 0.38-0.80 ms against 0.34 (PERF.md §6).
__device__ __forceinline__ float4 fold_group(uint32_t occ, int s0, float cx, float cy,
                                             const float4* s_ra, const float4* s_rb,
                                             const float* s_rc) {
  const uint32_t rest = occ & (occ - 1u);
  if ((rest & (rest - 1u)) == 0u) {  // one or two present: warp-uniform
    const float4 e = tree_leaf(s0 + __ffs(occ) - 1, cx, cy, s_ra, s_rb, s_rc);
    return rest == 0u ? e : over(e, tree_leaf(s0 + __ffs(rest) - 1, cx, cy, s_ra, s_rb, s_rc));
  }
  float4 pr, qd, hf;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    if ((occ >> j) & 1u) e = tree_leaf(s0 + j, cx, cy, s_ra, s_rb, s_rc);
    if (j % 2 == 0) pr = e; else pr = over(pr, e);
    if (j % 4 == 1) qd = pr; else if (j % 4 == 3) qd = over(qd, pr);
    if (j == 3) hf = qd; else if (j == 7) hf = over(hf, qd);
  }
  return hf;
}

// The tree composite over the four 8-record groups of a 32-record ballot
// (records c0 .. c0 + 31 of the batch, group-aligned): `mine` is lane l's
// mask of this warp's live sub-blocks that record c0 + l meets.  One
// ballot per sub-block k gives the records that meet k (warp-uniform);
// each pixel still live at a group's start folds the group (fold_group),
// then takes it.  Returns whether some pixel of the warp is still live.
__device__ __forceinline__ bool tree_groups(int c0, uint32_t mine, const float* cx,
                                            const float* cy, float* T, float* cr, float* cg,
                                            float* cb, const float4* s_ra, const float4* s_rb,
                                            const float* s_rc, float eps) {
  uint32_t occ[MAX_PIX_PER_THREAD], any = 0u;
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    occ[k] = __ballot_sync(FULL_MASK, (mine >> k) & 1u);
    any |= occ[k];
  }
  for (int g = 0; g < 32 / GROUP; ++g) {
    if (((any >> (GROUP * g)) & 0xFFu) == 0u) continue;  // warp-uniform
    bool live = false;
#pragma unroll
    for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
      const uint32_t o = (occ[k] >> (GROUP * g)) & 0xFFu;
      if (o != 0u && T[k] > eps) {
        const float4 hf = fold_group(o, c0 + GROUP * g, cx[k], cy[k], s_ra, s_rb, s_rc);
        cr[k] = cr[k] + T[k] * hf.x;
        cg[k] = cg[k] + T[k] * hf.y;
        cb[k] = cb[k] + T[k] * hf.z;
        T[k] = T[k] * hf.w;
      }
      live = live || (T[k] > eps);
    }
    if (!__any_sync(FULL_MASK, live)) return false;
  }
  return true;
}

template <bool TREE>
__device__ __forceinline__ void raster_tile(const uint32_t* __restrict__ words, int64_t stride,
                                            const int* __restrict__ ranges, const RasterParams& p,
                                            float* __restrict__ out) {
  __shared__ uint32_t s_raw[2][4][RASTER_BATCH];  // raw words, double-buffered
  // decoded records: (px, py, ha, hb), (hc, op, r, g), b
  __shared__ float4 s_ra[RASTER_BATCH], s_rb[RASTER_BATCH];
  __shared__ float s_rc[RASTER_BATCH];
  // bit 4 w + k: the record's cutoff ellipse meets sub-block k of warp w
  __shared__ uint32_t s_hits[RASTER_BATCH];
  __shared__ int4 s_sub[32];  // bounding box of sub-block k of warp w at [4 w + k]
  __shared__ MaskTables s_mt;

  const int t = blockIdx.x;
  const int start = ranges[t];
  const int end = ranges[t + 1];
  // the tree's batches start on a group boundary, so no group straddles two
  // batches or two ballots; positions before `start` stay out of every mask
  const int base = TREE ? start & ~(GROUP - 1) : start;
  const int tile_x = (t % p.tx_tiles) * p.tile_w;
  const int tile_y = (t / p.tx_tiles) * p.tile_h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const PixelMap map = pixel_map(p);
  const PixelShift shift = pixel_shift(map);

  // the centres of the thread's pixels, their transmittance and colour
  float cx[MAX_PIX_PER_THREAD], cy[MAX_PIX_PER_THREAD], T[MAX_PIX_PER_THREAD],
      cr[MAX_PIX_PER_THREAD], cg[MAX_PIX_PER_THREAD], cb[MAX_PIX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    const int2 q = pixel_of(warp, k, lane, map, p);
    cx[k] = (float)(tile_x + q.x) + 0.5f;
    cy[k] = (float)(tile_y + q.y) + 0.5f;
    const int x = tile_x + q.x, y = tile_y + q.y;
    const bool in_image = x - tile_x < p.tile_w && y - tile_y < p.tile_h && x < p.width &&
                          y < p.height;
    T[k] = in_image ? 1.0f : 0.0f;  // pixels off the tile or the image never blend
    cr[k] = cg[k] = cb[k] = 0.0f;
  }

  // bit k: some pixel of the warp's sub-block k is still live
  auto live_subs = [&]() {
    uint32_t m = 0u;
#pragma unroll
    for (int k = 0; k < MAX_PIX_PER_THREAD; ++k)
      m |= __any_sync(FULL_MASK, T[k] > p.eps) ? 1u << k : 0u;
    return m;
  };
  uint32_t live_sub = live_subs();
  if (threadIdx.x < 32) {  // warp 0: the sub-blocks and the mask's tables
    const int4 sb = sub_block_box(lane >> 2, lane & 3, map, p);
    s_sub[lane] = sb;
    int y0 = sb.z, y1 = sb.w;  // the rows of the warp's rectangle
    for (int o = 1; o < 4; o <<= 1) {
      y0 = min(y0, __shfl_xor_sync(FULL_MASK, y0, o));
      y1 = max(y1, __shfl_xor_sync(FULL_MASK, y1, o));
    }
    const uint32_t same = __match_any_sync(FULL_MASK, ((uint32_t)y0 << 16) | (uint32_t)y1);
    const bool first = __ffs(same) - 1 == lane;
    const uint32_t firsts = __ballot_sync(FULL_MASK, first);
    if (first) s_mt.band[__popc(firsts & ((1u << lane) - 1u))] = make_int4(y0, y1, (int)same, 0);
    if (lane == 0) s_mt.n_bands = __popc(firsts);
    if (shift.col >= 0) {  // the sub-blocks' grid cells, for c = -1 .. 32 at [c + 1]
      const int col = sb.x >> shift.col, row = sb.z >> shift.row;
      for (int c = -1; c <= 32; ++c) {
        const uint32_t cle = __ballot_sync(FULL_MASK, col <= c);
        const uint32_t cge = __ballot_sync(FULL_MASK, col >= c);
        const uint32_t rle = __ballot_sync(FULL_MASK, row <= c);
        const uint32_t rge = __ballot_sync(FULL_MASK, row >= c);
        if (lane == 0) {
          s_mt.col_le[c + 1] = cle;
          s_mt.col_ge[c + 1] = cge;
          s_mt.row_le[c + 1] = rle;
          s_mt.row_ge[c + 1] = rge;
        }
      }
    }
  }
  __syncthreads();

  auto stage = [&](int b0, int buf) {  // thread i copies record i of the batch
    const int idx = b0 + threadIdx.x;
    if ((int)threadIdx.x < RASTER_BATCH && (!TREE || idx >= start) && idx < end) {
#pragma unroll
      for (int w = 0; w < 4; ++w) cp_async4(&s_raw[buf][w][threadIdx.x], &words[w * stride + idx]);
    }
  };
  if (start < end) stage(base, 0);

  for (int b0 = base, buf = 0; b0 < end; b0 += RASTER_BATCH, buf ^= 1) {
    cp_async_wait_all();  // this thread's record of the batch has landed
    const int nb = min(RASTER_BATCH, end - b0);
    if (TREE && (int)threadIdx.x < nb && b0 + (int)threadIdx.x < start) {
      s_hits[threadIdx.x] = 0u;  // before the span (tree): the identity
    } else if ((int)threadIdx.x < nb) {
      const int s = threadIdx.x;
      const Record r = unpack_record(s_raw[buf][0][s], s_raw[buf][1][s], s_raw[buf][2][s],
                                     s_raw[buf][3][s], p.cq);
      s_ra[s] = make_float4(r.px, r.py, r.ha, r.hb);
      s_rb[s] = make_float4(r.hc, r.op, r.r, r.g);
      s_rc[s] = r.b;
      Ellipse e;
      const int4 box = record_box(r, tile_x, tile_y, p.tile_w, p.tile_h, e);
      s_hits[s] = record_hits(r, e, box, tile_x, tile_y, p.tile_w, shift, s_sub, s_mt);
    }
    // the other buffer held the previous batch, decoded before the last barrier
    if (b0 + RASTER_BATCH < end) stage(b0 + RASTER_BATCH, buf ^ 1);
    __syncthreads();  // decoded records visible

    if (live_sub != 0u) {
      // this warp's records of the batch, in order: 32 hit flags per ballot
      for (int c0 = 0; c0 < nb && live_sub != 0u; c0 += 32) {
        const uint32_t mine =
            c0 + lane < nb ? (s_hits[c0 + lane] >> (4 * warp)) & live_sub : 0u;
        if constexpr (TREE) {
          if (!tree_groups(c0, mine, cx, cy, T, cr, cg, cb, s_ra, s_rb, s_rc, p.eps))
            live_sub = 0u;  // every pixel of the warp saturated
          continue;
        }
        for (uint32_t bits = __ballot_sync(FULL_MASK, mine != 0u); bits != 0u;
             bits &= bits - 1u) {
          const int src = __ffs(bits) - 1, s = c0 + src;
          const uint32_t sub = __shfl_sync(FULL_MASK, mine, src);  // live sub-blocks it meets
          const float4 ra = s_ra[s], rb = s_rb[s];  // (px, py, ha, hb), (hc, op, r, g)
          bool live = false;
#pragma unroll
          for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
            if (((sub >> k) & 1u) && T[k] > p.eps) {
              const float dx = cx[k] - ra.x;
              const float dy = cy[k] - ra.y;
              const float a = ra.z * dx * dx + ra.w * dx * dy + rb.x * dy * dy;
              if (a < CUTOFF2 && rb.y > 0.0f) {
                const float alpha = fminf(0.99f, expf(-a) * rb.y);
                const float w = alpha * T[k];
                cr[k] = cr[k] + w * rb.z;
                cg[k] = cg[k] + w * rb.w;
                cb[k] = cb[k] + w * s_rc[s];
                T[k] = T[k] * (1.0f - alpha);
              }
            }
            live = live || (T[k] > p.eps);
          }
          if (!__any_sync(FULL_MASK, live)) {  // every pixel of the warp saturated
            live_sub = 0u;
            break;
          }
        }
      }
      if (live_sub != 0u) live_sub = live_subs();
    }
    // also the barrier that frees the decoded arrays for the next batch
    if (__syncthreads_count(live_sub != 0u && lane == 0) == 0) break;
  }
  cp_async_wait_all();  // no copy may outlive the CTA

  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    const int x = (int)cx[k], y = (int)cy[k];
    if (x - tile_x < p.tile_w && y - tile_y < p.tile_h && x < p.width && y < p.height) {
      float* o = out + ((int64_t)y * p.width + x) * 3;
      o[0] = cr[k] + T[k] * bg0;
      o[1] = cg[k] + T[k] * bg1;
      o[2] = cb[k] + T[k] * bg2;
    }
  }
}

__global__ void __launch_bounds__(RASTER_THREADS, RASTER_MIN_BLOCKS)
    rasterize_kernel(const uint32_t* __restrict__ words, int64_t stride,
                     const int* __restrict__ ranges, RasterParams p, float* __restrict__ out) {
  raster_tile<false>(words, stride, ranges, p, out);
}

__global__ void __launch_bounds__(RASTER_THREADS, TREE_MIN_BLOCKS)
    rasterize_tree_kernel(const uint32_t* __restrict__ words, int64_t stride,
                          const int* __restrict__ ranges, RasterParams p,
                          float* __restrict__ out) {
  raster_tile<true>(words, stride, ranges, p, out);
}

}  // namespace ws

extern "C" {

// words: 4 rows of `stride` u32 (sorted records); ranges: num_tiles + 1
// ints; bg: 3 floats in device memory; out: (height, width, 3) f32;
// warp_w: ops/rasterize.py:warp_layout; tree: 1 for the tree composite
int ws_rasterize(const uint32_t* words, int64_t stride, const int* ranges, const float* bg,
                 float* out, int width, int height, int tile_w, int tile_h, int tx_tiles,
                 int warp_w, float eps, float margin, float scale_x, float scale_y, int tree,
                 void* stream) {
  if (tile_w * tile_h > ws::RASTER_THREADS * ws::MAX_PIX_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  if (warp_w < 0 || warp_w > ws::WARP_PIXELS || (warp_w > 0 && ws::WARP_PIXELS % warp_w != 0))
    return (int)cudaErrorInvalidValue;
  ws::RasterParams p{width, height, tile_w, tile_h, tx_tiles, warp_w, eps,
                     bg, ws::CenterQuant{margin, scale_x, scale_y}};
  const int ty_tiles = (height + tile_h - 1) / tile_h;
  const int num_tiles = tx_tiles * ty_tiles;
  if (num_tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (tree)
      ws::rasterize_tree_kernel<<<num_tiles, ws::RASTER_THREADS, 0, s>>>(words, stride, ranges, p,
                                                                         out);
    else
      ws::rasterize_kernel<<<num_tiles, ws::RASTER_THREADS, 0, s>>>(words, stride, ranges, p, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
