// Slab rasterizer: front-to-back blending as three tensor-core contractions
// over 128-splat slabs (RasterConfig composite="mxu" and "hybrid").
//
// Replaces websplat_tpu/ops/rasterize_pallas.py:_make_kernel_mxu (called by
// rasterize_pallas through _make_kernel), including the wrapper's tile
// assembly and background composite (rasterize_pallas.py:1112-1116): the
// kernel writes the (H, W, 3) image.
//
// What it computes, per tile and per slab of 128 depth-consecutive stream
// positions (aligned to absolute multiples of 128; positions outside the
// tile's span are dead lanes, sanitized to coefficients 0, c5 = -1e30,
// t5 = 0 before any contraction):
//   na(p, s)  = M6(p, :) . C(:, s)        monomials [-x^2, -xy, -y^2, x, y, 1]
//                                          of tile-local pixel centres against
//                                          [ha, hb, hc, c3, c4, log op - a0]
//   alpha     = min(0.99, exp(na)) where na > t5 = log op - 2*CUTOFF, else 0
//   loga      = log1p(-alpha)
//   cum(p, s) = sum_{k < s} loga(p, k)    loga . U, U strictly upper 0/1
//   w         = alpha * exp(cum + clog)
//   acc(p, :) += w(p, :) . RGB(:, 3)
//   clog(p)  += sum_s loga(p, s)
// and the image is acc + exp(clog) * bg.  The matrices are laid out with
// PIXELS as rows, so each contraction's accumulator fragment is the next
// one's A operand (two n8 accumulator tiles = one k16 A fragment), and no
// fragment goes through shared memory.
//
// Precision (template arguments; every product of bf16 values is exact and
// every sum is f32):
//   NQ  bf16 splits of both operands of the quadratic form (0 = the hybrid's
//       exact f32 multiply-adds on the CUDA cores, in JAX's sum order);
//   NL  bf16 splits of loga (U is bf16-exact, so its own splits vanish);
//   NC  bf16 splits of both operands of the colour contraction.
// With n splits the passes are A_i . B_j for i + j < n: 1 pass (n = 1,
// "default"), 3 (n = 2, "high", lax.Precision.HIGH), 6 (n = 3, "highest",
// the TPU's f32 emulation).  The hybrid is (0, 2, 2): dot2 and dot3 of the
// TPU kernel (rasterize_pallas.py:275-285).
//
// Stopping is tile-wide at slab granularity, as on the TPU: a slab runs only
// if one of its lanes is live and some pixel of the tile still has
// clog > log(eps) (a CTA-wide vote); once no pixel has, the tile is done.
//
// What bounds it on the card: the function needs the quadratic form of
// every (pixel, splat) pair of the slabs the tile stop leaves (f32 work,
// the bound's term), but exp, log1p, exp and the blend only for the pairs
// with alpha > 0: 13% of them at the bench scene.  Its time goes to that
// per-pair work on the CUDA cores (in development builds, taking out any
// one stage of it cut the time), so the design cuts what a pair costs:
// - Each 16-pixel block walks its slab in k16 chunks of 16 splats: the
//   chunk's quadratic form, then a warp vote on alpha > 0.  A chunk where no
//   (pixel, splat) pair has alpha > 0 adds exactly nothing (log1p(-0) = -0,
//   w = 0 * exp(cum + clog) = 0 as cum + clog <= 0, zero colour products),
//   so all that follows is skipped.  At the bench scene 86.5% of the
//   chunks stay live: 16 splats of a depth-sorted span rarely all miss a
//   block.
// - In a live chunk only ~40 of the 256 pairs have alpha > 0, so the warp
//   packs those pairs into shared memory (ballot + popc) and its lanes run
//   exp, log1p and the second exp over the packed list only; each lane
//   reads its own pairs back.  Same operations per pair, so bit-equal to
//   evaluating every pair.
// - The prefix is each pixel's running carry (the f32 sum of the earlier
//   chunks' bf16 split parts of loga, reduced over the quad by shuffles) plus
//   one strictly-upper 16x16 triangle per chunk on the tensor cores (2 n8
//   tiles x NL splits: 32 MMAs per block and slab for the hybrid); the carry
//   enters as the MMA's accumulator.
// - A block is a 4x4 pixel square when tile_w and tile_h are multiples of 4
//   (16-pixel row strips otherwise), so a chunk of small splats can miss it.
// - Per-chunk state is [2][4] per thread; built for 3 CTAs per SM (<= 80
//   registers; "highest" spills a few bytes).
// One CTA per tile, 8 warps, each warp owning blocks blk = warp + 8k; per
// slab the first 128 threads decode the records into shared memory
// (coefficients already split into bf16 pairs); each pixel's acc and clog
// live in shared memory between slabs.  What is left is the per-chunk
// work of the live chunks (the hybrid's quadratic form alone is 88 f32
// operations per thread and chunk; splits, packs and shuffles around each
// contraction).  The float steps outside the contractions are operation
// for operation those of ops/rasterize_mxu.py:rasterize_mxu_torch (built
// with -fmad=false, no fast math).
#include <cstdint>

#include <cuda_bf16.h>

#include "packing.cuh"

namespace ws {

constexpr int MXU_THREADS = 256;
constexpr int MXU_WARPS = MXU_THREADS / 32;
constexpr int SLAB = 128;
constexpr int CHUNK = 16;
constexpr int MXU_MAX_PIX = 1024;
constexpr float DEAD_C5 = -1.0e30f;
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr uint32_t BF16_ONES = 0x3F803F80u;
constexpr unsigned MXU_FULL = 0xffffffffu;

struct MxuParams {
  int width, height, tile_w, tile_h, tx_tiles;
  int square;  // 1: 4x4 pixel blocks, 0: 16-pixel row strips
  float log_eps;
  const float* bg;  // 3 floats in device memory
  CenterQuant cq;
};

template <int NQ, int NC>
struct MxuSmem {
  uint32_t coef[NQ > 0 ? NQ : 1][SLAB][3];  // bf16 pairs (c0,c1), (c2,c3), (c4,c5)
  float coef32[NQ > 0 ? 1 : 6][SLAB];       // the hybrid's f32 coefficients
  float t5[SLAB];
  uint16_t rgb[NC][3][SLAB];  // bf16 bit patterns
  float clog[MXU_MAX_PIX];
  float acc[MXU_MAX_PIX][4];  // r, g, b, unused
  // per warp: a chunk's (pixel, splat) pairs with alpha > 0, packed
  float packed[MXU_WARPS][2][CHUNK * 16];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = parts[0] + parts[1] + ... : each part bf16-exact, the next one the
// rounded remainder (the plain version's bf16_split)
template <int N>
__device__ __forceinline__ void split_bf16(float x, float (&parts)[N]) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    parts[s] = __bfloat162float(__float2bfloat16_rn(x));
    x = x - parts[s];
  }
}

// A fragments (16 x 16, rows g and g + 8, cols 2q, 2q + 1 and + 8) of N
// splits, from split accumulator values of two n8 tiles: p[0..3] of the
// tile holding cols 0-7, p[4..7] of the tile holding cols 8-15
template <int N>
__device__ __forceinline__ void pack_frags(const float (&p)[8][N], uint32_t (&f)[N][4]) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    f[s][0] = pack_bf16x2(p[0][s], p[1][s]);
    f[s][1] = pack_bf16x2(p[2][s], p[3][s]);
    f[s][2] = pack_bf16x2(p[4][s], p[5][s]);
    f[s][3] = pack_bf16x2(p[6][s], p[7][s]);
  }
}

template <int N>
__device__ __forceinline__ void a_frags(const float (&v)[8], uint32_t (&f)[N][4]) {
  float p[8][N];
#pragma unroll
  for (int e = 0; e < 8; ++e) split_bf16<N>(v[e], p[e]);
  pack_frags<N>(p, f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += sum over i + j < N of A_i . B_j, smallest terms first
template <int N>
__device__ __forceinline__ void mma_passes(float (&d)[4], const uint32_t (&a)[N][4],
                                           const uint32_t (&b)[N][2]) {
#pragma unroll
  for (int t = N - 1; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i <= t; ++i) mma_bf16(d, a[i], b[t - i][0], b[t - i][1]);
  }
}

// tile-local row-major index of the pixel in MMA row r (0..15) of block
// blk (ops/rasterize_mxu.py:block_pixels)
__device__ __forceinline__ int block_pixel(int blk, int r, const MxuParams& p) {
  if (p.square) {
    const int bw = p.tile_w >> 2;
    return (4 * (blk / bw) + (r >> 2)) * p.tile_w + 4 * (blk % bw) + (r & 3);
  }
  return 16 * blk + r;
}

// sum over a quad (the 4 lanes holding one MMA row)
__device__ __forceinline__ float quad_sum(float v) {
  v = v + __shfl_xor_sync(MXU_FULL, v, 1);
  return v + __shfl_xor_sync(MXU_FULL, v, 2);
}

// one 16-pixel block (rows g -> pixel f0, g + 8 -> pixel f1) through one slab
template <int NQ, int NL, int NC>
__device__ __forceinline__ bool slab_block(MxuSmem<NQ, NC>& sm, int blk, const MxuParams& p) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int f0 = block_pixel(blk, g, p), f1 = block_pixel(blk, g + 8, p);
  const float x0 = (float)(f0 % p.tile_w) + 0.5f, y0 = (float)(f0 / p.tile_w) + 0.5f;
  const float x1 = (float)(f1 % p.tile_w) + 0.5f, y1 = (float)(f1 / p.tile_w) + 0.5f;

  // the quadratic form's pixel operand, for every chunk
  float m0[6], m1[6];
  uint32_t am[NQ > 0 ? NQ : 1][4];
  if constexpr (NQ == 0) {
    m0[0] = -(x0 * x0); m0[1] = -(x0 * y0); m0[2] = -(y0 * y0);
    m0[3] = x0; m0[4] = y0; m0[5] = 1.0f;
    m1[0] = -(x1 * x1); m1[1] = -(x1 * y1); m1[2] = -(y1 * y1);
    m1[3] = x1; m1[4] = y1; m1[5] = 1.0f;
  } else {
    // A = the monomial matrix (k = monomial index, 6 of 16 used): this
    // thread holds monomials 2q, 2q + 1 of its two pixels
    const float lo0 = q == 0 ? -(x0 * x0) : q == 1 ? -(y0 * y0) : q == 2 ? y0 : 0.0f;
    const float hi0 = q == 0 ? -(x0 * y0) : q == 1 ? x0 : q == 2 ? 1.0f : 0.0f;
    const float lo1 = q == 0 ? -(x1 * x1) : q == 1 ? -(y1 * y1) : q == 2 ? y1 : 0.0f;
    const float hi1 = q == 0 ? -(x1 * y1) : q == 1 ? x1 : q == 2 ? 1.0f : 0.0f;
    float sl0[NQ], sh0[NQ], sl1[NQ], sh1[NQ];
    split_bf16<NQ>(lo0, sl0);
    split_bf16<NQ>(hi0, sh0);
    split_bf16<NQ>(lo1, sl1);
    split_bf16<NQ>(hi1, sh1);
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      am[s][0] = pack_bf16x2(sl0[s], sh0[s]);
      am[s][1] = pack_bf16x2(sl1[s], sh1[s]);
      am[s][2] = 0u;
      am[s][3] = 0u;
    }
  }

  const float cl0 = sm.clog[f0], cl1 = sm.clog[f1];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q < 2) {
    acc[0] = sm.acc[f0][2 * q];
    acc[1] = sm.acc[f0][2 * q + 1];
    acc[2] = sm.acc[f1][2 * q];
    acc[3] = sm.acc[f1][2 * q + 1];
  }
  float* buf0 = sm.packed[threadIdx.x >> 5][0];
  float* buf1 = sm.packed[threadIdx.x >> 5][1];
  float carry0 = 0.0f, carry1 = 0.0f;  // the slab's prefix before this chunk
  float ls0 = 0.0f, ls1 = 0.0f;        // this thread's share of sum_s loga
  // in-chunk triangle U (k = 2q + {0,1} (+8), n = g (+8)): 1 where k < n
  const uint32_t diag = ((2 * q < g) ? BF16_ONE : 0u) | ((2 * q + 1 < g) ? BF16_ONE << 16 : 0u);

#pragma unroll 1
  for (int c = 0; c < SLAB / CHUNK; ++c) {
    const int k0 = CHUNK * c;
    // ---- quadratic form and alpha: a[j][e] of pixel (e < 2 ? f0 : f1)
    // and splat k0 + 8j + 2q + (e & 1), the m16n8 accumulator layout ----
    float a[2][4];
    if constexpr (NQ == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = k0 + 8 * j + 2 * q + (e & 1);
          const float* m = e < 2 ? m0 : m1;
          float na = sm.coef32[0][s] * m[0];
          na = na + sm.coef32[1][s] * m[1];
          na = na + sm.coef32[2][s] * m[2];
          na = na + sm.coef32[3][s] * m[3];
          na = na + sm.coef32[4][s] * m[4];
          na = na + sm.coef32[5][s] * m[5];
          a[j][e] = na;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bq[NQ][2];
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          bq[s][0] = q < 3 ? sm.coef[s][k0 + 8 * j + g][q < 3 ? q : 0] : 0u;
          bq[s][1] = 0u;
        }
        a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.0f;
        mma_passes<NQ>(a[j], am, bq);
      }
    }
    bool on[2][4];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        on[j][e] = a[j][e] > sm.t5[k0 + 8 * j + 2 * q + (e & 1)];
        hit = hit || on[j][e];
      }
    }
    // no pair of the block and chunk has alpha > 0: the chunk adds exactly
    // nothing to cum, clog or acc
    if (!__any_sync(MXU_FULL, hit)) continue;

    // ---- alpha and loga of the pairs with alpha > 0 only: the warp packs
    // their na into shared memory (slot pos[4j + e]), its lanes evaluate
    // the packed list, and each lane reads its own pairs back; a pair with
    // alpha = 0 has loga = log1p(-0) = -0 ----
    const unsigned lt = (1u << lane) - 1u;
    int pos[8];
    int n_on = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned m = __ballot_sync(MXU_FULL, on[j][e]);
        pos[4 * j + e] = n_on + __popc(m & lt);
        n_on += __popc(m);
        if (on[j][e]) buf0[pos[4 * j + e]] = a[j][e];
      }
    }
    __syncwarp();
    for (int i = lane; i < n_on; i += 32) {
      const float al = fminf(0.99f, expf(buf0[i]));
      buf0[i] = al;
      buf1[i] = log1pf(-al);
    }
    __syncwarp();
    float l[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[j][e] = on[j][e] ? buf0[pos[4 * j + e]] : 0.0f;
        l[4 * j + e] = on[j][e] ? buf1[pos[4 * j + e]] : -0.0f;
      }
    }
    __syncwarp();  // before buf0 is reused

    // ---- prefix: cum = carry + the in-chunk triangle of loga's splits ----
    ls0 = ls0 + ((l[0] + l[1]) + (l[4] + l[5]));
    ls1 = ls1 + ((l[2] + l[3]) + (l[6] + l[7]));
    float lp[8][NL];
#pragma unroll
    for (int e = 0; e < 8; ++e) split_bf16<NL>(l[e], lp[e]);
    uint32_t lf[NL][4];
    pack_frags<NL>(lp, lf);
    float cum[2][4] = {{carry0, carry0, carry1, carry1}, {carry0, carry0, carry1, carry1}};
#pragma unroll
    for (int s = NL - 1; s >= 0; --s) {
      mma_bf16(cum[0], lf[s], diag, 0u);
      mma_bf16(cum[1], lf[s], BF16_ONES, diag);
    }
    // the carry sums the same split parts the triangle contracts
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int s = NL - 1; s >= 0; --s) {
      r0 = r0 + ((lp[0][s] + lp[1][s]) + (lp[4][s] + lp[5][s]));
      r1 = r1 + ((lp[2][s] + lp[3][s]) + (lp[6][s] + lp[7][s]));
    }
    carry0 = carry0 + quad_sum(r0);
    carry1 = carry1 + quad_sum(r1);

    // ---- colours: w = alpha * exp(cum + clog), the exp again only for
    // the packed pairs (w = 0 where alpha = 0) ----
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (on[j][e]) buf0[pos[4 * j + e]] = cum[j][e] + (e < 2 ? cl0 : cl1);
      }
    }
    __syncwarp();
    for (int i = lane; i < n_on; i += 32) buf0[i] = expf(buf0[i]);
    __syncwarp();
    float w[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[4 * j + e] = on[j][e] ? a[j][e] * buf0[pos[4 * j + e]] : 0.0f;
    }
    uint32_t wf[NC][4];
    a_frags<NC>(w, wf);
    uint32_t br[NC][2];
#pragma unroll
    for (int s = 0; s < NC; ++s) {
      // B = RGB (k = splat, n = channel g; channels 3-7 are zero)
      const uint16_t* row = sm.rgb[s][g < 3 ? g : 0];
      br[s][0] = g < 3 ? *reinterpret_cast<const uint32_t*>(row + k0 + 2 * q) : 0u;
      br[s][1] = g < 3 ? *reinterpret_cast<const uint32_t*>(row + k0 + 8 + 2 * q) : 0u;
    }
    mma_passes<NC>(acc, wf, br);
  }

  // ---- state: clog += sum over the slab of loga (f32, quad reduction) ----
  const float n0 = cl0 + quad_sum(ls0), n1 = cl1 + quad_sum(ls1);
  __syncwarp();
  if (q < 2) {
    sm.acc[f0][2 * q] = acc[0];
    sm.acc[f0][2 * q + 1] = acc[1];
    sm.acc[f1][2 * q] = acc[2];
    sm.acc[f1][2 * q + 1] = acc[3];
  }
  if (q == 0) {
    sm.clog[f0] = n0;
    sm.clog[f1] = n1;
  }
  return n0 > p.log_eps || n1 > p.log_eps;
}

template <int NQ, int NL, int NC>
__global__ void __launch_bounds__(MXU_THREADS, 3)
    rasterize_mxu_kernel(const uint32_t* __restrict__ words, int64_t stride,
                         const int* __restrict__ ranges, MxuParams p, float* __restrict__ out) {
  __shared__ MxuSmem<NQ, NC> sm;
  const int t = blockIdx.x;
  const int start = ranges[t];
  const int end = ranges[t + 1];
  const int tile_x = (t % p.tx_tiles) * p.tile_w;
  const int tile_y = (t / p.tx_tiles) * p.tile_h;
  const float tile_xf = (float)tile_x, tile_yf = (float)tile_y;
  const int n_pix = p.tile_w * p.tile_h;
  const int n_blk = n_pix / 16;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < n_pix; i += MXU_THREADS) {
    sm.clog[i] = 0.0f;
    sm.acc[i][0] = sm.acc[i][1] = sm.acc[i][2] = sm.acc[i][3] = 0.0f;
  }
  // does one of this thread's pixels still have clog > log(eps)?
  bool alive = warp < n_blk && 0.0f > p.log_eps;

  const int slab0 = start / SLAB;
  const int slab1 = end > start ? (end + SLAB - 1) / SLAB : slab0;
  for (int k = slab0; k < slab1; ++k) {
    // tile-wide stop vote; also the barrier before the slab arrays are reused
    if (!__syncthreads_or(alive)) break;
    bool live = false;
    if (threadIdx.x < SLAB) {
      const int l = threadIdx.x;
      const int pos = k * SLAB + l;
      float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, DEAD_C5};
      float t5 = 0.0f, col[3] = {0.0f, 0.0f, 0.0f};
      if (pos >= start && pos < end) {
        const Record r = unpack_record(words[pos], words[stride + pos], words[2 * stride + pos],
                                       words[3 * stride + pos], p.cq);
        if (r.op > 0.0f) {
          live = true;
          const float u = r.px - tile_xf;
          const float v = r.py - tile_yf;
          const float hbv = r.hb * v;
          const float a0 = (r.ha * u + hbv) * u + r.hc * (v * v);
          const float logop = (float)log((double)r.op);
          c[0] = r.ha;
          c[1] = r.hb;
          c[2] = r.hc;
          c[3] = (r.ha + r.ha) * u + hbv;
          c[4] = r.hb * u + (r.hc + r.hc) * v;
          c[5] = logop - a0;
          t5 = logop - CUTOFF2;
          col[0] = r.r;
          col[1] = r.g;
          col[2] = r.b;
        }
      }
      if constexpr (NQ == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) sm.coef32[i][l] = c[i];
      } else {
        float sp[6][NQ];
#pragma unroll
        for (int i = 0; i < 6; ++i) split_bf16<NQ>(c[i], sp[i]);
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          sm.coef[s][l][0] = pack_bf16x2(sp[0][s], sp[1][s]);
          sm.coef[s][l][1] = pack_bf16x2(sp[2][s], sp[3][s]);
          sm.coef[s][l][2] = pack_bf16x2(sp[4][s], sp[5][s]);
        }
      }
      sm.t5[l] = t5;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float sp[NC];
        split_bf16<NC>(col[ch], sp);
#pragma unroll
        for (int s = 0; s < NC; ++s) sm.rgb[s][ch][l] = __bfloat16_as_ushort(__float2bfloat16_rn(sp[s]));
      }
    }
    // a slab with no live lane changes nothing; also the barrier that
    // publishes the decoded slab
    if (!__syncthreads_or(live)) continue;
    bool any = false;
    for (int blk = warp; blk < n_blk; blk += MXU_WARPS) {
      any = slab_block<NQ, NL, NC>(sm, blk, p) || any;
    }
    alive = any;
  }
  __syncthreads();

  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
  for (int i = threadIdx.x; i < n_pix; i += MXU_THREADS) {
    const int x = tile_x + i % p.tile_w, y = tile_y + i / p.tile_w;
    if (x < p.width && y < p.height) {
      const float trans = expf(sm.clog[i]);
      float* o = out + ((int64_t)y * p.width + x) * 3;
      o[0] = sm.acc[i][0] + trans * bg0;
      o[1] = sm.acc[i][1] + trans * bg1;
      o[2] = sm.acc[i][2] + trans * bg2;
    }
  }
}

}  // namespace ws

extern "C" {

// words: 4 rows of `stride` u32 (sorted records); ranges: num_tiles + 1
// ints; bg: 3 floats in device memory; out: (height, width, 3) f32;
// log_eps: f32(log(transmittance_eps)); mode: 0 "default", 1 "high",
// 2 "highest" (composite="mxu"), 3 composite="hybrid"
int ws_rasterize_mxu(const uint32_t* words, int64_t stride, const int* ranges,
                     const float* bg, float* out, int width, int height, int tile_w,
                     int tile_h, int tx_tiles, float log_eps, float margin, float scale_x,
                     float scale_y, int mode, void* stream) {
  const int n_pix = tile_w * tile_h;
  if (n_pix % 128 != 0 || n_pix > ws::MXU_MAX_PIX) return (int)cudaErrorInvalidValue;
  const int square = (tile_w % 4 == 0 && tile_h % 4 == 0) ? 1 : 0;
  ws::MxuParams p{width, height, tile_w, tile_h, tx_tiles, square, log_eps,
                  bg, ws::CenterQuant{margin, scale_x, scale_y}};
  const int ty_tiles = (height + tile_h - 1) / tile_h;
  const int num_tiles = tx_tiles * ty_tiles;
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      ws::rasterize_mxu_kernel<1, 1, 1><<<num_tiles, ws::MXU_THREADS, 0, s>>>(words, stride,
                                                                            ranges, p, out);
      break;
    case 1:
      ws::rasterize_mxu_kernel<2, 2, 2><<<num_tiles, ws::MXU_THREADS, 0, s>>>(words, stride,
                                                                            ranges, p, out);
      break;
    case 2:
      ws::rasterize_mxu_kernel<3, 3, 3><<<num_tiles, ws::MXU_THREADS, 0, s>>>(words, stride,
                                                                            ranges, p, out);
      break;
    case 3:
      ws::rasterize_mxu_kernel<0, 2, 2><<<num_tiles, ws::MXU_THREADS, 0, s>>>(words, stride,
                                                                            ranges, p, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
