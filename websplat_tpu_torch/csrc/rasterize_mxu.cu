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
// What bounds it on the card: per (splat, pixel) pair three transcendentals
// (expf, log1pf, expf) on the CUDA cores, and 2*128*128*P FLOP per slab and
// loga split for the prefix on the tensor cores; it evaluates every pixel of
// a tile for every slab until the whole tile saturates (the scan kernel
// stops pixel by pixel), so it is expected to be slower than the scan
// kernel.  Its design: one CTA per tile, 8 warps, each warp owning 16-pixel
// row blocks; mma.sync.m16n8k16 bf16 with f32 accumulators; per slab the
// first 128 threads decode the records into shared memory (coefficients
// already split into bf16 pairs); each pixel's acc and clog live in shared
// memory between slabs.  The float steps outside the contractions are
// operation for operation those of ops/rasterize_mxu.py:rasterize_mxu_torch
// (built with -fmad=false, no fast math).
#include <cstdint>

#include <cuda_bf16.h>

#include "packing.cuh"

namespace ws {

constexpr int MXU_THREADS = 256;
constexpr int MXU_WARPS = MXU_THREADS / 32;
constexpr int SLAB = 128;
constexpr int MXU_MAX_PIX = 1024;
constexpr float DEAD_C5 = -1.0e30f;
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr uint32_t BF16_ONES = 0x3F803F80u;

struct MxuParams {
  int width, height, tile_w, tile_h, tx_tiles;
  float log_eps;
  float bg[3];
  CenterQuant cq;
};

template <int NQ, int NC>
struct MxuSmem {
  uint32_t coef[NQ > 0 ? NQ : 1][SLAB][3];  // bf16 pairs (c0,c1), (c2,c3), (c4,c5)
  float coef32[6][SLAB];                    // the hybrid's f32 coefficients
  float t5[SLAB];
  uint16_t rgb[NC][3][SLAB];  // bf16 bit patterns
  float clog[MXU_MAX_PIX];
  float acc[MXU_MAX_PIX][4];  // r, g, b, unused
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

// A fragment (16 x 16, rows g and g + 8, cols 2q, 2q + 1 and + 8) of N
// splits, from the accumulator values of two n8 tiles: v[0..3] of the tile
// holding cols 0-7, v[4..7] of the tile holding cols 8-15
template <int N>
__device__ __forceinline__ void a_frags(const float (&v)[8], uint32_t (&f)[N][4]) {
  float p[8][N];
#pragma unroll
  for (int e = 0; e < 8; ++e) split_bf16<N>(v[e], p[e]);
#pragma unroll
  for (int s = 0; s < N; ++s) {
    f[s][0] = pack_bf16x2(p[0][s], p[1][s]);
    f[s][1] = pack_bf16x2(p[2][s], p[3][s]);
    f[s][2] = pack_bf16x2(p[4][s], p[5][s]);
    f[s][3] = pack_bf16x2(p[6][s], p[7][s]);
  }
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

// one 16-pixel row block (pixels f0 = 16*blk + g and f0 + 8) through one slab
template <int NQ, int NL, int NC>
__device__ __forceinline__ bool slab_block(MxuSmem<NQ, NC>& sm, int blk, const MxuParams& p) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int f0 = 16 * blk + g, f1 = f0 + 8;
  const float x0 = (float)(f0 % p.tile_w) + 0.5f, y0 = (float)(f0 / p.tile_w) + 0.5f;
  const float x1 = (float)(f1 % p.tile_w) + 0.5f, y1 = (float)(f1 / p.tile_w) + 0.5f;

  // ---- quadratic form: a[j][e] = na of pixel (e < 2 ? f0 : f1) and splat
  // 8j + 2q + (e & 1), the m16n8 accumulator layout ----
  float a[16][4];
  if constexpr (NQ == 0) {
    const float m0[6] = {-(x0 * x0), -(x0 * y0), -(y0 * y0), x0, y0, 1.0f};
    const float m1[6] = {-(x1 * x1), -(x1 * y1), -(y1 * y1), x1, y1, 1.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * j + 2 * q + (e & 1);
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
    uint32_t am[NQ][4];
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      am[s][0] = pack_bf16x2(sl0[s], sh0[s]);
      am[s][1] = pack_bf16x2(sl1[s], sh1[s]);
      am[s][2] = 0u;
      am[s][3] = 0u;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t bq[NQ][2];
#pragma unroll
      for (int s = 0; s < NQ; ++s) {
        bq[s][0] = q < 3 ? sm.coef[s][8 * j + g][q < 3 ? q : 0] : 0u;
        bq[s][1] = 0u;
      }
      a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.0f;
      mma_passes<NQ>(a[j], am, bq);
    }
  }

  // ---- alpha ----
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float na = a[j][e];
      a[j][e] = na > sm.t5[8 * j + 2 * q + (e & 1)] ? fminf(0.99f, expf(na)) : 0.0f;
    }
  }

  // ---- prefix and colours, one k16 chunk (splats 16c .. 16c + 15) at a
  // time: after chunk c the cum tiles 2c and 2c + 1 are final ----
  const float cl0 = sm.clog[f0], cl1 = sm.clog[f1];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (q < 2) {
    acc[0] = sm.acc[f0][2 * q];
    acc[1] = sm.acc[f0][2 * q + 1];
    acc[2] = sm.acc[f1][2 * q];
    acc[3] = sm.acc[f1][2 * q + 1];
  }
  float cum[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) cum[j][0] = cum[j][1] = cum[j][2] = cum[j][3] = 0.0f;
  float ls0 = 0.0f, ls1 = 0.0f;
  const uint32_t diag = ((2 * q < g) ? BF16_ONE : 0u) | ((2 * q + 1 < g) ? BF16_ONE << 16 : 0u);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float l[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      l[e] = log1pf(-a[2 * c][e]);
      l[4 + e] = log1pf(-a[2 * c + 1][e]);
    }
    ls0 = ls0 + ((l[0] + l[1]) + (l[4] + l[5]));
    ls1 = ls1 + ((l[2] + l[3]) + (l[6] + l[7]));
    uint32_t lf[NL][4];
    a_frags<NL>(l, lf);
#pragma unroll
    for (int j = 2 * c; j < 16; ++j) {
      // U block (k = 16c + 2q + {0,1} (+8), n = 8j + g): 1 where k < n
      const uint32_t u0 = j == 2 * c ? diag : BF16_ONES;
      const uint32_t u1 = j == 2 * c ? 0u : j == 2 * c + 1 ? diag : BF16_ONES;
#pragma unroll
      for (int s = NL - 1; s >= 0; --s) mma_bf16(cum[j], lf[s], u0, u1);
    }
    float w[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cl = e < 2 ? cl0 : cl1;
      w[e] = a[2 * c][e] * expf(cum[2 * c][e] + cl);
      w[4 + e] = a[2 * c + 1][e] * expf(cum[2 * c + 1][e] + cl);
    }
    uint32_t wf[NC][4];
    a_frags<NC>(w, wf);
    uint32_t br[NC][2];
#pragma unroll
    for (int s = 0; s < NC; ++s) {
      // B = RGB (k = splat, n = channel g; channels 3-7 are zero)
      const uint16_t* row = sm.rgb[s][g < 3 ? g : 0];
      br[s][0] = g < 3 ? *reinterpret_cast<const uint32_t*>(row + 16 * c + 2 * q) : 0u;
      br[s][1] = g < 3 ? *reinterpret_cast<const uint32_t*>(row + 16 * c + 8 + 2 * q) : 0u;
    }
    mma_passes<NC>(acc, wf, br);
  }

  // ---- state: clog += sum over the slab of loga (f32, quad reduction) ----
  ls0 = ls0 + __shfl_xor_sync(0xffffffffu, ls0, 1);
  ls0 = ls0 + __shfl_xor_sync(0xffffffffu, ls0, 2);
  ls1 = ls1 + __shfl_xor_sync(0xffffffffu, ls1, 1);
  ls1 = ls1 + __shfl_xor_sync(0xffffffffu, ls1, 2);
  const float n0 = cl0 + ls0, n1 = cl1 + ls1;
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
__global__ void __launch_bounds__(MXU_THREADS, 1)
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

  for (int i = threadIdx.x; i < n_pix; i += MXU_THREADS) {
    const int x = tile_x + i % p.tile_w, y = tile_y + i / p.tile_w;
    if (x < p.width && y < p.height) {
      const float trans = expf(sm.clog[i]);
      float* o = out + ((int64_t)y * p.width + x) * 3;
      o[0] = sm.acc[i][0] + trans * p.bg[0];
      o[1] = sm.acc[i][1] + trans * p.bg[1];
      o[2] = sm.acc[i][2] + trans * p.bg[2];
    }
  }
}

}  // namespace ws

extern "C" {

// words: 4 rows of `stride` u32 (sorted records); ranges: num_tiles + 1
// ints; bg_host: 3 floats on the host; out: (height, width, 3) f32;
// log_eps: f32(log(transmittance_eps)); mode: 0 "default", 1 "high",
// 2 "highest" (composite="mxu"), 3 composite="hybrid"
int ws_rasterize_mxu(const uint32_t* words, int64_t stride, const int* ranges,
                     const float* bg_host, float* out, int width, int height, int tile_w,
                     int tile_h, int tx_tiles, float log_eps, float margin, float scale_x,
                     float scale_y, int mode, void* stream) {
  const int n_pix = tile_w * tile_h;
  if (n_pix % 128 != 0 || n_pix > ws::MXU_MAX_PIX) return (int)cudaErrorInvalidValue;
  ws::MxuParams p{width, height, tile_w, tile_h, tx_tiles, log_eps,
                  {bg_host[0], bg_host[1], bg_host[2]}, ws::CenterQuant{margin, scale_x, scale_y}};
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
