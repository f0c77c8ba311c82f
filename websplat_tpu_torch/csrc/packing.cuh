// Integer codecs of the packed 16-byte splat record, for the CUDA kernels.
//
// Written from websplat_tpu/ops/packing.py (and its torch twin,
// websplat_tpu_torch/ops/packing.py): the same integer algorithms, so the
// kernels produce and read the same bits as both Python versions.
//   w0: center x | center y (u16 fixed point, CenterQuant)
//   w1: A = e5m12(0.5*conic_xx*1024) (17 bits) | C low 15 bits << 17
//   w2: C high 2 bits | rho16 << 2 | op12 << 18
//   w3: rgb9e5 (9-bit mantissas, shared 5-bit exponent, bias 15)
// Compile with -fmad=false and without --use_fast_math (kernels/build.py):
// the float steps below must round exactly like the plain versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ws {

constexpr uint32_t INVALID_KEY = 0xFFFFFFFFu;
constexpr float CUTOFF2 = (float)(2.0 * 2.3539888583335364);  // 2 * sqrt(log(255))
constexpr float CONIC_SCALE = 1024.0f;
constexpr float INV_CONIC_SCALE = 1.0f / 1024.0f;

// Python-side float constants, as the f32 values the Python code uses
constexpr float INV_OP12_SCALE = (float)(1.0 / 4095.0);
constexpr float RHO_STEP = (float)(2.0 / 65535.0);
constexpr float RHO_DECODE = (float)(1.0 - 1.0 / 32768.0);
constexpr float F16_SUB = 5.9604645e-8f;           // 2^-24
constexpr float E5M12_SUB = 1.4901161e-8f;         // 2^-26

struct CenterQuant {
  float margin, scale_x, scale_y;
};

__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }
__device__ __forceinline__ float u2f(uint32_t b) { return __uint_as_float(b); }

// NaN-propagating min/max/clip: jnp.minimum / torch.minimum semantics
__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float pclip(float x, float lo, float hi) {
  return pmin(pmax(x, lo), hi);
}

// Shared RTNE encoder of the f16 (MB=10) and e5m12 (MB=12) minifloats
// (packing.py f32_to_f16_bits / f32_to_e5m12_bits).
template <int MB, int E_SUB_MIN, int SUB_SHIFT>
__device__ __forceinline__ uint32_t rtne_encode(float x, float cap) {
  const float xa = pmin(fabsf(x), cap);
  const uint32_t bits = f2u(xa);
  const int e = (int)(bits >> 23);
  const uint32_t m = bits & 0x7FFFFFu;
  constexpr int DROP = 23 - MB;
  constexpr uint32_t HALF = 1u << (DROP - 1);
  if (e >= 113) {
    const uint32_t base = ((uint32_t)(e - 112) << MB) | (m >> DROP);
    const uint32_t r = m & ((1u << DROP) - 1u);
    const bool inc = (r > HALF) || (r == HALF && ((m >> DROP) & 1u));
    return base + (inc ? 1u : 0u);
  }
  if (e >= E_SUB_MIN) {
    const uint32_t mf = m | 0x800000u;
    int s = SUB_SHIFT - e;
    s = s < 1 ? 1 : (s > 31 ? 31 : s);
    const uint32_t kept = mf >> s;
    const uint32_t rbit = (mf >> (s - 1)) & 1u;
    const bool sticky = (mf & ((1u << (s - 1)) - 1u)) != 0u;
    const bool inc = rbit && (sticky || (kept & 1u));
    return kept + (inc ? 1u : 0u);
  }
  return 0u;
}

__device__ __forceinline__ uint32_t f32_to_f16_bits(float x) {
  const uint32_t sign = (f2u(x) >> 16) & 0x8000u;
  return sign | rtne_encode<10, 102, 126>(x, 65504.0f);
}

__device__ __forceinline__ float f16_bits_to_f32(uint32_t bits) {
  const uint32_t h = bits & 0xFFFFu;
  const uint32_t exp = (h >> 10) & 0x1Fu;
  const uint32_t man = h & 0x3FFu;
  if (exp == 0u) {
    const float sign = (h & 0x8000u) ? -1.0f : 1.0f;
    return sign * (float)man * F16_SUB;
  }
  return u2f(((h & 0x8000u) << 16) | ((exp + 112u) << 23) | (man << 13));
}

__device__ __forceinline__ uint32_t f32_to_e5m12_bits(float x) {
  return rtne_encode<12, 100, 124>(x, 65528.0f);
}

__device__ __forceinline__ float e5m12_bits_to_f32(uint32_t bits) {
  const uint32_t h = bits & 0x1FFFFu;
  const uint32_t exp = (h >> 12) & 0x1Fu;
  const uint32_t man = h & 0xFFFu;
  if (exp == 0u) return (float)man * E5M12_SUB;
  return u2f(((exp + 112u) << 23) | (man << 11));
}

__device__ __forceinline__ uint32_t f32_to_op12_bits(float op) {
  const float u = rintf(sqrtf(pclip(op, 0.0f, 1.0f)) * 4095.0f);
  return (uint32_t)(int)u;
}

__device__ __forceinline__ float op12_bits_to_f32(uint32_t bits) {
  const float s = (float)(bits & 0xFFFu) * INV_OP12_SCALE;
  return s * s;
}

__device__ __forceinline__ uint32_t f32_to_rho16_bits(float rho) {
  const float u = rintf((pclip(rho, -1.0f, 1.0f) + 1.0f) * 32767.5f);
  return (uint32_t)(int)u;
}

__device__ __forceinline__ float rho16_bits_to_f32(uint32_t bits) {
  const float u = (float)(bits & 0xFFFFu);
  return (u * RHO_STEP - 1.0f) * RHO_DECODE;
}

__device__ __forceinline__ uint32_t pack_center(float px, float py, const CenterQuant& q) {
  const float qx = pclip(rintf((px + q.margin) * q.scale_x), 0.0f, 65535.0f);
  const float qy = pclip(rintf((py + q.margin) * q.scale_y), 0.0f, 65535.0f);
  return ((uint32_t)(int)qx & 0xFFFFu) | (((uint32_t)(int)qy & 0xFFFFu) << 16);
}

__device__ __forceinline__ void unpack_center(uint32_t w0, const CenterQuant& q, float& px,
                                              float& py) {
  px = (float)(w0 & 0xFFFFu) / q.scale_x - q.margin;
  py = (float)(w0 >> 16) / q.scale_y - q.margin;
}

__device__ __forceinline__ uint32_t pack_rgb9e5(float r, float g, float b) {
  r = pclip(r, 0.0f, 65408.0f);
  g = pclip(g, 0.0f, 65408.0f);
  b = pclip(b, 0.0f, 65408.0f);
  const float maxc = pmax(pmax(r, g), b);
  const int floor_log2 = (int)(f2u(pmax(maxc, 1e-30f)) >> 23) - 127;
  int e = floor_log2 + 16;
  e = e < 0 ? 0 : (e > 31 ? 31 : e);
  const float scale = u2f((uint32_t)(e + 103) << 23);
  const float inv = 1.0f / scale;  // exact: a power of two
  const float mr = pclip(rintf(r * inv), 0.0f, 511.0f);
  const float mg = pclip(rintf(g * inv), 0.0f, 511.0f);
  const float mb = pclip(rintf(b * inv), 0.0f, 511.0f);
  return (uint32_t)(int)mr | ((uint32_t)(int)mg << 9) | ((uint32_t)(int)mb << 18) |
         ((uint32_t)e << 27);
}

__device__ __forceinline__ void unpack_rgb9e5(uint32_t w, float& r, float& g, float& b) {
  const float scale = u2f(((w >> 27) + 103u) << 23);
  r = (float)(w & 0x1FFu) * scale;
  g = (float)((w >> 9) & 0x1FFu) * scale;
  b = (float)((w >> 18) & 0x1FFu) * scale;
}

struct Record {
  float px, py, ha, hb, hc, op, r, g, b;
};

__device__ __forceinline__ void pack_record(float px, float py, float half_a, float b,
                                            float half_c, float opacity, float cr, float cg,
                                            float cb, const CenterQuant& q, uint32_t w[4]) {
  w[0] = pack_center(px, py, q);
  const uint32_t A = f32_to_e5m12_bits(half_a * CONIC_SCALE);
  const uint32_t C = f32_to_e5m12_bits(half_c * CONIC_SCALE);
  const float a_dec = e5m12_bits_to_f32(A);
  const float c_dec = e5m12_bits_to_f32(C);
  const float denom = 2.0f * sqrtf(a_dec * c_dec) * INV_CONIC_SCALE;
  const float rho = b / pmax(denom, 1e-30f);
  const uint32_t RHO = f32_to_rho16_bits(rho);
  const uint32_t OP = f32_to_op12_bits(opacity);
  w[1] = A | ((C & 0x7FFFu) << 17);
  w[2] = (C >> 15) | (RHO << 2) | (OP << 18);
  w[3] = pack_rgb9e5(cr, cg, cb);
}

__device__ __forceinline__ Record unpack_record(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, const CenterQuant& q) {
  Record rec;
  unpack_center(w0, q, rec.px, rec.py);
  const uint32_t A = w1 & 0x1FFFFu;
  const uint32_t C = (w1 >> 17) | ((w2 & 0x3u) << 15);
  rec.ha = e5m12_bits_to_f32(A) * INV_CONIC_SCALE;
  rec.hc = e5m12_bits_to_f32(C) * INV_CONIC_SCALE;
  const float rho = rho16_bits_to_f32(w2 >> 2);
  rec.hb = rho * 2.0f * sqrtf(rec.ha * rec.hc);
  rec.op = op12_bits_to_f32(w2 >> 18);
  unpack_rgb9e5(w3, rec.r, rec.g, rec.b);
  return rec;
}

// a_max = min(2*CUTOFF, log(max(op, 1e-30) * inv_thr)), the log taken in f64
// and rounded (preprocess.py log32); inv_thr = f32(1/alpha_threshold), 0 when
// the alpha bound is off
__device__ __forceinline__ float alpha_bound(float op, float inv_thr) {
  if (inv_thr > 0.0f) {
    const float t = pmax(op, 1e-30f) * inv_thr;
    return pmin(CUTOFF2, (float)log((double)t));
  }
  return CUTOFF2;
}

// Ellipse-reaches-tile test (preprocess.py make_reaches): minimum of the
// convex quadratic form over the tile's pixel-center box vs a_max.
struct Reach {
  float px, py, ha, hb, hc, a_max;

  __device__ __forceinline__ float edge_x(float e, float y0, float y1) const {
    const float dy_s = pclip(-hb * e / pmax(2.0f * hc, 1e-20f), y0, y1);
    return ha * e * e + hb * e * dy_s + hc * dy_s * dy_s;
  }
  __device__ __forceinline__ float edge_y(float e, float x0, float x1) const {
    const float dx_s = pclip(-hb * e / pmax(2.0f * ha, 1e-20f), x0, x1);
    return ha * dx_s * dx_s + hb * dx_s * e + hc * e * e;
  }
  __device__ __forceinline__ bool reaches(int tx, int ty, int ts_x, int ts_y) const {
    const float bx0 = (float)tx * (float)ts_x + 0.5f - px;
    const float bx1 = bx0 + (float)(ts_x - 1);
    const float by0 = (float)ty * (float)ts_y + 0.5f - py;
    const float by1 = by0 + (float)(ts_y - 1);
    const bool inside = (bx0 <= 0.0f) && (0.0f <= bx1) && (by0 <= 0.0f) && (0.0f <= by1);
    const float best = pmin(pmin(edge_x(bx0, by0, by1), edge_x(bx1, by0, by1)),
                            pmin(edge_y(by0, bx0, bx1), edge_y(by1, bx0, bx1)));
    return (inside ? 0.0f : best) <= a_max;
  }
};

}  // namespace ws
