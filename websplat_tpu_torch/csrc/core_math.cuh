// Per-splat preprocess math for the CUDA frontend.
//
// Written from websplat_tpu/ops/preprocess.py:142-427 (core_math) and its
// plain PyTorch twin websplat_tpu_torch/ops/preprocess.py:core_math: the
// same expressions in the same operand order (nvcc must not contract them:
// -fmad=false), square roots correctly rounded (sqrtf), logarithms in f64
// rounded to f32, true divisions.  Uncompressed clouds only.
#pragma once

#include "packing.cuh"

namespace ws {

constexpr int N_SCALARS = 52;  // preprocess.py FrameScalars.block()

struct FrameParams {
  float view[16], proj[16], cam_pos[3], focal[2];
  float cb_min[3], cb_max[3], center[3];
  float scaling, kernel, walltime, extend;
  int mip, max_sh_deg;
  int width, height, ts_x, ts_y, tx_tiles, ty_tiles, depth_bits, slots;
  float thr, inv_thr;  // alpha_threshold and f32(1/alpha_threshold); 0 = off
  CenterQuant cq;
};

// fills the camera/settings part from the (52,) f32 block
inline void frame_params_from_block(const float* s, FrameParams& p) {
  for (int i = 0; i < 16; ++i) p.view[i] = s[i];
  for (int i = 0; i < 16; ++i) p.proj[i] = s[16 + i];
  for (int i = 0; i < 3; ++i) p.cam_pos[i] = s[32 + i];
  p.focal[0] = s[35];
  p.focal[1] = s[36];
  for (int i = 0; i < 3; ++i) {
    p.cb_min[i] = s[37 + i];
    p.cb_max[i] = s[40 + i];
    p.center[i] = s[43 + i];
  }
  p.scaling = s[46];
  p.kernel = s[47];
  p.walltime = s[48];
  p.extend = s[49];
  p.mip = s[50] > 0.5f;
  p.max_sh_deg = (int)s[51];
}

struct Splat {
  bool visible;
  uint32_t depth_q;
  uint32_t w[4];
  int tx0, ty0, tx1, ty1, w_t, h_t, n_rect;
  Reach reach;  // unquantized values: the frontend's reach test
};

constexpr float SH_C0 = (float)0.28209479177387814;
constexpr float SH_C1 = (float)0.4886025119029199;
constexpr float SH_C2_0 = (float)1.0925484305920792;
constexpr float SH_C2_1 = (float)-1.0925484305920792;
constexpr float SH_C2_2 = (float)0.31539156525252005;
constexpr float SH_C2_3 = (float)-1.0925484305920792;
constexpr float SH_C2_4 = (float)0.5462742152960396;
constexpr float SH_C3_0 = (float)-0.5900435899266435;
constexpr float SH_C3_1 = (float)2.890611442640554;
constexpr float SH_C3_2 = (float)-0.4570457994644658;
constexpr float SH_C3_3 = (float)0.3731763325901154;
constexpr float SH_C3_4 = (float)-0.4570457994644658;
constexpr float SH_C3_5 = (float)1.445305721320277;
constexpr float SH_C3_6 = (float)-0.5900435899266435;

// SH color (ops/sh.py eval_sh): coefficient k = 3*coef + channel is the
// f16 in half (k % 2) of word k / 2.  Bands above max_sh_deg are skipped,
// which equals the plain version's multiply-by-zero masking.
__device__ __forceinline__ void eval_sh(const uint32_t sh[24], float x, float y, float z,
                                        int deg, float rgb[3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  float basis[16];
  basis[0] = SH_C0;
  const int nb = deg > 2 ? 16 : (deg > 1 ? 9 : (deg > 0 ? 4 : 1));
  if (deg > 0) {
    basis[1] = -SH_C1 * y;
    basis[2] = SH_C1 * z;
    basis[3] = -SH_C1 * x;
  }
  if (deg > 1) {
    basis[4] = SH_C2_0 * xy;
    basis[5] = SH_C2_1 * yz;
    basis[6] = SH_C2_2 * (2.0f * zz - xx - yy);
    basis[7] = SH_C2_3 * xz;
    basis[8] = SH_C2_4 * (xx - yy);
  }
  if (deg > 2) {
    basis[9] = SH_C3_0 * y * (3.0f * xx - yy);
    basis[10] = SH_C3_1 * xy * z;
    basis[11] = SH_C3_2 * y * (4.0f * zz - xx - yy);
    basis[12] = SH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    basis[13] = SH_C3_4 * x * (4.0f * zz - xx - yy);
    basis[14] = SH_C3_5 * z * (xx - yy);
    basis[15] = SH_C3_6 * x * (xx - 3.0f * yy);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * f16_bits_to_f32(sh[ch / 2] >> (16 * (ch % 2)));
    for (int c = 1; c < nb; ++c) {
      const int k = 3 * c + ch;
      acc = acc + basis[c] * f16_bits_to_f32(sh[k / 2] >> (16 * (k % 2)));
    }
    rgb[ch] = acc + 0.5f;
  }
}

__device__ __forceinline__ float smoothstep01(float x) {
  const float t = pclip(x, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ Splat core_math(float x_w, float y_w, float z_w, const float cov6[6],
                                           float opacity, const uint32_t sh[24],
                                           const FrameParams& p) {
  Splat out;
  const float* v = p.view;
  const float* m = p.proj;
  const bool inside = (x_w >= p.cb_min[0]) && (x_w <= p.cb_max[0]) && (y_w >= p.cb_min[1]) &&
                      (y_w <= p.cb_max[1]) && (z_w >= p.cb_min[2]) && (z_w <= p.cb_max[2]);
  const float cam_x = v[0] * x_w + v[1] * y_w + v[2] * z_w + v[3];
  const float cam_y = v[4] * x_w + v[5] * y_w + v[6] * z_w + v[7];
  const float cam_z = v[8] * x_w + v[9] * y_w + v[10] * z_w + v[11];
  const float clip_x = m[0] * cam_x + m[1] * cam_y + m[2] * cam_z + m[3];
  const float clip_y = m[4] * cam_x + m[5] * cam_y + m[6] * cam_z + m[7];
  const float clip_z = m[8] * cam_x + m[9] * cam_y + m[10] * cam_z + m[11];
  const float clip_w = m[12] * cam_x + m[13] * cam_y + m[14] * cam_z + m[15];
  const float bounds = 1.2f * clip_w;
  const float z_ndc = clip_z / clip_w;
  bool visible = (z_ndc > 0.0f) && (z_ndc < 1.0f) && (clip_x >= -bounds) &&
                 (clip_x <= bounds) && (clip_y >= -bounds) && (clip_y <= bounds) && inside;

  // walltime grow-in (preprocess.wgsl:196-203)
  const float dcx = x_w - p.center[0], dcy = y_w - p.center[1], dcz = z_w - p.center[2];
  const float dd = 5.0f * sqrtf(dcx * dcx + dcy * dcy + dcz * dcz) / p.extend;
  const float scale_mod = p.walltime > dd ? smoothstep01(p.walltime - dd) : 0.0f;
  const float scaling = p.scaling * scale_mod;

  // EWA projection (preprocess.wgsl:204-223)
  const float sc2 = scaling * scaling;
  const float s0 = cov6[0] * sc2, s1 = cov6[1] * sc2, s2 = cov6[2] * sc2;
  const float s3 = cov6[3] * sc2, s4 = cov6[4] * sc2, s5 = cov6[5] * sc2;
  const float fx = p.focal[0], fy = p.focal[1];
  const float inv_z = 1.0f / cam_z;
  const float j00 = fx * inv_z, j02 = -fx * cam_x * inv_z * inv_z;
  const float j11 = -fy * inv_z, j12 = fy * cam_y * inv_z * inv_z;
  const float a0 = j00 * v[0] + j02 * v[8];
  const float a1 = j00 * v[1] + j02 * v[9];
  const float a2 = j00 * v[2] + j02 * v[10];
  const float b0 = j11 * v[4] + j12 * v[8];
  const float b1 = j11 * v[5] + j12 * v[9];
  const float b2 = j11 * v[6] + j12 * v[10];
  const float sa0 = s0 * a0 + s1 * a1 + s2 * a2;
  const float sa1 = s1 * a0 + s3 * a1 + s4 * a2;
  const float sa2 = s2 * a0 + s4 * a1 + s5 * a2;
  const float sb0 = s0 * b0 + s1 * b1 + s2 * b2;
  const float sb1 = s1 * b0 + s3 * b1 + s4 * b2;
  const float sb2 = s2 * b0 + s4 * b1 + s5 * b2;
  const float cxx = a0 * sa0 + a1 * sa1 + a2 * sa2;
  const float cxy = b0 * sa0 + b1 * sa1 + b2 * sa2;
  const float cyy = b0 * sb0 + b1 * sb1 + b2 * sb2;

  // mip-splatting opacity correction (preprocess.wgsl:226-236)
  const float kernel = p.kernel;
  if (p.mip) {
    const float det0 = pmax(cxx * cyy - cxy * cxy, 1e-6f);
    const float det1 = pmax((cxx + kernel) * (cyy + kernel) - cxy * cxy, 1e-6f);
    float coef = sqrtf(det0 / (det1 + 1e-6f) + 1e-6f);
    if (det0 <= 1e-6f || det1 <= 1e-6f) coef = 0.0f;
    opacity = opacity * coef;
  }

  // dilation + eigen decomposition (preprocess.wgsl:238-251), pixel frame
  const float diag1 = cxx + kernel;
  const float diag2 = cyy + kernel;
  const float off = -cxy;
  const float mid = 0.5f * (diag1 + diag2);
  const float half_d = (diag1 - diag2) / 2.0f;
  const float radius = sqrtf(half_d * half_d + off * off);
  const float lambda1 = mid + radius;
  const float lambda2 = pmax(mid - radius, 0.1f);
  visible = visible && (lambda2 > 0.0f);

  const float ev0 = off, ev1 = lambda1 - diag1;
  const float ev_norm = sqrtf(ev0 * ev0 + ev1 * ev1);
  const bool nz = ev_norm > 1e-20f;
  const float inv_n = 1.0f / pmax(ev_norm, 1e-30f);
  const float e1x = nz ? ev0 * inv_n : 1.0f;
  const float e1y = nz ? ev1 * inv_n : 0.0f;

  const float inv_l1 = 1.0f / lambda1;
  const float inv_l2 = 1.0f / lambda2;
  const float conic_a = e1x * e1x * inv_l1 + e1y * e1y * inv_l2;
  const float conic_b = e1x * e1y * (inv_l1 - inv_l2);
  const float conic_c = e1y * e1y * inv_l1 + e1x * e1x * inv_l2;

  // alpha-aware bound level (RasterConfig.alpha_threshold)
  const float a_max = alpha_bound(opacity, p.inv_thr);
  if (p.inv_thr > 0.0f) visible = visible && (opacity > p.thr);

  const float sig_xx = lambda1 * e1x * e1x + lambda2 * e1y * e1y;
  const float sig_yy = lambda1 * e1y * e1y + lambda2 * e1x * e1x;
  const float a_max_pos = pmax(a_max, 0.0f);
  const float ext_x = sqrtf(2.0f * a_max_pos * pmax(sig_xx, 0.0f));
  const float ext_y = sqrtf(2.0f * a_max_pos * pmax(sig_yy, 0.0f));

  const float ndc_x = clip_x / clip_w;
  const float ndc_y = clip_y / clip_w;
  const float px = (ndc_x + 1.0f) * 0.5f * (float)p.width;
  const float py = (1.0f - ndc_y) * 0.5f * (float)p.height;

  // SH color (preprocess.wgsl:255-260)
  const float dvx = x_w - p.cam_pos[0], dvy = y_w - p.cam_pos[1], dvz = z_w - p.cam_pos[2];
  const float inv_dn = 1.0f / pmax(sqrtf(dvx * dvx + dvy * dvy + dvz * dvz), 1e-12f);
  float rgb[3];
  eval_sh(sh, dvx * inv_dn, dvy * inv_dn, dvz * inv_dn, p.max_sh_deg, rgb);
  for (int c = 0; c < 3; ++c) rgb[c] = pmax(rgb[c], 0.0f);

  // depth key: top depth_bits of the non-negative clip-z bits
  out.depth_q = f2u(pmax(clip_z, 0.0f)) >> (32 - p.depth_bits);

  // tile rect
  const float rx0 = floorf((px - ext_x) / (float)p.ts_x);
  const float rx1 = floorf((px + ext_x) / (float)p.ts_x);
  const float ry0 = floorf((py - ext_y) / (float)p.ts_y);
  const float ry1 = floorf((py + ext_y) / (float)p.ts_y);
  const bool on_screen = (rx1 >= 0.0f) && (rx0 < (float)p.tx_tiles) && (ry1 >= 0.0f) &&
                         (ry0 < (float)p.ty_tiles);
  visible = visible && on_screen;
  out.tx0 = (int)pclip(rx0, 0.0f, (float)(p.tx_tiles - 1));
  out.tx1 = (int)pclip(rx1, 0.0f, (float)(p.tx_tiles - 1));
  out.ty0 = (int)pclip(ry0, 0.0f, (float)(p.ty_tiles - 1));
  out.ty1 = (int)pclip(ry1, 0.0f, (float)(p.ty_tiles - 1));
  out.w_t = max(out.tx1 - out.tx0 + 1, 1);
  out.h_t = max(out.ty1 - out.ty0 + 1, 1);
  out.n_rect = out.w_t * out.h_t;

  const float half_a = 0.5f * conic_a;
  const float half_c = 0.5f * conic_c;
  pack_record(px, py, half_a, conic_b, half_c, opacity, rgb[0], rgb[1], rgb[2], p.cq, out.w);
  out.reach = Reach{px, py, half_a, conic_b, half_c, a_max};
  out.visible = visible;
  return out;
}

}  // namespace ws
