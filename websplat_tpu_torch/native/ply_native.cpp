// Native PLY vertex-stream decoder (the port's copy of
// websplat_tpu/native/ply_native.cpp, same C ABI).
//
// C++ port of the reference's per-point CPU hot loop
// (web-splat src/io/ply.rs:50-100): for each Gaussian, read position,
// skip normals, gather SH coefficients (DC + channel-first rest,
// transposed to coefficient-major), apply the stable sigmoid to opacity,
// exp to scales, normalize the quaternion, build the 3D covariance
// Sigma = (R S)(R S)^T and pack the upper six coefficients — all f16 on the
// wire like the reference (web-splat src/pointcloud.rs:38-45).
//
// Parallelized over points with std::thread; exposed through a plain C ABI
// for ctypes.
//
// Built at first use by websplat_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC -std=c++17 -o <lib> ply_native.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// portable f32 -> f16 (round-to-nearest-even), matching IEEE semantics of
// Rust's half::f16::from_f32
static inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    uint32_t man = x & 0x7FFFFFu;
    if (((x >> 23) & 0xFF) == 0xFF) {  // inf/nan
        return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0u));
    }
    if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;  // underflow -> 0
        // subnormal
        man |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = man >> shift;
        uint32_t rem = man & ((1u << shift) - 1);
        uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (half & 1))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = (uint32_t)(exp << 10) | (man >> 13);
    uint32_t rem = man & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
    return (uint16_t)(sign | half);
}

static inline float stable_sigmoid(float x) {
    // web-splat src/utils.rs:206-212
    if (x >= 0.0f) return 1.0f / (1.0f + std::exp(-x));
    float e = std::exp(x);
    return e / (1.0f + e);
}

static inline uint32_t bswap32(uint32_t v) {
    return ((v & 0xFFu) << 24) | ((v & 0xFF00u) << 8) | ((v >> 8) & 0xFF00u) |
           ((v >> 24) & 0xFFu);
}

struct Layout {
    int64_t stride_f32;   // floats per vertex record
    int64_t off_pos;      // field offsets in f32 units
    int64_t off_dc;
    int64_t off_rest;
    int64_t off_opacity;
    int64_t off_scale;
    int64_t off_rot;
    int64_t n_coefs;      // total SH coefficients (1..16)
    int64_t big_endian;
};

static void decode_range(const float* src, const Layout& L, int64_t i0, int64_t i1,
                         float* xyz, uint16_t* opacity, uint16_t* cov,
                         uint16_t* sh) {
    const int64_t C = L.n_coefs;
    std::vector<float> rec(L.stride_f32);
    for (int64_t i = i0; i < i1; i++) {
        const float* raw = src + i * L.stride_f32;
        const float* v = raw;
        if (L.big_endian) {
            for (int64_t k = 0; k < L.stride_f32; k++) {
                uint32_t u;
                std::memcpy(&u, raw + k, 4);
                u = bswap32(u);
                std::memcpy(&rec[k], &u, 4);
            }
            v = rec.data();
        }
        xyz[i * 3 + 0] = v[L.off_pos + 0];
        xyz[i * 3 + 1] = v[L.off_pos + 1];
        xyz[i * 3 + 2] = v[L.off_pos + 2];

        // SH: DC + channel-first rest -> coefficient-major (web-splat ply.rs:63-75)
        uint16_t* sh_out = sh + i * 16 * 3;
        for (int64_t k = 0; k < 16 * 3; k++) sh_out[k] = 0;
        for (int64_t j = 0; j < 3; j++) sh_out[j] = f32_to_f16(v[L.off_dc + j]);
        const int64_t rest = C - 1;
        for (int64_t c = 0; c < rest; c++)
            for (int64_t j = 0; j < 3; j++)
                sh_out[(c + 1) * 3 + j] = f32_to_f16(v[L.off_rest + j * rest + c]);

        opacity[i] = f32_to_f16(stable_sigmoid(v[L.off_opacity]));

        float sx = std::exp(v[L.off_scale + 0]);
        float sy = std::exp(v[L.off_scale + 1]);
        float sz = std::exp(v[L.off_scale + 2]);
        float qw = v[L.off_rot + 0], qx = v[L.off_rot + 1];
        float qy = v[L.off_rot + 2], qz = v[L.off_rot + 3];
        float qn = std::sqrt(qw * qw + qx * qx + qy * qy + qz * qz);
        if (qn > 0) { qw /= qn; qx /= qn; qy /= qn; qz /= qn; }

        // R from quaternion (Hamilton), L = R * diag(s), Sigma = L L^T
        float r00 = 1 - 2 * (qy * qy + qz * qz), r01 = 2 * (qx * qy - qw * qz),
              r02 = 2 * (qx * qz + qw * qy);
        float r10 = 2 * (qx * qy + qw * qz), r11 = 1 - 2 * (qx * qx + qz * qz),
              r12 = 2 * (qy * qz - qw * qx);
        float r20 = 2 * (qx * qz - qw * qy), r21 = 2 * (qy * qz + qw * qx),
              r22 = 1 - 2 * (qx * qx + qy * qy);
        float l00 = r00 * sx, l01 = r01 * sy, l02 = r02 * sz;
        float l10 = r10 * sx, l11 = r11 * sy, l12 = r12 * sz;
        float l20 = r20 * sx, l21 = r21 * sy, l22 = r22 * sz;
        float m00 = l00 * l00 + l01 * l01 + l02 * l02;
        float m01 = l00 * l10 + l01 * l11 + l02 * l12;
        float m02 = l00 * l20 + l01 * l21 + l02 * l22;
        float m11 = l10 * l10 + l11 * l11 + l12 * l12;
        float m12 = l10 * l20 + l11 * l21 + l12 * l22;
        float m22 = l20 * l20 + l21 * l21 + l22 * l22;
        uint16_t* c6 = cov + i * 6;
        c6[0] = f32_to_f16(m00);
        c6[1] = f32_to_f16(m01);
        c6[2] = f32_to_f16(m02);
        c6[3] = f32_to_f16(m11);
        c6[4] = f32_to_f16(m12);
        c6[5] = f32_to_f16(m22);
    }
}

}  // namespace

extern "C" {

// returns 0 on success
int websplat_decode_ply(const void* src, int64_t n_points, const Layout* layout,
                        float* xyz, uint16_t* opacity, uint16_t* cov,
                        uint16_t* sh, int n_threads) {
    if (!src || !layout || n_points < 0) return 1;
    const float* s = (const float*)src;
    if (n_threads <= 0)
        n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    n_threads = (int)std::min<int64_t>(n_threads, std::max<int64_t>(1, n_points / 4096) + 1);
    if (n_threads <= 1) {
        decode_range(s, *layout, 0, n_points, xyz, opacity, cov, sh);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_points + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t i0 = t * chunk;
        int64_t i1 = std::min<int64_t>(i0 + chunk, n_points);
        if (i0 >= i1) break;
        threads.emplace_back(decode_range, s, std::cref(*layout), i0, i1, xyz,
                             opacity, cov, sh);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
