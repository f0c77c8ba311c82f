"""Packed 16-byte splat record (4 x u32) carried through the sort.

Counterpart of ``websplat_tpu/ops/packing.py``; the field layout and every
codec are the same integer algorithms, so both packages produce the same
bits from the same f32 values:

  w0: center x | center y           (u16 fixed point, CenterQuant)
  w1: A = e5m12(0.5*conic_xx*1024) (17b) | low 15 bits of C = e5m12(0.5*conic_yy*1024)
  w2: high 2 bits of C | rho16 (fixed-point correlation) | op12 (sqrt code)
  w3: color r g b                   (RGB9E5 shared exponent, bias 15)

torch has no general 32-bit unsigned arithmetic, so the codecs compute on
int64 tensors that hold u32 values (``u32``), and streams are STORED as
int32 tensors carrying the same bit patterns (``to_i32``), which is also
the layout the CUDA kernels read as ``uint32_t*``.  The same codecs exist in
C++ for the kernels: ``websplat_tpu_torch/csrc/packing.cuh``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INVALID_KEY = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor (int32 bit storage or int64) -> int64 u32 values."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same 32-bit patterns."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 holding its u32 bit pattern (bitcast)."""
    return u32(x.to(torch.float32).contiguous().view(torch.int32))


def bits_f32(b: torch.Tensor) -> torch.Tensor:
    """int64 u32 bit pattern -> f32 (bitcast)."""
    return to_i32(b).view(torch.float32)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true IEEE division.  A plain ``x / c`` with a Python
    divisor is computed as ``x * (1/c)`` on CUDA tensors, which would round
    differently from the kernels (and from the CPU)."""
    return x / torch.full_like(x, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  torch's vectorized CPU sqrt is
    not (it differs from IEEE sqrt in ~0.6% of f32 inputs); the f64 root
    rounded to f32 is, and equals CUDA's ``sqrtf``."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _shr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_right_shift(x, s)


def _rtne_encode(x, cap: float, mbits: int, e_norm: int, e_sub_min: int, sub_shift: int):
    """Shared RTNE body of the f16 (mbits=10) and e5m12 (mbits=12) encoders:
    |x| clamped to ``cap`` -> biased-exponent-15 minifloat bits."""
    xa = torch.minimum(torch.abs(x.to(torch.float32)), torch.full_like(x, cap, dtype=torch.float32))
    bits = f32_bits(xa)
    e = bits >> 23
    m = bits & 0x7FFFFF
    drop = 23 - mbits
    base = ((e - 112) << mbits) | (m >> drop)
    r = m & ((1 << drop) - 1)
    half = 1 << (drop - 1)
    inc_n = (r > half) | ((r == half) & (((m >> drop) & 1) == 1))
    norm = base + inc_n.to(torch.int64)

    mf = m | 0x800000
    s = torch.clamp(sub_shift - e, 1, 31)
    kept = _shr(mf, s)
    rbit = _shr(mf, s - 1) & 1
    low_mask = torch.bitwise_left_shift(torch.ones_like(mf), s - 1) - 1
    sticky = (mf & low_mask) != 0
    inc_s = (rbit == 1) & (sticky | ((kept & 1) == 1))
    sub = kept + inc_s.to(torch.int64)
    zero = torch.zeros_like(sub)
    return torch.where(e >= e_norm, norm, torch.where(e >= e_sub_min, sub, zero)) & MASK32


def f32_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 with the f16 bit pattern in the low 16 bits: integer
    round-to-nearest-even; values above 65504 clamp to the f16 max instead
    of rounding to inf (packing.py:39)."""
    sign = (f32_bits(x) >> 16) & 0x8000
    return sign | _rtne_encode(x, 65504.0, 10, 113, 102, 126)


def f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """low 16 bits (f16 pattern) -> f32, exact incl. subnormals."""
    h = bits & 0xFFFF
    sign_mask = torch.where((h & 0x8000) != 0, -1.0, 1.0).to(torch.float32)
    exp = (h >> 10) & 0x1F
    man = h & 0x3FF
    normal = bits_f32(((h & 0x8000) << 16) | ((exp + 112) << 23) | (man << 13))
    sub = sign_mask * man.to(torch.float32) * 5.9604645e-8
    return torch.where(exp == 0, sub, normal)


E5M12_MAX = 65528.0  # (2 - 2^-12) * 2^15


def f32_to_e5m12_bits(x: torch.Tensor) -> torch.Tensor:
    """|x| -> int64 with the unsigned e5m12 pattern (17 bits), RTNE."""
    return _rtne_encode(x, E5M12_MAX, 12, 113, 100, 124)


def e5m12_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    h = bits & 0x1FFFF
    exp = (h >> 12) & 0x1F
    man = h & 0xFFF
    normal = bits_f32(((exp + 112) << 23) | (man << 11))
    sub = man.to(torch.float32) * 1.4901161e-8  # man * 2^-26
    return torch.where(exp == 0, sub, normal)


OP12_SCALE = 4095.0
INV_OP12_SCALE = float(np.float32(1.0 / 4095.0))


def f32_to_op12_bits(op: torch.Tensor) -> torch.Tensor:
    u = torch.round(sqrt(torch.clamp(op, 0.0, 1.0)) * OP12_SCALE)
    return u.to(torch.int32).to(torch.int64)


def op12_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    s = (bits & 0xFFF).to(torch.float32) * INV_OP12_SCALE
    return s * s


class CenterQuant(NamedTuple):
    """Fixed-point parameters of the u16 splat-center encoding."""

    margin: float
    scale_x: float  # quantized = (px + margin) * scale
    scale_y: float

    @classmethod
    def for_viewport(cls, width: int, height: int) -> "CenterQuant":
        margin = 0.125 * max(width, height) + 64.0
        return cls(
            margin=margin,
            scale_x=65535.0 / (width + 2.0 * margin),
            scale_y=65535.0 / (height + 2.0 * margin),
        )


def pack_center(px, py, q: CenterQuant) -> torch.Tensor:
    qx = torch.clamp(torch.round((px + q.margin) * q.scale_x), 0, 65535).to(torch.int64)
    qy = torch.clamp(torch.round((py + q.margin) * q.scale_y), 0, 65535).to(torch.int64)
    return (qx & 0xFFFF) | ((qy & 0xFFFF) << 16)


def unpack_center(w0, q: CenterQuant) -> Tuple[torch.Tensor, torch.Tensor]:
    px = div((w0 & 0xFFFF).to(torch.float32), q.scale_x) - q.margin
    py = div((w0 >> 16).to(torch.float32), q.scale_y) - q.margin
    return px, py


RGB9E5_MAX = 65408.0  # (511/512) * 2^(31-15)


def pack_rgb9e5(r, g, b) -> torch.Tensor:
    """Three non-negative f32 channels -> r | g<<9 | b<<18 | e<<27."""
    r = torch.clamp(r, 0.0, RGB9E5_MAX)
    g = torch.clamp(g, 0.0, RGB9E5_MAX)
    b = torch.clamp(b, 0.0, RGB9E5_MAX)
    maxc = torch.maximum(torch.maximum(r, g), b)
    bits = f32_bits(torch.clamp(maxc, min=1e-30))
    floor_log2 = (bits >> 23) - 127
    exp_shared = torch.clamp(floor_log2 + 16, 0, 31)
    scale = bits_f32((exp_shared + 103) << 23)
    inv = torch.reciprocal(scale)  # exact: scale is a power of two
    mr = torch.clamp(torch.round(r * inv), 0, 511).to(torch.int64)
    mg = torch.clamp(torch.round(g * inv), 0, 511).to(torch.int64)
    mb = torch.clamp(torch.round(b * inv), 0, 511).to(torch.int64)
    return mr | (mg << 9) | (mb << 18) | (exp_shared << 27)


def unpack_rgb9e5(w) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    scale = bits_f32(((w >> 27) + 103) << 23)
    r = (w & 0x1FF).to(torch.float32) * scale
    g = ((w >> 9) & 0x1FF).to(torch.float32) * scale
    b = ((w >> 18) & 0x1FF).to(torch.float32) * scale
    return r, g, b


CONIC_SCALE = 1024.0
INV_CONIC_SCALE = 1.0 / CONIC_SCALE
RHO_SCALE = 65535.0
RHO_DECODE = float(np.float32(1.0 - 2.0 ** -15))
RHO_STEP = float(np.float32(2.0 / 65535.0))


def f32_to_rho16_bits(rho) -> torch.Tensor:
    u = torch.round((torch.clamp(rho, -1.0, 1.0) + 1.0) * (0.5 * RHO_SCALE))
    return u.to(torch.int32).to(torch.int64)


def rho16_bits_to_f32(bits) -> torch.Tensor:
    u = (bits & 0xFFFF).to(torch.float32)
    return (u * RHO_STEP - 1.0) * RHO_DECODE


def pack_record(px, py, half_a, b, half_c, opacity, rgb, q: CenterQuant):
    """-> 4 int64 u32 words (packing.py:320)."""
    w0 = pack_center(px, py, q)
    A = f32_to_e5m12_bits(half_a * CONIC_SCALE)
    C = f32_to_e5m12_bits(half_c * CONIC_SCALE)
    a_dec = e5m12_bits_to_f32(A)
    c_dec = e5m12_bits_to_f32(C)
    denom = 2.0 * sqrt(a_dec * c_dec) * INV_CONIC_SCALE
    rho = b / torch.clamp(denom, min=1e-30)
    RHO = f32_to_rho16_bits(rho)
    OP = f32_to_op12_bits(opacity)
    w1 = A | ((C & 0x7FFF) << 17)
    w2 = (C >> 15) | (RHO << 2) | (OP << 18)
    w3 = pack_rgb9e5(rgb[0], rgb[1], rgb[2])
    return w0, w1, w2, w3


def unpack_record(w0, w1, w2, w3, q: CenterQuant):
    """int64 u32 words -> (px, py, half_a, b, half_c, opacity, r, g, b_col)."""
    px, py = unpack_center(w0, q)
    A = w1 & 0x1FFFF
    C = (w1 >> 17) | ((w2 & 0x3) << 15)
    half_a = e5m12_bits_to_f32(A) * INV_CONIC_SCALE
    half_c = e5m12_bits_to_f32(C) * INV_CONIC_SCALE
    rho = rho16_bits_to_f32(w2 >> 2)
    bb = rho * 2.0 * sqrt(half_a * half_c)
    opacity = op12_bits_to_f32(w2 >> 18)
    r, g, b_col = unpack_rgb9e5(w3)
    return px, py, half_a, bb, half_c, opacity, r, g, b_col
