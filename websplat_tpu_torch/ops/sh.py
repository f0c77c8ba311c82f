"""Spherical-harmonics color evaluation (deg <= 3, Condon-Shortley phase).

Counterpart of ``websplat_tpu/ops/sh.py`` (web-splat preprocess.wgsl:
114-154): every band is evaluated and masked by ``max_sh_deg``.  The CUDA
frontend evaluates the same sums in the same order
(``websplat_tpu_torch/csrc/core_math.cuh``).
"""

from __future__ import annotations

import torch

from websplat_tpu_torch.ops.packing import f16_bits_to_f32, u32

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh: torch.Tensor, x, y, z, max_sh_deg: int):
    """sh: (24, N) int32 rows of packed f16 pairs (coefficient 2p in the low
    half of row p, 2p+1 in the high half; flat index k = 3*coef + channel).
    x, y, z: (N,) unit view direction.  Returns 3 (N,) channels including
    the reference's +0.5 offset; clamping to >= 0 is the caller's."""

    def coef(k):
        row = u32(sh[k // 2])
        return f16_bits_to_f32(row if k % 2 == 0 else row >> 16)

    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    g1 = 1.0 if max_sh_deg > 0 else 0.0
    g2 = 1.0 if max_sh_deg > 1 else 0.0
    g3 = 1.0 if max_sh_deg > 2 else 0.0
    basis = [
        torch.full_like(x, SH_C0),
        g1 * (-SH_C1) * y,
        g1 * SH_C1 * z,
        g1 * (-SH_C1) * x,
        g2 * SH_C2[0] * xy,
        g2 * SH_C2[1] * yz,
        g2 * SH_C2[2] * (2.0 * zz - xx - yy),
        g2 * SH_C2[3] * xz,
        g2 * SH_C2[4] * (xx - yy),
        g3 * SH_C3[0] * y * (3.0 * xx - yy),
        g3 * SH_C3[1] * xy * z,
        g3 * SH_C3[2] * y * (4.0 * zz - xx - yy),
        g3 * SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        g3 * SH_C3[4] * x * (4.0 * zz - xx - yy),
        g3 * SH_C3[5] * z * (xx - yy),
        g3 * SH_C3[6] * x * (xx - 3.0 * yy),
    ]
    channels = []
    for ch in range(3):
        acc = basis[0] * coef(ch)
        for c in range(1, 16):
            acc = acc + basis[c] * coef(3 * c + ch)
        channels.append(acc + 0.5)
    return tuple(channels)
