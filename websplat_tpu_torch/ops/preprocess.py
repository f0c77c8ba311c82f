"""Per-splat preprocess math: 3D Gaussians -> screen-space splat records.

Counterpart of ``websplat_tpu/ops/preprocess.py`` (web-splat
preprocess.wgsl:163-280).  ``core_math`` is the plain PyTorch version of the
per-splat work the CUDA frontend does in ``csrc/core_math.cuh``: clipping-box
and 1.2*w frustum cull, grow-in animation, EWA projection, mip opacity
correction, dilation and eigen clamp, the alpha-aware reach bound, SH color,
the depth key and the tile rect.  Every expression keeps the JAX operand
order so the f32 roundings are the same.

Two numeric rules hold across the plain and kernel versions:
square roots are correctly rounded (``packing.sqrt``) and logarithms are
taken in f64 and rounded to f32 (``log32``), so the CPU, the plain CUDA
path and the kernels compute the same values.

Also here: the row-major slot walk of the frontend (``slot_tiles``), the
reach test rebuilt from decoded records (``make_reaches``, used by the
overflow walk), the rect4 codec and the dense extreme-tail grid
(``dense_grid_emit``, plain tensor code in both packages).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from websplat_tpu_torch.config import CUTOFF, RasterConfig, ResolvedSettings
from websplat_tpu_torch.ops import packing
from websplat_tpu_torch.ops.packing import div, sqrt, u32
from websplat_tpu_torch.ops.sh import eval_sh

N_SCALARS = 52  # length of FrameScalars.block()


class DeviceCloud(NamedTuple):
    """Device-resident cloud in the JAX package's column-major layout."""

    xyz: torch.Tensor  # (3, N) f32
    cov: torch.Tensor  # (6, N) f32 (decoded from the f16 wire format)
    opacity: torch.Tensor  # (N,) f32
    sh: torch.Tensor  # (24, N) int32: packed f16 coefficient pairs


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FrameScalars:
    """Camera block and resolved settings as f32-valued Python floats (the
    values JAX's camera_to_device / settings_to_device put on the device)."""

    view: Tuple[Tuple[float, ...], ...]
    proj: Tuple[Tuple[float, ...], ...]
    cam_pos: Tuple[float, float, float]
    focal: Tuple[float, float]
    cb_min: Tuple[float, float, float]
    cb_max: Tuple[float, float, float]
    center: Tuple[float, float, float]
    gaussian_scaling: float
    kernel: float
    walltime: float
    extend: float
    mip: bool
    max_sh_deg: int

    @classmethod
    def from_uniforms(cls, view, view_inv, proj, focal, settings: ResolvedSettings):
        """From a CameraUniforms' numpy fields (view, view_inv, proj, focal)
        and the resolved settings."""
        m = lambda a: tuple(tuple(_f32(a[i][j]) for j in range(4)) for i in range(4))
        t3 = lambda a: tuple(_f32(x) for x in a)
        return cls(
            view=m(np.asarray(view)),
            proj=m(np.asarray(proj)),
            cam_pos=tuple(_f32(np.asarray(view_inv)[i, 3]) for i in range(3)),
            focal=(_f32(focal[0]), _f32(focal[1])),
            cb_min=t3(settings.clipping_box_min),
            cb_max=t3(settings.clipping_box_max),
            center=t3(settings.scene_center),
            gaussian_scaling=_f32(settings.gaussian_scaling),
            kernel=_f32(settings.kernel_size),
            walltime=_f32(settings.walltime),
            extend=_f32(settings.scene_extend),
            mip=bool(settings.mip_splatting),
            max_sh_deg=int(settings.max_sh_deg),
        )

    def block(self) -> np.ndarray:
        """(52,) f32 in the layout of frontend_pallas.py:553-563 (view, proj,
        cam_pos, focal, cb_min, cb_max, center, scaling, kernel, walltime,
        extend, mip, max_sh_deg): what the CUDA frontend reads."""
        vals = [v for row in self.view for v in row]
        vals += [v for row in self.proj for v in row]
        vals += list(self.cam_pos) + list(self.focal)
        vals += list(self.cb_min) + list(self.cb_max) + list(self.center)
        vals += [
            self.gaussian_scaling, self.kernel, self.walltime, self.extend,
            1.0 if self.mip else 0.0, float(self.max_sh_deg),
        ]
        out = np.asarray(vals, np.float32)
        assert out.shape == (N_SCALARS,)
        return out


def log32(x: torch.Tensor) -> torch.Tensor:
    """f32 log taken in f64 and rounded (the kernels do the same)."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def alpha_bound(opacity: torch.Tensor, alpha_threshold: float) -> torch.Tensor:
    """a_max = min(2*CUTOFF, log(opacity / thr)): the quadratic-form level
    beyond which a splat contributes < thr to every pixel."""
    two_cut = torch.full_like(opacity, 2.0 * CUTOFF)
    if alpha_threshold > 0.0:
        t = torch.clamp(opacity, min=1e-30) * (1.0 / alpha_threshold)
        return torch.minimum(two_cut, log32(t))
    return two_cut


def _smoothstep01(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def core_math(cloud: DeviceCloud, fs: FrameScalars, *, width: int, height: int,
              config: RasterConfig):
    """The per-splat preprocess over (N,) tensors (preprocess.py:142,
    uncompressed clouds).  Returns a dict of per-splat tensors; record
    words are int64 u32 values."""
    ts_x, ts_y = config.tile_w, config.tile_h
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    cq = packing.CenterQuant.for_viewport(width, height)
    x_w, y_w, z_w = cloud.xyz[0], cloud.xyz[1], cloud.xyz[2]
    cov6 = [cloud.cov[i] for i in range(6)]

    cb_min, cb_max = fs.cb_min, fs.cb_max
    inside = (
        (x_w >= cb_min[0]) & (x_w <= cb_max[0])
        & (y_w >= cb_min[1]) & (y_w <= cb_max[1])
        & (z_w >= cb_min[2]) & (z_w <= cb_max[2])
    )

    def affine3(m, v0, v1, v2):
        return tuple(m[i][0] * v0 + m[i][1] * v1 + m[i][2] * v2 + m[i][3] for i in range(3))

    view, proj = fs.view, fs.proj
    cam_x, cam_y, cam_z = affine3(view, x_w, y_w, z_w)
    clip_x, clip_y, clip_z = affine3(proj, cam_x, cam_y, cam_z)
    clip_w = proj[3][0] * cam_x + proj[3][1] * cam_y + proj[3][2] * cam_z + proj[3][3]
    bounds = 1.2 * clip_w
    z_ndc = clip_z / clip_w
    visible = (
        (z_ndc > 0.0) & (z_ndc < 1.0)
        & (clip_x >= -bounds) & (clip_x <= bounds)
        & (clip_y >= -bounds) & (clip_y <= bounds)
        & inside
    )

    ctr = fs.center
    dcx, dcy, dcz = x_w - ctr[0], y_w - ctr[1], z_w - ctr[2]
    dd = div(5.0 * sqrt(dcx * dcx + dcy * dcy + dcz * dcz), fs.extend)
    scale_mod = torch.where(
        fs.walltime > dd, _smoothstep01(fs.walltime - dd), torch.zeros_like(dd)
    )
    scaling = fs.gaussian_scaling * scale_mod

    sc2 = scaling * scaling
    s0, s1, s2, s3, s4, s5 = (c * sc2 for c in cov6)
    fx, fy = fs.focal
    inv_z = 1.0 / cam_z
    j00, j02 = fx * inv_z, -fx * cam_x * inv_z * inv_z
    j11, j12 = -fy * inv_z, fy * cam_y * inv_z * inv_z
    v = view
    a0 = j00 * v[0][0] + j02 * v[2][0]
    a1 = j00 * v[0][1] + j02 * v[2][1]
    a2 = j00 * v[0][2] + j02 * v[2][2]
    b0 = j11 * v[1][0] + j12 * v[2][0]
    b1 = j11 * v[1][1] + j12 * v[2][1]
    b2 = j11 * v[1][2] + j12 * v[2][2]
    sa0 = s0 * a0 + s1 * a1 + s2 * a2
    sa1 = s1 * a0 + s3 * a1 + s4 * a2
    sa2 = s2 * a0 + s4 * a1 + s5 * a2
    sb0 = s0 * b0 + s1 * b1 + s2 * b2
    sb1 = s1 * b0 + s3 * b1 + s4 * b2
    sb2 = s2 * b0 + s4 * b1 + s5 * b2
    cxx = a0 * sa0 + a1 * sa1 + a2 * sa2
    cxy = b0 * sa0 + b1 * sa1 + b2 * sa2
    cyy = b0 * sb0 + b1 * sb1 + b2 * sb2

    opacity = cloud.opacity
    kernel = fs.kernel
    if fs.mip:
        det0 = torch.clamp(cxx * cyy - cxy * cxy, min=1e-6)
        det1 = torch.clamp((cxx + kernel) * (cyy + kernel) - cxy * cxy, min=1e-6)
        coef = sqrt(det0 / (det1 + 1e-6) + 1e-6)
        coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)
        opacity = opacity * coef

    diag1 = cxx + kernel
    diag2 = cyy + kernel
    off = -cxy
    mid = 0.5 * (diag1 + diag2)
    half_d = (diag1 - diag2) / 2.0
    radius = sqrt(half_d * half_d + off * off)
    lambda1 = mid + radius
    lambda2 = torch.clamp(mid - radius, min=0.1)
    visible = visible & (lambda2 > 0.0)

    ev0, ev1 = off, lambda1 - diag1
    ev_norm = sqrt(ev0 * ev0 + ev1 * ev1)
    nz = ev_norm > 1e-20
    inv_n = 1.0 / torch.clamp(ev_norm, min=1e-30)
    e1x = torch.where(nz, ev0 * inv_n, torch.ones_like(ev0))
    e1y = torch.where(nz, ev1 * inv_n, torch.zeros_like(ev1))

    inv_l1 = 1.0 / lambda1
    inv_l2 = 1.0 / lambda2
    conic_a = e1x * e1x * inv_l1 + e1y * e1y * inv_l2
    conic_b = e1x * e1y * (inv_l1 - inv_l2)
    conic_c = e1y * e1y * inv_l1 + e1x * e1x * inv_l2

    thr = float(config.alpha_threshold)
    a_max = alpha_bound(opacity, thr)
    if thr > 0.0:
        visible = visible & (opacity > thr)

    sig_xx = lambda1 * e1x * e1x + lambda2 * e1y * e1y
    sig_yy = lambda1 * e1y * e1y + lambda2 * e1x * e1x
    a_max_pos = torch.clamp(a_max, min=0.0)
    ext_x = sqrt(2.0 * a_max_pos * torch.clamp(sig_xx, min=0.0))
    ext_y = sqrt(2.0 * a_max_pos * torch.clamp(sig_yy, min=0.0))

    ndc_x = clip_x / clip_w
    ndc_y = clip_y / clip_w
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height

    cam_pos = fs.cam_pos
    dvx, dvy, dvz = x_w - cam_pos[0], y_w - cam_pos[1], z_w - cam_pos[2]
    inv_dn = 1.0 / torch.clamp(sqrt(dvx * dvx + dvy * dvy + dvz * dvz), min=1e-12)
    rgb = eval_sh(cloud.sh, dvx * inv_dn, dvy * inv_dn, dvz * inv_dn, fs.max_sh_deg)
    rgb = tuple(torch.clamp(c, min=0.0) for c in rgb)

    depth_q = packing.f32_bits(torch.clamp(clip_z, min=0.0)) >> (32 - depth_bits)

    rx0 = torch.floor((px - ext_x) / ts_x)
    rx1 = torch.floor((px + ext_x) / ts_x)
    ry0 = torch.floor((py - ext_y) / ts_y)
    ry1 = torch.floor((py + ext_y) / ts_y)
    on_screen = (rx1 >= 0) & (rx0 < tx_tiles) & (ry1 >= 0) & (ry0 < ty_tiles)
    visible = visible & on_screen
    tx0 = torch.clamp(rx0, 0, tx_tiles - 1).to(torch.int64)
    tx1 = torch.clamp(rx1, 0, tx_tiles - 1).to(torch.int64)
    ty0 = torch.clamp(ry0, 0, ty_tiles - 1).to(torch.int64)
    ty1 = torch.clamp(ry1, 0, ty_tiles - 1).to(torch.int64)
    w_t = torch.clamp(tx1 - tx0 + 1, min=1)
    h_t = torch.clamp(ty1 - ty0 + 1, min=1)

    half_a = 0.5 * conic_a
    half_c = 0.5 * conic_c
    words = packing.pack_record(px, py, half_a, conic_b, half_c, opacity, rgb, cq)
    return dict(
        visible=visible,
        depth_q=depth_q,
        words=words,
        tx0=tx0, ty0=ty0, tx1=tx1, ty1=ty1,
        w_t=w_t, h_t=h_t, n_rect=w_t * h_t,
        reach=(px, py, half_a, conic_b, half_c, a_max),
    )


def make_reaches(px, py, ha, hb, hc, a_max, ts_x: float, ts_y: float):
    """Ellipse-reaches-tile test from per-splat values (preprocess.py:694):
    the minimum of the convex quadratic form over the tile's pixel-center
    box against a_max.  Tile coords broadcast against the splat arrays."""

    def rect_min_a(x0, x1, y0, y1):
        inside_r = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)

        def edge_x(e):
            dy_s = torch.clamp(-hb * e / torch.clamp(2.0 * hc, min=1e-20), y0, y1)
            return ha * e * e + hb * e * dy_s + hc * dy_s * dy_s

        def edge_y(e):
            dx_s = torch.clamp(-hb * e / torch.clamp(2.0 * ha, min=1e-20), x0, x1)
            return ha * dx_s * dx_s + hb * dx_s * e + hc * e * e

        best = torch.minimum(
            torch.minimum(edge_x(x0), edge_x(x1)),
            torch.minimum(edge_y(y0), edge_y(y1)),
        )
        return torch.where(inside_r, torch.zeros_like(best), best)

    def reaches(tx, ty):
        bx0 = tx.to(torch.float32) * ts_x + 0.5 - px
        bx1 = bx0 + (ts_x - 1)
        by0 = ty.to(torch.float32) * ts_y + 0.5 - py
        by1 = by0 + (ts_y - 1)
        return rect_min_a(bx0, bx1, by0, by1) <= a_max

    return reaches


def decoded_reaches(words, *, width: int, height: int, config: RasterConfig):
    """make_reaches over records decoded from (w0..w3) int64 u32 words:
    the overflow stages' reach test, on exactly what the rasterizer sees."""
    cq = packing.CenterQuant.for_viewport(width, height)
    px, py, ha, hb, hc, op, _, _, _ = packing.unpack_record(*words, cq)
    a_max = alpha_bound(op, float(config.alpha_threshold))
    return make_reaches(px, py, ha, hb, hc, a_max, config.tile_w, config.tile_h)


def pack_rect4(tx0, ty0, tx1, ty1):
    """Clamped tile rect -> one u32 (8 bits per field, <=256 tiles/axis).
    The 0xFFFFFFFF sentinel decodes to a 1x1 rect and self-masks."""
    return (tx0 & 0xFF) | ((ty0 & 0xFF) << 8) | ((tx1 & 0xFF) << 16) | ((ty1 & 0xFF) << 24)


def unpack_rect4(rect):
    return rect & 0xFF, (rect >> 8) & 0xFF, (rect >> 16) & 0xFF, (rect >> 24) & 0xFF


def dense_grid_emit(mega_words, n_mega, *, width: int, height: int, config: RasterConfig):
    """Every rect tile of row-major rank >= overflow_window_slots for each
    of the first ``n_mega`` rows of a 6-word stream (preprocess.py:910).

    mega_words: (6, G2) int32 (rect4, w0..w3, depth_q); n_mega: 0-d
    integer tensor or int.  Returns the holey (n_tiles * G2,) int32 key
    stream (sentinel 0xFFFFFFFF) and its (4, n_tiles * G2) int32 words, in
    the JAX layout (tile-major)."""
    mw = u32(mega_words)
    rect, depth_q = mw[0], mw[5]
    words = tuple(mw[1 + i] for i in range(4))
    g2 = rect.shape[0]
    tx_tiles, ty_tiles = config.tiles_for(width, height)
    _, depth_bits = config.key_bits(width, height)
    w_slots = int(config.overflow_window_slots)

    tx0m, ty0m, tx1m, ty1m = unpack_rect4(rect)
    wtm = torch.clamp(tx1m - tx0m + 1, min=1)
    mreaches = decoded_reaches(words, width=width, height=height, config=config)
    mvalid = torch.arange(g2, device=rect.device) < n_mega

    n_tiles = tx_tiles * ty_tiles
    tid = torch.arange(n_tiles, device=rect.device)[:, None]
    ttx = tid % tx_tiles
    tty = tid // tx_tiles
    in_rect = (ttx >= tx0m) & (ttx <= tx1m) & (tty >= ty0m) & (tty <= ty1m)
    rank = (tty - ty0m) * wtm + (ttx - tx0m)
    ok = mvalid & in_rect & (rank >= w_slots) & mreaches(ttx, tty)
    keys = torch.where(
        ok, ((tty * tx_tiles + ttx) << depth_bits) | depth_q,
        torch.full_like(ok, packing.INVALID_KEY, dtype=torch.int64),
    ).reshape(-1)
    out_words = mega_words[1:5][:, None, :].expand(4, n_tiles, g2).reshape(4, -1)
    return packing.to_i32(keys), out_words
